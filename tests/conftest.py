"""Registers the marker of tests that need a CUDA device."""


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "cuda: needs a CUDA device (the port's kernels); skips "
      "where there is none")

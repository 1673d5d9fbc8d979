"""Build and load the port's CUDA kernels, and count their launches.

All sources in ``csrc/*.cu`` are compiled by ONE ``nvcc`` command into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds, not minutes) under ``<repo>/build/repro_torch/``, at the
first launch of any kernel; later launches reuse it while it is newer than
every source.  The library is loaded with ``ctypes``: pointers and the
stream travel as ``c_void_p``, and every C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import: the CPU test suite imports every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Head dims and largest GQA group the decode kernels are built for
# (DISPATCH_HEAD_DIM and GMAX in csrc/attn_common.cuh).
HEAD_DIMS = (16, 32, 64, 128, 256)
GMAX = 8

# C entry point -> argtypes (see each .cu file's extern "C" function).
SIGNATURES = {
    "fused_synopsis_launch": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _P],
    "block_gather_launch": [_P] * 13 + [_I] * 8 + [_F, _F, _I, _P],
    "segment_build_launch": [_P] * 8 + [_I] * 6 + [_P],
    "flash_prefill_launch": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _I, _P],
    "flash_decode_launch": [_P] * 10 + [_I] * 6 + [_F, _F, _I, _P],
    "synopsis_score_launch": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
}

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show it went through the kernels.
LAUNCHES: Dict[str, int] = {
    "flash_prefill": 0,
    "segment_build": 0,
    "fused_synopsis_score_attention": 0,
    "block_gather_attention": 0,
    "flash_decode": 0,
    "synopsis_score": 0,
}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
  return dict(LAUNCHES)


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
  if cand.is_file():
    return str(cand)
  raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                     "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False, verbose: bool = False) -> pathlib.Path:
  """Compile every ``csrc/*.cu`` into the shared library (one nvcc call)
  unless an up-to-date library exists.  Returns its path.  ``verbose``
  prints ptxas's register / shared-memory / spill report."""
  sources = sorted(CSRC.glob("*.cu"))
  headers = sorted(CSRC.glob("*.cuh"))
  lib = BUILD_DIR / LIB_NAME
  if (not force and lib.is_file()
      and lib.stat().st_mtime >= max(p.stat().st_mtime
                                     for p in sources + headers)):
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}"
  cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(tmp),
         *(["-Xptxas=-v"] if verbose else []), *map(str, sources)]
  res = subprocess.run(cmd, capture_output=True, text=True)
  if res.returncode != 0:
    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                       f"{res.stdout}\n{res.stderr}")
  if verbose:
    print(res.stdout + res.stderr, end="")
  os.replace(tmp, lib)
  return lib


def library() -> ctypes.CDLL:
  """The loaded kernel library (built on first use)."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(build()))
      for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      _lib = lib
  return _lib


def check(err: int, name: str) -> None:
  if err != 0:
    raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                       f"{err}")


def dtype_code(name: str, *tensors) -> int:
  """Check that the kernel's data tensors lie on one CUDA device, share
  one dtype (float32 or bfloat16) and are contiguous; returns the C
  dtype code (0 = float32, 1 = bfloat16)."""
  import torch  # noqa: PLC0415
  first = tensors[0]
  if first.device.type != "cuda":
    raise ValueError(f"{name}: expected CUDA tensors, got {first.device}")
  if first.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"{name}: dtype {first.dtype} not in (float32, "
                    "bfloat16)")
  for t in tensors:
    if t.device != first.device or t.dtype != first.dtype:
      raise ValueError(f"{name}: tensors differ in device/dtype "
                       f"({t.device}, {t.dtype} vs {first.device}, "
                       f"{first.dtype})")
    if not t.is_contiguous():
      raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not "
                       "contiguous")
  return 1 if first.dtype == torch.bfloat16 else 0


def check_rows(name: str, D: int, G: int, *tensors) -> None:
  """The decode kernels (flash_decode, synopsis_score) read a key row as
  whole 16-byte vectors and keep G heads of state in registers: they are
  built for D in HEAD_DIMS and G <= GMAX, from 16-byte aligned tensors."""
  if D not in HEAD_DIMS or not 1 <= G <= GMAX:
    raise ValueError(f"{name}: head dim {D} / group {G} not built (D in "
                     f"{HEAD_DIMS}, G <= {GMAX})")
  for t in tensors:
    if t.data_ptr() % 16:
      raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not "
                       "16-byte aligned")


def stream_ptr(t) -> int:
  import torch  # noqa: PLC0415
  return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
  """Device pointer of a tensor, or NULL for None."""
  return ctypes.c_void_p(None if t is None else t.data_ptr())

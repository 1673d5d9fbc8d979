"""The port's CF recommender and search engine (``repro_torch.serving.apps``)
and their examples against the JAX package.

Both sides build their synopsis from the JAX-drawn PCA start
(``jax.random.normal(PRNGKey(0))``, passed in as ``basis``), so the
synopses are equal (the index exactly).  ``predict`` agrees within 1e-5 of
max|ref| (f32 products in another order); ``search`` returns the same ids
at every budget, budget 0's inherited ties included; the examples print
the JAX examples' tables from the same seeds (the search example's query
noise passed in from ``jax.random.normal``, which torch cannot replay).
"""
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import apps as japps
from repro_torch.serving import apps

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.array(a))


def _basis(v):
  return _t(jax.random.normal(jax.random.PRNGKey(0), (v, 3), jnp.float32))


def _same_index(got, want):
  for name in ("member_idx", "counts", "row_cluster"):
    np.testing.assert_array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name)))
  np.testing.assert_allclose(got.centroids.numpy(),
                             np.asarray(want.centroids), rtol=1e-5,
                             atol=1e-5)


@pytest.fixture(scope="module")
def cf():
  # The recommender example's data at its test size, so that the JAX
  # package's compiled ops are shared with that test.
  r, m = japps.movielens_like(256, 100, density=0.15, seed=1)
  want = japps.CFRecommender(r, m, num_clusters=16)
  gr, gm = apps.movielens_like(256, 100, density=0.15, seed=1)
  np.testing.assert_array_equal(gr.numpy(), np.asarray(r))
  np.testing.assert_array_equal(gm.numpy(), np.asarray(m))
  got = apps.CFRecommender(gr, gm, num_clusters=16, basis=_basis(100))
  return r, m, want, got


@pytest.fixture(scope="module")
def se():
  docs = japps.webpages_like(1024, 256, seed=2)
  want = japps.SearchEngine(docs, num_clusters=32)
  gdocs = apps.webpages_like(1024, 256, seed=2)
  np.testing.assert_array_equal(gdocs.numpy(), np.asarray(docs))
  got = apps.SearchEngine(gdocs, num_clusters=32, basis=_basis(256))
  assert not torch.equal(got.docs, gdocs)    # the caller's copy unwritten
  return docs, want, got


def test_cf_synopsis_equals_jax(cf):
  _, _, want, got = cf
  _same_index(got.syn, want.syn)


@pytest.mark.parametrize("budget", [0, 1, 4, 16])
def test_cf_predict_equals_jax(cf, budget):
  """Within 1e-5 of max|ref| at every budget, 16 (all clusters) included:
  the reference's full budget adds the members on top of the centroids'
  terms, and so does the port."""
  r, m, want, got = cf
  for uid in (3, 7, 100):
    rated = np.where(np.asarray(m[uid]) > 0)[0][:5]
    qm = m[uid].at[jnp.asarray(rated)].set(0.0)
    q = r[uid] * qm
    items = np.arange(0, 100, 3)
    w = np.asarray(want.predict(q, qm, jnp.asarray(items), budget))
    g = got.predict(_t(q), _t(qm), _t(items), budget).numpy()
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    w_ex = np.asarray(want.predict_exact(q, qm, jnp.asarray(items)))
    g_ex = got.predict_exact(_t(q), _t(qm), _t(items)).numpy()
    np.testing.assert_allclose(g_ex, w_ex, rtol=0,
                               atol=1e-5 * np.abs(w_ex).max())
    np.testing.assert_allclose(
        got.correlations(_t(q), _t(qm)).numpy(),
        np.asarray(want.correlations(q, qm)), rtol=0, atol=1e-5)


def test_cf_full_budget_is_not_exact(cf):
  """The reference's quirk, mirrored: budget = every cluster still counts
  the centroids, so it differs from the exact prediction."""
  r, m, _, got = cf
  qm = _t(m[7])
  q = _t(r[7]) * qm
  items = torch.arange(100)
  full = got.predict(q, qm, items, 16)
  exact = got.predict_exact(q, qm, items)
  assert float((full - exact).abs().max()) > 1e-3


def test_search_synopsis_equals_jax(se):
  _, want, got = se
  _same_index(got.syn, want.syn)
  np.testing.assert_allclose(got.docs.numpy(), np.asarray(want.docs),
                             rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("budget", [0, 1, 2, 8, 32])
def test_search_ids_equal_jax(se, budget):
  """The same top-10 ids, in the same order; at budget 0 every page has
  its cluster's score, so the ids are the best cluster's lowest ones."""
  docs, want, got = se
  for i in range(6):
    qv = docs[i * 37] + 0.05 * jax.random.normal(jax.random.PRNGKey(i),
                                                 (256,))
    w = np.asarray(want.search(qv, budget))
    g = got.search(_t(qv), budget)
    np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got.search_exact(_t(qv)).numpy(),
                                  np.asarray(want.search_exact(qv)))
    assert got.accuracy(_t(qv), budget) == want.accuracy(qv, budget)
  if budget == 0:
    best = got.syn.row_cluster[g]
    assert bool((best == best[0]).all())
    assert g.tolist() == sorted(g.tolist())


def _load(path, name):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _table(text):
  """The lines of the printed tables (everything but the closing note)."""
  return [ln for ln in text.splitlines()
          if ln.strip() and "on cpu" not in ln and "AccuracyTrader" not in ln
          and "small budgets" not in ln and "operating point" not in ln
          and "~99%" not in ln]


def _jax_example(name, argv, capsys, monkeypatch):
  monkeypatch.setattr(sys, "argv", [name] + argv)
  _load(ROOT / "examples" / name, "jax_" + name[:-3]).main()
  return capsys.readouterr().out


def test_recommender_example_prints_the_jax_table(capsys, monkeypatch):
  argv = ["--users", "256", "--items", "100", "--clusters", "16",
          "--active-users", "5"]
  want = _jax_example("recommender.py", argv, capsys, monkeypatch)
  mod = _load(ROOT / "examples" / "torch_recommender.py", "torch_rec")
  rmse = mod.main(argv + ["--device", "cpu"], basis=_basis(100))
  got = capsys.readouterr().out
  assert _table(got) == _table(want)
  assert set(rmse) == {"exact", "partial_25", 0, 1, 2, 4, 8, 16}


def test_search_example_prints_the_jax_tables(capsys, monkeypatch):
  argv = ["--docs", "1024", "--vocab", "256", "--clusters", "32",
          "--queries", "5"]
  want = _jax_example("search_engine.py", argv, capsys, monkeypatch)
  mod = _load(ROOT / "examples" / "torch_search_engine.py", "torch_se")
  noise = lambda seed, vocab: _t(jax.random.normal(jax.random.PRNGKey(seed),
                                                   (vocab,)))
  _, acc = mod.main(argv + ["--device", "cpu"], basis=_basis(256),
                    noise=noise)
  got = capsys.readouterr().out
  assert _table(got) == _table(want)
  assert acc[1.0] == 1.0


def test_longcontext_example_runs_on_cpu(capsys):
  """The port's long-context example (random torch weights, so its own
  numbers): budget M reads every row and equals exact."""
  mod = _load(ROOT / "examples" / "torch_serve_longcontext.py", "torch_lc")
  out = mod.main(["--device", "cpu", "--seq", "128", "--batch", "1"])
  assert "TV-dist to exact" in capsys.readouterr().out
  tv, match = out[128 // 16]
  assert tv < 1e-5 and match == 1.0
  assert all(0.0 <= tv <= 1.0 for tv, _ in out.values())


def test_examples_refuse_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  mod = _load(ROOT / "examples" / "torch_recommender.py", "torch_rec2")
  with pytest.raises(RuntimeError, match="CUDA device"):
    mod.main(["--users", "64"])

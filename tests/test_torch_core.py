"""The port's generic-data Algorithm 1 (``repro_torch.core``) against the
JAX package: Morton codes and clusters, nearest-center assignment, the
synopsis' build / update / insert / rebuild signal, and the two-stage
processing engine in both modes.

PCA starts from the JAX-drawn basis (``jax.random.normal(PRNGKey(0))``,
passed in as numpy), since torch cannot replay JAX's RNG.  Integer outputs
(permutations, ``member_idx``, ``row_cluster``, counts, selections) must
be equal; floats agree within 1e-5 (f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cluster as jcl
from repro.core import engine as jeng
from repro.core import synopsis as jsyn
from repro_torch import core
from repro_torch.core import cluster as cl
from repro_torch.core import engine as eng
from repro_torch.core import synopsis as syn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.array(a))


def _basis(v, out_dim=3):
  return _t(jax.random.normal(jax.random.PRNGKey(0), (v, out_dim),
                              jnp.float32))


def _data(n=256, v=24, seed=0, density=0.5):
  """The reference tests' data: normal rows, a Bernoulli mask."""
  k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
  data = jax.random.normal(k1, (n, v))
  mask = (jax.random.uniform(k2, (n, v)) < density).astype(jnp.float32)
  return data, mask


def _same_synopsis(got: syn.Synopsis, want):
  for f in dataclasses.fields(got):
    g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
    assert tuple(g.shape) == w.shape, f.name
    if f.name in ("member_idx", "counts", "row_cluster"):
      assert g.dtype == torch.int32, f.name
      np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
    else:
      np.testing.assert_allclose(g.numpy(), w, err_msg=f.name, **TOL)


_jbuild = jax.jit(jsyn.build, static_argnames=(
    "num_clusters", "method", "pca_dim", "pca_iters", "slack"))


def _build_pair(n=256, v=24, m=16, method="kd", seed=0, **kw):
  data, mask = _data(n, v, seed)
  want = _jbuild(data, m, mask=mask, method=method, **kw)
  got = syn.build(_t(data), m, mask=_t(mask), method=method,
                  basis=_basis(v), **kw)
  return data, mask, got, want


# -- clustering ---------------------------------------------------------------

@pytest.mark.parametrize("j", [2, 3, 4, 5])
def test_morton_codes_equal_jax(j):
  """Every code equal, including j = 4 and 5, where the reference's int32
  codes cap ``bits`` at 30 // j."""
  coords = np.random.default_rng(j).standard_normal((300, j)).astype(
      np.float32)
  coords[:7] = coords[7]                       # ties in every dimension
  want = np.asarray(jcl.morton_codes(jnp.asarray(coords)))
  got = cl.morton_codes(_t(coords))
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), want)
  assert int(got.max()) < 2 ** 30


def test_morton_cluster_equals_jax_and_is_stable():
  coords = np.random.default_rng(1).standard_normal((512, 3)).astype(
      np.float32)
  coords = np.round(coords * 4) / 4            # many equal codes
  want = np.asarray(jcl.morton_cluster(jnp.asarray(coords), 8))
  got = cl.morton_cluster(_t(coords), 8)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(
      cl.cluster(_t(coords), 8, method="morton").numpy(), want)


def test_morton_batched_sets_scale_per_set():
  """A leading batch of point sets: each set quantised over its own
  min / max, as the reference's ``vmap`` does."""
  coords = np.random.default_rng(2).standard_normal((3, 128, 3)).astype(
      np.float32)
  coords[1] *= 100.0
  got = cl.morton_cluster(_t(coords), 4)
  for b in range(3):
    np.testing.assert_array_equal(
        got[b].numpy(), np.asarray(jcl.morton_cluster(jnp.asarray(coords[b]),
                                                      4)))


def test_cluster_refuses_unknown_method_and_kd_non_power_of_two():
  coords = torch.zeros((16, 3))
  with pytest.raises(ValueError, match="unknown cluster method"):
    cl.cluster(coords, 4, method="rtree")
  with pytest.raises(ValueError, match="power of two"):
    syn.build(torch.randn(64, 8), 6)


def test_assign_to_nearest_equals_jax():
  rng = np.random.default_rng(3)
  pts = rng.standard_normal((200, 3)).astype(np.float32)
  centers = rng.standard_normal((16, 3)).astype(np.float32)
  want = np.asarray(jcl.assign_to_nearest(jnp.asarray(pts),
                                          jnp.asarray(centers)))
  np.testing.assert_array_equal(
      cl.assign_to_nearest(_t(pts), _t(centers)).numpy(), want)
  # the reference test's case
  assert cl.assign_to_nearest(torch.tensor([[1.0, 1], [9, 9]]), torch.tensor(
      [[0.0, 0], [10, 10]])).tolist() == [0, 1]


def test_top_k_breaks_ties_to_the_lower_index():
  x = torch.tensor([1.0, 3.0, 3.0, -torch.inf, 3.0, -torch.inf])
  vals, idx = cl.top_k(x, 5)
  assert idx.tolist() == [1, 2, 4, 0, 3]
  want = jax.lax.top_k(jnp.asarray(x.numpy()), 5)[1]
  assert idx.tolist() == np.asarray(want).tolist()


# -- synopsis -----------------------------------------------------------------

@pytest.mark.parametrize("method,n,m", [("kd", 256, 16), ("kd", 250, 8),
                                        ("morton", 256, 16),
                                        ("morton", 250, 12)])
def test_build_equals_jax(method, n, m):
  """Every field: the index exactly, the aggregates within 1e-5; n % m
  leftovers go to the last clusters."""
  *_, got, want = _build_pair(n=n, m=m, method=method)
  _same_synopsis(got, want)
  assert got.num_clusters == m
  assert got.capacity == want.capacity


def test_build_invariants():
  """The reference tests' invariants, on the port alone: every row in
  exactly one cluster, row_cluster its inverse, balanced counts, and each
  centroid the masked mean of its members."""
  data, mask, s, _ = _build_pair()
  mi, rc = s.member_idx.numpy(), s.row_cluster.numpy()
  assert int(s.counts.sum()) == 256
  seen = set()
  for c in range(16):
    mem = mi[c][mi[c] >= 0]
    assert len(mem) == int(s.counts[c])
    assert not set(mem.tolist()) & seen
    seen |= set(mem.tolist())
    assert all(rc[r] == c for r in mem)
    d, k = np.asarray(data)[mem], np.asarray(mask)[mem]
    w = k.sum(0)
    np.testing.assert_allclose(
        s.centroids[c].numpy(),
        np.where(w > 0, (d * k).sum(0) / np.maximum(w, 1), 0), **TOL)
  assert seen == set(range(256))


def test_update_changed_equals_jax():
  data, mask, got, want = _build_pair()
  data2 = data.at[10].set(5.0).at[77].set(-3.0).at[78].set(2.0)
  rows = np.array([10, 77, 78], np.int32)
  w2 = jsyn.update_changed(want, data2, mask, jnp.asarray(rows))
  g2 = syn.update_changed(got, _t(data2), _t(mask), _t(rows))
  _same_synopsis(g2, w2)
  untouched = set(range(16)) - {int(got.row_cluster[r]) for r in rows}
  for c in untouched:
    assert torch.equal(g2.centroids[c], got.centroids[c])


@pytest.mark.parametrize("n_new", [4, 40])
def test_insert_equals_jax(n_new):
  """New rows into the slack (4), and enough that some clusters overflow
  (40 into 16 clusters of 8 free slots, drawn near one cluster): the
  dropped rows get row_cluster -1 and leave member_idx as it was."""
  data, mask, got, want = _build_pair(slack=0.5)
  rng = np.random.default_rng(9)
  new = rng.standard_normal((n_new, 24)).astype(np.float32)
  if n_new > 16:
    new = np.asarray(data)[:1] + 0.01 * new          # all near row 0
  data2 = np.concatenate([np.asarray(data), new])
  mask2 = np.concatenate([np.asarray(mask), np.ones_like(new)])
  want_g = dataclasses.replace(want, row_cluster=jnp.concatenate(
      [want.row_cluster, jnp.full((n_new,), -1, jnp.int32)]))
  got_g = dataclasses.replace(got, row_cluster=torch.cat(
      [got.row_cluster, torch.full((n_new,), -1, dtype=torch.int32)]))
  rows = np.arange(256, 256 + n_new, dtype=np.int32)
  w2 = jsyn.insert(want_g, jnp.asarray(data2), jnp.asarray(mask2),
                   jnp.asarray(rows))
  g2 = syn.insert(got_g, _t(data2), _t(mask2), _t(rows))
  _same_synopsis(g2, w2)
  dropped = int((g2.row_cluster[256:] < 0).sum())
  assert int(g2.counts.sum()) == 256 + n_new - dropped
  assert (dropped > 0) == (n_new > 16)
  for headroom in (0, 1, 4):
    assert bool(syn.needs_rebuild(g2, headroom)) == bool(
        jsyn.needs_rebuild(w2, headroom))


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 8), st.integers(0, 4))
def test_property_counts_preserved(log_m, seed):
  """``tests/test_core.py``'s property, on the port."""
  m = min(2 ** log_m, 16)
  data, mask = _data(n=128, v=12, seed=seed)
  s = syn.build(_t(data), m, mask=_t(mask), basis=_basis(12))
  counts = s.counts.numpy()
  assert counts.sum() == 128
  assert counts.max() - counts.min() <= 1


# -- engine -------------------------------------------------------------------

def _jscore(q, cents, w):
  return jnp.zeros((2,)), -jnp.sum((cents - q[None]) ** 2, axis=1)


def _jrefine(carry, rows, msk):
  return carry + jnp.array([jnp.sum(rows * msk), jnp.sum(msk)])


def _score(q, cents, w):
  return torch.zeros((2,)), -((cents - q[None]) ** 2).sum(1)


def _refine(carry, rows, msk):
  return carry + torch.stack([(rows * msk).sum(), msk.sum()])


@pytest.mark.parametrize("mode", ["iterative", "vectorized"])
@pytest.mark.parametrize("i_max", [0, 1, 3, 8])
def test_approximate_process_equals_jax(mode, i_max):
  data, mask, got, want = _build_pair(n=128, v=12, m=8)
  q = data[5]
  w = jeng.approximate_process(q, want, data, mask, score_fn=_jscore,
                               refine_fn=_jrefine, i_max=i_max, mode=mode)
  g = eng.approximate_process(_t(q), got, _t(data), _t(mask),
                              score_fn=_score, refine_fn=_refine,
                              i_max=i_max, mode=mode)
  assert isinstance(g, eng.ProcessResult)
  assert g.selected.dtype == torch.int32
  np.testing.assert_array_equal(g.selected.numpy(), np.asarray(w.selected))
  for name in ("result", "scores", "initial"):
    np.testing.assert_allclose(getattr(g, name).numpy(),
                               np.asarray(getattr(w, name)), rtol=1e-5,
                               atol=1e-4, err_msg=name)


def test_full_budget_equals_exact_and_modes_agree():
  data, mask, got, _ = _build_pair(n=128, v=12, m=8)
  q, D, M = _t(data[5]), _t(data), _t(mask)
  full = eng.approximate_process(q, got, D, M, score_fn=_score,
                                 refine_fn=_refine, i_max=8)
  exact = eng.exact_process(q, D, M, init=torch.zeros((2,)),
                            refine_fn=_refine)
  want = jeng.exact_process(data[5], data, mask, init=jnp.zeros((2,)),
                            refine_fn=_jrefine)
  np.testing.assert_allclose(exact.numpy(), np.asarray(want), **TOL)
  np.testing.assert_allclose(full.result.numpy(), exact.numpy(), rtol=1e-4)
  with pytest.raises(ValueError, match="unknown mode"):
    eng.approximate_process(q, got, D, M, score_fn=_score,
                            refine_fn=_refine, i_max=2, mode="batched")


def test_deadline_aliases():
  """``core.deadline`` names the control plane's controller and affine
  model, as the reference's does."""
  c = core.BudgetController(core.LatencyModel(base=2.0, slope=1.0),
                            buckets=(0, 1, 2, 4, 8, 16, 32))
  assert c.budget_for(40.0, 0.0) >= c.budget_for(40.0, 30.0)
  assert c.budget_for(40.0, 100.0) == 0
  assert core.deadline.LatencyModel is core.LatencyModel

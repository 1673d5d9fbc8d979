"""The port's clustering and synopsis build/update against the JAX package.

PCA starts from the JAX-drawn basis (``jax.random.normal(PRNGKey(0))``,
passed in as numpy), since torch cannot replay JAX's RNG.  Coordinates are
f32 products in another order: 1e-4 relative.  Given the same
coordinates the permutation is equal; given the same permutation the
sorted cache, the centroids and the counts agree within 2e-5 (the
build's f32 mean), and the ring update is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core import cluster as jcl
from repro.serve import synopsis_kv as jskv
from repro_torch.configs.registry import get_config
from repro_torch.core import cluster as cl
from repro_torch.serve import synopsis_kv as skv

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _jax_basis(v, out_dim=3):
  return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (v, out_dim),
                                      jnp.float32))


def _cfgs():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  return jcfg, cfg


def _exact_cache(seed=0, S=128):
  """A prefilled cache (nb=2, na=1, B=2, Hkv=2, S, D=16) with clustered
  keys (four well-separated groups), so that splits are not near ties."""
  rng = np.random.default_rng(seed)
  shape = (2, 1, 2, 2, S, 16)
  centers = rng.standard_normal((4, 16)).astype(np.float32) * 4.0
  k = (centers[rng.integers(0, 4, shape[:-1])]
       + rng.standard_normal(shape).astype(np.float32))
  v = rng.standard_normal(shape).astype(np.float32)
  return {"k": k, "v": v, "pos": np.full((2,), S, np.int32)}


def test_pca_project_matches_jax_given_basis():
  rng = np.random.default_rng(1)
  data = rng.standard_normal((96, 32)).astype(np.float32)
  data[:, :3] *= 5.0                       # a clear top-3 subspace
  basis = _jax_basis(32)
  want_c, want_q = jcl.pca_project(jnp.asarray(data), out_dim=3,
                                   num_iters=4)
  got_c, got_q = cl.pca_project(_t(data), out_dim=3, num_iters=4,
                                basis=_t(basis))
  _close(got_c, want_c, dict(rtol=1e-4, atol=1e-4))
  _close(got_q, want_q, dict(rtol=1e-4, atol=1e-4))
  # Batched (what build runs) == one set at a time.
  stack = np.stack([data, data[::-1].copy()])
  got_b, _ = cl.pca_project(_t(stack), out_dim=3, num_iters=4,
                            basis=_t(basis))
  _close(got_b[0], got_c)


@pytest.mark.parametrize("num_clusters", [1, 2, 8, 16])
def test_balanced_kd_cluster_equals_jax_given_coords(num_clusters):
  rng = np.random.default_rng(2)
  coords = rng.standard_normal((3, 128, 3)).astype(np.float32)
  got = cl.balanced_kd_cluster(_t(coords), num_clusters)
  for i in range(3):
    want = jcl.balanced_kd_cluster(jnp.asarray(coords[i]), num_clusters)
    np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
  with pytest.raises(ValueError):
    cl.balanced_kd_cluster(_t(coords), 6)


def test_build_matches_jax():
  jcfg, cfg = _cfgs()
  cache = _exact_cache()
  want = jskv.build({k: jnp.asarray(v) for k, v in cache.items()}, jcfg,
                    impl="xla")
  basis = _jax_basis(2 * 16)
  # Same permutation from the same features ...
  N = 4
  k = _t(cache["k"]).reshape(N, 2, 128, 16)
  perms = skv.cluster_perms(k, 8, basis=_t(basis))
  feats = jnp.moveaxis(jnp.asarray(cache["k"]), 3, 4).reshape(N, 128, 32)
  want_perms = jax.vmap(lambda f: jskv._cluster_perm(f, 8))(feats)
  np.testing.assert_array_equal(perms.numpy(), np.asarray(want_perms))
  # ... hence the same synopsis cache.
  got = skv.build({k: _t(v) for k, v in cache.items()}, cfg,
                  basis=_t(basis))
  assert set(got) == set(want)
  for name in want:
    assert tuple(got[name].shape) == want[name].shape, name
    _close(got[name], want[name])


def test_morton_build_and_extend_match_jax():
  """``method="morton"``: the same Morton permutations from the same
  features, hence the same synopsis cache; and the same for the delta
  build of an extension appended to it."""
  jcfg, cfg = _cfgs()
  cache = _exact_cache(seed=5)
  basis = _t(_jax_basis(2 * 16))
  N = 4
  k = _t(cache["k"]).reshape(N, 2, 128, 16)
  feats = jnp.moveaxis(jnp.asarray(cache["k"]), 3, 4).reshape(N, 128, 32)
  want_perms = jax.vmap(lambda f: jskv._cluster_perm(f, 8, "morton"))(feats)
  np.testing.assert_array_equal(
      skv.cluster_perms(k, 8, basis=basis, method="morton").numpy(),
      np.asarray(want_perms))
  want = jskv.build({n: jnp.asarray(v) for n, v in cache.items()}, jcfg,
                    method="morton", impl="xla")
  got = skv.build({n: _t(v) for n, v in cache.items()}, cfg, basis=basis,
                  method="morton")
  assert set(got) == set(want)
  for name in want:
    _close(got[name], want[name])
  ext = _exact_cache(seed=6, S=64)
  want_e = jskv.extend_synopsis(want, jnp.asarray(ext["k"]),
                                jnp.asarray(ext["v"]), jcfg, method="morton",
                                impl="xla")
  got_e = skv.extend_synopsis(got, _t(ext["k"]), _t(ext["v"]), cfg,
                              basis=basis, method="morton")
  assert set(got_e) == set(want_e)
  for name in want_e:
    assert tuple(got_e[name].shape) == want_e[name].shape, name
    _close(got_e[name], want_e[name])


def test_append_and_absorb_match_jax():
  jcfg, cfg = _cfgs()
  cache = _exact_cache(seed=3)
  jc = jskv.build({k: jnp.asarray(v) for k, v in cache.items()}, jcfg,
                  impl="xla")
  tc = {k: _t(np.asarray(v)) for k, v in jc.items()}
  rng = np.random.default_rng(4)
  R = cfg.synopsis.recent
  for _ in range(R):
    kd = rng.standard_normal((2, 1, 2, 2, 1, 16)).astype(np.float32)
    vd = rng.standard_normal((2, 1, 2, 2, 1, 16)).astype(np.float32)
    jc = jskv.append_recent(jc, jnp.asarray(kd), jnp.asarray(vd))
    tc = skv.append_recent(tc, _t(kd), _t(vd))
  for name in ("recent_k", "recent_v", "recent_len"):
    np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
  with pytest.raises(ValueError, match="full"):
    skv.append_recent(tc, _t(kd), _t(vd))
  jc = jskv.absorb_recent(jc, jcfg, impl="xla")
  tc = skv.absorb_recent(tc, cfg)
  assert tc["k_syn"].shape[4] == 128 // 16 + R // 16
  assert set(tc) == set(jc)
  for name in jc:
    assert tuple(tc[name].shape) == jc[name].shape, name
    _close(tc[name], jc[name])

"""The port's model and prefill step against the JAX package at the
llama3-8b SMOKE size in f32, with the JAX weights bridged over
(``repro_torch.bridge.params_from_numpy``).

Tolerances: the layer functions take the same f32 arithmetic in another
order, within 2e-5.  The prefill step pushes 128 tokens through two layers
of f32 products summed in another order (and the JAX prefill's chunked
reference attention against the port's plain version): 1e-4 on logits of
magnitude ~1 and on the cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro_torch import bridge, resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models import layers
from repro_torch.models.common import leaves
from repro_torch.models import transformer as tf
from repro_torch.serve.prefill import make_prefill_step

B, S = 2, 128
TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def llama():
  """(JAX cfg, JAX params, port cfg, port params, prompt) in f32."""
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32)


def test_config_is_llama3_8b():
  full = get_config("llama3-8b")
  jfull = j_get_config("llama3-8b")
  for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab", "hd", "rope_theta", "norm_eps"):
    assert getattr(full, name) == getattr(jfull, name), name
  assert full.synopsis.cluster_size == 128 and full.synopsis.i_max == 32
  assert full.synopsis.recent == 128 and full.dtype == torch.bfloat16
  smoke, jsmoke = get_config("llama3-8b", smoke=True), j_get_config(
      "llama3-8b", smoke=True)
  assert dataclasses.asdict(smoke.synopsis) == {
      k: v for k, v in dataclasses.asdict(jsmoke.synopsis).items()
      if k in ("cluster_size", "i_max", "recent", "quant")}
  with pytest.raises(KeyError):
    get_config("no-such-arch")


def test_layers_match_jax():
  rng = np.random.default_rng(1)
  x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
  w = rng.standard_normal(16).astype(np.float32) * 0.1
  _close(layers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w))
  pos = np.arange(5, dtype=np.int32) + 7
  _close(layers.rope(_t(x), _t(pos), 500000.0),
         jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
  h = rng.standard_normal((2, 5, 16)).astype(np.float32)
  w1, w3 = (rng.standard_normal((16, 24)).astype(np.float32)
            for _ in range(2))
  w2 = rng.standard_normal((24, 16)).astype(np.float32)
  _close(layers.swiglu(_t(h), _t(w1), _t(w3), _t(w2)),
         jlayers.swiglu(h, w1, w3, w2), dict(rtol=1e-5, atol=1e-5))
  _close(layers.softcap(_t(x), 2.0), jlayers.softcap(x, 2.0))


def test_init_model_matches_jax_tree_and_scales(llama):
  jcfg, jparams, cfg, _, _ = llama
  params = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
  for path, leaf in flat_j:
    node = params
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
    std_j = float(np.std(np.asarray(leaf)))
    if std_j == 0.0:                       # norm gains start at zero
      assert not node.any(), path
    else:                                  # same truncated-normal scale
      assert abs(float(node.std()) / std_j - 1.0) < 0.05, path
  assert cfg.param_count() == sum(leaf.size for _, leaf in flat_j)
  # The logits read the unembedding in f32: a bf16 model keeps only the
  # f32 cast of its bf16 draw, no second copy.
  bf16 = tf.init_model(dataclasses.replace(cfg, dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0), "cpu")
  un = bf16["unembed"]
  assert un.dtype == torch.float32 and "unembed_f32" not in bf16
  assert torch.equal(un, un.to(torch.bfloat16).float())
  assert bf16["blocks"]["pos0"]["attn"]["wq"].dtype == torch.bfloat16


def test_init_draws_large_weights_in_slices(llama, monkeypatch):
  """A weight over ``DRAW_ELEMS`` elements (at full width arctic-480b's
  experts, command-r-plus's tied embedding) is drawn in slices of its
  first axis: other numbers than one whole draw, the same shapes, dtypes
  and truncated-normal scales."""
  cfg = llama[2]
  whole = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  monkeypatch.setattr(tf, "DRAW_ELEMS", 4096)
  sliced = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  pairs = list(zip(leaves(whole), leaves(sliced)))
  assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
  for (path, a), (_, b) in pairs:
    assert a.shape == b.shape and a.dtype == b.dtype, path
    if not a.any():
      assert not b.any(), path
      continue
    assert abs(float(b.std()) / float(a.std()) - 1.0) < 0.05, path
    assert float(b.abs().max()) <= 1.01 * float(a.abs().max()), path
  assert not torch.equal(whole["embed"], sliced["embed"])     # (512, 128)


def test_prefill_matches_jax(llama):
  jcfg, jparams, cfg, params, prompt = llama
  lg_j, cache_j = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  assert lg.dtype == torch.float32 and tuple(lg.shape) == (B, cfg.vocab)
  _close(lg, lg_j, STEP_TOL)
  for name in ("k", "v"):
    assert tuple(cache[name].shape) == cache_j[name].shape
    _close(cache[name], cache_j[name], STEP_TOL)
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))


def test_resolve_device_refuses_missing_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    resolve_device()
  with pytest.raises(RuntimeError):
    resolve_device("cuda")
  assert resolve_device("cpu").type == "cpu"

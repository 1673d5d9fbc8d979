"""pixtral-12b's vision stub in the port against the JAX package, on the
CPU (f32 SMOKE config: 2 layers, d 128, 4/2 heads of 32, 8 patches of 32;
the JAX weights bridged over).  The tests it shares with smollm-135m
(config, prefill, steps, loop, engine, delta replay off) are in
``tests/test_torch_smollm.py``, parametrised over the arch.

Tolerance: 4e-5 of max|reference|, for the reason that file's doc gives.

* ``frontend_proj``: the init's shape and scale, the bridge requires it.
* The patch prefix: ``embed_tokens`` with ``frontend_embeds``.
* The prefix prefill: 8 patch embeddings and 56 tokens (64 positions, a
  multiple of C = 16): last-token logits, ``k`` / ``v`` and ``pos``
  against the JAX ``make_prefill_step`` with ``frontend_embeds``; then the
  build of that cache and one serve step on it at budget 1.
* ``check_supported`` refuses another frontend; ``frontend_embeds`` given
  to a config without the stub is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.serve import prefill as jpf
from repro.serve import synopsis_kv as jskv
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

from test_torch_smollm import REL, load

ARCH = "pixtral-12b"
P_PATCH, T_TEXT = 8, 56


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pix():
  """load()'s tuple, plus patch embeddings (B, 8, 32) f32 from a seed."""
  jcfg, jparams, cfg, params, prompt, basis = load(ARCH)
  patches = np.random.default_rng(4).standard_normal(
      (prompt.shape[0], P_PATCH, cfg.frontend_dim)).astype(np.float32)
  return jcfg, jparams, cfg, params, prompt[:, :T_TEXT], basis, patches


def _close(got, want, rel=REL):
  got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def test_frontend_proj_init_and_bridge(pix):
  _, jparams, cfg, params, _, _, _ = pix
  assert cfg.frontend_tokens == P_PATCH
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  proj = mine["frontend_proj"]
  assert tuple(proj.shape) == jparams["frontend_proj"].shape == (
      cfg.frontend_dim, cfg.d_model)
  # Truncated normal (+-2 sigma) times frontend_dim^-0.5, as the JAX init.
  scale = cfg.frontend_dim ** -0.5
  assert float(proj.abs().max()) <= 2 * scale
  assert abs(float(proj.std()) / scale - 0.88) < 0.05
  assert torch.equal(params["frontend_proj"],
                     torch.from_numpy(np.asarray(jparams["frontend_proj"])))
  tree = jax.tree.map(np.asarray, jparams)
  del tree["frontend_proj"]
  with pytest.raises(KeyError, match="frontend_proj"):
    bridge.params_from_numpy(tree, cfg, "cpu")


def test_embed_prefix_matches_jax(pix):
  jcfg, jparams, cfg, params, prompt, _, patches = pix
  want = jtf.embed_tokens(jparams, jcfg, jnp.asarray(prompt),
                          jnp.asarray(patches))
  got = tf.embed_tokens(params, cfg, torch.from_numpy(prompt).long(),
                        torch.from_numpy(patches))
  assert got.shape == (prompt.shape[0], P_PATCH + T_TEXT, cfg.d_model)
  _close(got, want)
  # The text rows are the embeddings alone.
  assert torch.equal(got[:, P_PATCH:], tf.embed_tokens(
      params, cfg, torch.from_numpy(prompt).long()))


def test_prefix_prefill_matches_jax(pix):
  """8 patches + 56 tokens: logits, the cache of all 64 positions (rope
  over prefix and text together) and pos = 64; then the build of that
  cache and one step at budget 1 on it."""
  jcfg, jparams, cfg, params, prompt, basis, patches = pix
  lg_j, cache_j = jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt), jnp.asarray(patches))
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long(),
                                     torch.from_numpy(patches))
  _close(lg, lg_j)
  for name in ("k", "v"):
    assert cache[name].shape[4] == P_PATCH + T_TEXT
    _close(cache[name], cache_j[name])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))
  assert int(cache["pos"][0]) == P_PATCH + T_TEXT
  jc = jskv.build(cache_j, jcfg, impl="xla")
  syn = skv.build({k: torch.from_numpy(np.array(v))
                   for k, v in cache_j.items()}, cfg,
                  basis=torch.from_numpy(basis))
  _close(syn["k_syn"], jc["k_syn"])
  tok = np.array([[5], [77]], np.int32)
  want, _ = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=1,
                                       impl="xla"))(
      jparams, jc, jnp.asarray(tok))
  got, _ = make_serve_step(cfg, mode="synopsis", i_max=1)(
      params, syn, torch.from_numpy(tok).long())
  _close(got, want)


def test_frontends_the_port_refuses(pix):
  _, _, cfg, params, prompt, _, patches = pix
  with pytest.raises(NotImplementedError, match="frontend"):
    tf.check_supported(dataclasses.replace(cfg, frontend="audio_stub"))
  llama = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              dtype=torch.float32)
  lp = tf.init_model(llama, torch.Generator().manual_seed(0), "cpu")
  with pytest.raises(ValueError, match="vision stub"):
    tf.embed_tokens(lp, llama, torch.from_numpy(prompt).long(),
                    torch.from_numpy(patches))

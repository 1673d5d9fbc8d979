"""The port's quantized serving path against the JAX package, on the CPU
(f32 SMOKE llama3-8b, the four quant specs).

* Build and absorb: the arena's leaves and dtypes equal JAX's; under
  ``+kv`` the absorbed ring rows are the build's codes, not the raw ring.
* One synopsis step on the same quantized arena (carried across by
  ``bridge.arena_from_numpy``): logits and KV deltas within 1e-4, as for
  the unquantized step.
* The loop (18 tokens with one absorb, budgets ``[2, 1, 0] * 6``)
  generates the JAX loop's token ids at ``impl="xla"``.
* The launcher takes ``--quant`` in synopsis mode and refuses it in exact
  mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import synopsis_kv as jskv
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import quant as qt
from repro_torch.launch import serve as launch
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.serve_step import make_serve_step

B, S = 2, 128
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
SPECS = ("int8", "fp8", "int8+kv", "fp8+kv")
BUDGETS = [2, 1, 0] * 6


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llama():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32))
  _, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt, jnp.int32))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32), basis, cache


def _quant(jcfg, cfg, spec):
  return (dataclasses.replace(jcfg, synopsis=dataclasses.replace(
      jcfg.synopsis, quant=spec)), launch.apply_quant(cfg, spec))


def _close(got, want, tol=STEP_TOL):
  np.testing.assert_allclose(np.asarray(got.float() if isinstance(
      got, torch.Tensor) else got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _same_leaf(name, got, want):
  want = np.asarray(want)
  assert tuple(got.shape) == want.shape, name
  if got.dtype in qt.QDTYPES:
    assert str(got.dtype).endswith(want.dtype.name), (name, got.dtype)
    codes = got.view(torch.uint8).numpy() if got.dtype != torch.int8 \
        else got.numpy()
    np.testing.assert_array_equal(codes, want.view(codes.dtype), name)
  else:
    _close(got, want, dict(rtol=2e-5, atol=2e-5))


@pytest.mark.parametrize("spec", SPECS)
def test_quant_build_and_absorb_match_jax(llama, spec):
  jcfg, _, cfg, _, _, basis, cache = llama
  jcfg, cfg = _quant(jcfg, cfg, spec)
  jc = jskv.build(cache, jcfg, impl="xla")
  tc = skv.build(bridge.arena_from_numpy(cache, "cpu"), cfg,
                 basis=torch.from_numpy(basis))
  assert set(tc) == set(jc)
  for name in jc:
    _same_leaf(name, tc[name], jc[name])
  rng = np.random.default_rng(4)
  shape = cache["k"].shape[:4] + (1, cache["k"].shape[-1])
  for _ in range(cfg.synopsis.recent):
    kd = rng.standard_normal(shape).astype(np.float32)
    vd = rng.standard_normal(shape).astype(np.float32)
    jc = jskv.append_recent(jc, jnp.asarray(kd), jnp.asarray(vd))
    tc = skv.append_recent(tc, torch.from_numpy(kd), torch.from_numpy(vd))
  ring = tc["recent_k"].clone()
  jc = jskv.absorb_recent(jc, jcfg, impl="xla")
  tc = skv.absorb_recent(tc, cfg)
  assert set(tc) == set(jc)
  for name in jc:
    _same_leaf(name, tc[name], jc[name])
  M = S // cfg.synopsis.cluster_size
  assert tc["k_syn_scale"].shape[-1] == M + 1
  appended = tc["k"][..., S:, :]
  if qt.parse_qconfig(spec).sorted_kv:
    assert appended.dtype == qt.qdtype(qt.parse_qconfig(spec).kind)
    scales = tc["k_scale"][..., M:]
    _close(qt.dequantize_rows(appended, scales, block=16), ring,
           dict(rtol=0.07, atol=0.07 * float(ring.abs().max())))
  else:
    assert torch.equal(appended, ring)


@pytest.mark.parametrize("spec", SPECS)
def test_quant_serve_step_matches_jax(llama, spec):
  jcfg, jparams, cfg, params, _, _, cache = llama
  jcfg, cfg = _quant(jcfg, cfg, spec)
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3          # a partly filled ring
  tc = bridge.arena_from_numpy(jc, "cpu")
  for name in qt.SCALE_LEAVES:
    assert (name in tc) == (name in jc)
  tok = np.array([[5], [77]], np.int32)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=2,
                                         impl="xla"))(jparams, jc,
                                                      jnp.asarray(tok))
  lg, st = make_serve_step(cfg, i_max=2)(params, tc,
                                         torch.from_numpy(tok).long())
  _close(lg, lg_j)
  for name in ("k_delta", "v_delta"):
    _close(st[name], st_j[name])


def _jax_loop(jcfg, jparams, prompt, budgets):
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  cache = jskv.build(cache, jcfg, impl="xla")
  steps = {}
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  out = [tok]
  for b in budgets:
    if b not in steps:
      steps[b] = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=b,
                                           impl="xla"))
    logits, st = steps[b](jparams, cache, tok)
    cache = jskv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if int(cache["recent_len"][0]) >= jcfg.synopsis.recent:
      cache = jskv.absorb_recent(cache, jcfg, impl="xla")
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out.append(tok)
  return np.asarray(jnp.concatenate(out, 1)), cache


@pytest.mark.parametrize("spec", SPECS)
def test_quant_loop_generates_jax_token_ids(llama, spec):
  jcfg, jparams, cfg, params, prompt, basis, _ = llama
  jcfg, cfg = _quant(jcfg, cfg, spec)
  want_ids, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=len(BUDGETS),
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(), budgets=BUDGETS,
                   pca_basis=torch.from_numpy(basis), log=lambda _: None)
  assert out["absorbs"] == 1
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for name in ("k", "k_syn", *(n for n in qt.SCALE_LEAVES if n in jcache)):
    assert tuple(out["cache"][name].shape) == jcache[name].shape, name
    assert out["cache"][name].dtype.itemsize == jcache[name].dtype.itemsize


def test_launcher_takes_quant_in_synopsis_mode_only(capsys):
  out = launch.main(["--device", "cpu", "--prompt-len", "64", "--tokens",
                     "18", "--batch", "1", "--quant", "int8+kv",
                     "--budget", "1"])
  assert out["absorbs"] == 1
  assert out["cache"]["k"].dtype == torch.int8
  assert "quant=int8+kv" in capsys.readouterr().out
  with pytest.raises(SystemExit) as e:
    launch.main(["--device", "cpu", "--mode", "exact", "--quant", "int8"])
  assert e.value.code != 0
  cfg = launch.apply_quant(get_config("llama3-8b", smoke=True), "fp8")
  assert cfg.synopsis.quant == "fp8"
  assert launch.apply_quant(cfg, "none") is cfg
  with pytest.raises(ValueError, match="exact"):
    launch.run(cfg, batch=1, prompt_len=64, tokens=1, device="cpu",
               mode="exact")

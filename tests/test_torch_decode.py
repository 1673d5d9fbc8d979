"""The port's exact decode path and unfused synopsis op against the JAX
package.

On the CPU every kernel wrapper runs its plain PyTorch version; here each
is held against the Pallas kernel run by the Pallas interpreter on the same
numpy inputs, f32 on both sides, within 2e-5 (sums taken in another order:
the bound the JAX suite holds its own kernels to):

* ``flash_decode`` over the (B, Hkv, G, D, S) sweep of ``test_kernels.py``
  with bias None / random and cap None / 30, and at a ragged S (1, 1500);
* ``synopsis_score`` at M in {4, 16, 65, 1024};
* stage 2 with neither epilogue (the unfused op's ``block_gather``), with
  a ``-1`` padded entry;
* the unfused and fused synopsis ops, scores and selection included, and
  the unfused op at i_max = M against exact attention (1e-4, as
  ``test_kernels.py`` holds the JAX op).

End to end (SMOKE llama3-8b, f32, same weights): one exact serve step
within 1e-4 of ``make_serve_step(mode="exact", impl="interpret")`` (two
layers of f32 sums in another order), and the exact loop's 18 token ids
equal to those of the JAX exact loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_gather_attention import (
    block_gather_attention as j_block_gather)
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.synopsis_score import synopsis_score as j_synopsis_score
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.synopsis_score import synopsis_score
from repro_torch.launch import serve as launch
from repro_torch.serve.serve_step import make_serve_step

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# (B, Hkv, G, D, S, C): the sweep of tests/test_kernels.py
SHAPES = [
    (1, 1, 1, 128, 512, 64),
    (2, 4, 2, 128, 2048, 128),
    (2, 2, 8, 64, 1024, 128),
    (4, 8, 4, 128, 1024, 64),
]
B, S = 2, 128
N_TOKENS = 18


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  """Full-f32 products; one CPU thread (the suite runs several workers
  side by side)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _normal(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


def _decode_inputs(shape, seed=0):
  B_, Hkv, G, D, S_, C = shape
  M = S_ // C
  rng = np.random.default_rng(seed)
  q = _normal(rng, B_, Hkv * G, D)
  k, v = _normal(rng, B_, Hkv, S_, D), _normal(rng, B_, Hkv, S_, D)
  k_syn = k.reshape(B_, Hkv, M, C, D).mean(3)
  v_syn = v.reshape(B_, Hkv, M, C, D).mean(3)
  counts = np.full((B_, M), float(C), np.float32)
  bias = _normal(rng, B_, Hkv, S_)
  return q, k, v, k_syn, v_syn, counts, bias


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_flash_decode_matches_pallas(shape, with_bias, cap):
  q, k, v, _, _, _, bias = _decode_inputs(shape)
  bias = bias if with_bias else None
  sm = shape[3] ** -0.5
  want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if bias is None else jnp.asarray(bias),
                        sm_scale=sm, cap=cap, interpret=True)
  got = flash_decode(_t(q), _t(k), _t(v),
                     None if bias is None else _t(bias), sm_scale=sm,
                     cap=cap)
  for g, w in zip(got, want):
    _close(g, w)


@pytest.mark.parametrize("S_", [1, 1500])
def test_flash_decode_ragged_s(S_):
  """S = 1 (the self token) and S = 1500, which no power-of-two tile
  divides (the JAX op searches a divisor; the port's kernel masks)."""
  rng = np.random.default_rng(1)
  q = _normal(rng, 2, 8, 64)
  k, v = _normal(rng, 2, 2, S_, 64), _normal(rng, 2, 2, S_, 64)
  bias = _normal(rng, 2, 2, S_)
  want = jops._decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(bias), 0.125, "interpret")
  got = flash_decode(_t(q), _t(k), _t(v), _t(bias), sm_scale=0.125)
  for g, w in zip(got, want):
    _close(g, w)


def test_flash_decode_all_masked_keys():
  """Every key carries the -1e30 bias (the unfused stage 1 at i_max = M):
  exp(0) = 1 per key, m = -1e30, as the Pallas kernel gives."""
  q, k, v, _, _, _, _ = _decode_inputs((2, 2, 4, 32, 64, 16))
  bias = np.full((2, 2, 64), -1e30, np.float32)
  want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), sm_scale=32 ** -0.5,
                        interpret=True)
  got = flash_decode(_t(q), _t(k), _t(v), _t(bias), sm_scale=32 ** -0.5)
  for g, w in zip(got, want):
    _close(g, w)
  np.testing.assert_array_equal(got[2].numpy(), 64.0)


# ---------------------------------------------------------------------------
# synopsis_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 16, 65, 1024])
def test_synopsis_score_matches_pallas(M):
  rng = np.random.default_rng(2)
  q = _normal(rng, 2, 8, 32)
  k_syn = _normal(rng, 2, 2, M, 32)
  want = j_synopsis_score(jnp.asarray(q), jnp.asarray(k_syn),
                          sm_scale=32 ** -0.5, block_m=M, interpret=True)
  got = synopsis_score(_t(q), _t(k_syn), sm_scale=32 ** -0.5)
  assert tuple(got.shape) == (2, 2, M)
  _close(got, want)


# ---------------------------------------------------------------------------
# block_gather_attention without epilogues (the unfused op's stage 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_block_gather_without_epilogues_matches_pallas(shape):
  B_, Hkv, _, D, S_, C = shape
  q, k, v, *_ = _decode_inputs(shape)
  M = S_ // C
  rng = np.random.default_rng(6)
  sel = np.stack([[rng.permutation(M)[:min(5, M)] for _ in range(Hkv)]
                  for _ in range(B_)]).astype(np.int32)
  sel[:, :, -1] = -1                            # padded entry
  sm = D ** -0.5
  want = j_block_gather(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(sel), cluster_size=C, sm_scale=sm,
                        interpret=True)
  want_ref = jref.block_gather_attention_ref(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sel),
      cluster_size=C, sm_scale=sm)
  got = block_gather_attention(_t(q), _t(k), _t(v), _t(sel),
                               cluster_size=C, sm_scale=sm)
  for g, w, r in zip(got, want, want_ref):
    _close(g, w)
    _close(g, r)


# ---------------------------------------------------------------------------
# The unfused and fused synopsis ops
# ---------------------------------------------------------------------------

OP_SHAPE = (2, 2, 4, 32, 256, 16)               # M = 16


@pytest.mark.parametrize("i_max", [1, 4, 16])
def test_unfused_synopsis_attention_matches_jax(i_max):
  q, k, v, k_syn, v_syn, counts, _ = _decode_inputs(OP_SHAPE)
  counts[:, ::3] = 7.0                          # uneven cluster weights
  args = (q, k, v, k_syn, v_syn, counts)
  kw = dict(i_max=i_max, sm_scale=OP_SHAPE[3] ** -0.5, return_diag=True)
  want, (w_scores, w_sel, w_m, w_l) = jops.synopsis_attention(
      *map(jnp.asarray, args), impl="interpret", **kw)
  got, (scores, sel, m, l) = ops.synopsis_attention(*map(_t, args), **kw)
  _close(got, want)
  _close(scores, w_scores)
  np.testing.assert_array_equal(np.sort(sel.numpy(), -1),
                                np.sort(np.asarray(w_sel), -1))
  _close(m, w_m)
  _close(l, w_l)
  out_ref, scores_ref, sel_ref = ref.synopsis_attention_ref(
      *map(_t, args), i_max=i_max, sm_scale=kw["sm_scale"])
  _close(out_ref, want)
  np.testing.assert_array_equal(sel_ref.numpy(), sel.numpy())


def test_unfused_synopsis_attention_full_budget_is_exact():
  q, k, v, k_syn, v_syn, counts, _ = _decode_inputs(OP_SHAPE)
  M, sm = k_syn.shape[2], OP_SHAPE[3] ** -0.5
  got = ops.synopsis_attention(*map(_t, (q, k, v, k_syn, v_syn, counts)),
                               i_max=M, sm_scale=sm)
  want = jref.exact_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), sm_scale=sm)
  _close(got, want, STEP_TOL)
  _close(ref.exact_attention_ref(_t(q), _t(k), _t(v), sm_scale=sm), want)
  _close(ops.exact_decode_attention(_t(q), _t(k), _t(v), sm_scale=sm),
         jops.exact_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), sm_scale=sm,
                                     impl="interpret"))


@pytest.mark.parametrize("i_max", [1, 4, 16])
def test_fused_synopsis_attention_matches_jax(i_max):
  q, k, v, k_syn, v_syn, counts, _ = _decode_inputs(OP_SHAPE, seed=5)
  args = (q, k, v, k_syn, v_syn, counts)
  kw = dict(i_max=i_max, sm_scale=OP_SHAPE[3] ** -0.5, return_diag=True)
  want, (w_scores, w_sel, w_m, w_l) = jops.synopsis_attention_fused(
      *map(jnp.asarray, args), impl="interpret", **kw)
  got, (scores, sel, m, l) = ops.synopsis_attention_fused(*map(_t, args),
                                                          **kw)
  _close(got, want)
  _close(scores, w_scores)
  np.testing.assert_array_equal(np.sort(sel.numpy(), -1),
                                np.sort(np.asarray(w_sel), -1))
  _close(m, w_m)
  _close(l, w_l)
  # the two compositions compute the same function
  _close(got, ops.synopsis_attention(*map(_t, args), i_max=i_max,
                                     sm_scale=kw["sm_scale"]))


# ---------------------------------------------------------------------------
# The exact serve step and loop
# ---------------------------------------------------------------------------

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
  return jcfg, jparams, cfg, params, prompt.astype(np.int32)


def test_exact_serve_step_matches_jax(llama):
  jcfg, jparams, cfg, params, prompt = llama
  _, jc = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
  assert set(tc) == {"k", "v", "pos"}
  tok = np.array([[5], [77]], np.int32)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, mode="exact",
                                         impl="interpret"))(
      jparams, jc, jnp.asarray(tok))
  lg, st = make_serve_step(cfg, mode="exact")(params, tc,
                                              torch.from_numpy(tok).long())
  _close(lg, lg_j, STEP_TOL)
  for name in ("k_delta", "v_delta"):
    assert tuple(st[name].shape) == st_j[name].shape
    _close(st[name], st_j[name], STEP_TOL)
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))


def _jax_exact_loop(jcfg, jparams, prompt, tokens):
  """The single-batch loop of ``repro.launch.serve`` in exact mode: no
  build, budget 0, only ``pos`` advances (the new KV is never
  appended)."""
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  step = jax.jit(j_make_serve_step(jcfg, mode="exact", i_max=0,
                                   impl="xla"))
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  out = [tok]
  for _ in range(tokens):
    logits, st = step(jparams, cache, tok)
    cache["pos"] = st["pos"]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out.append(tok)
  return np.asarray(jnp.concatenate(out, 1)), np.asarray(cache["pos"])


def test_exact_loop_generates_jax_token_ids(llama):
  jcfg, jparams, cfg, params, prompt = llama
  want_ids, want_pos = _jax_exact_loop(jcfg, jparams, prompt, N_TOKENS)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=N_TOKENS,
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(), mode="exact",
                   log=lambda _: None)
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  assert out["budgets"] == [0] * N_TOKENS and out["absorbs"] == 0
  assert out["build_ms"] == 0.0 and set(out["cache"]) == {"k", "v", "pos"}
  np.testing.assert_array_equal(out["cache"]["pos"].numpy(), want_pos)
  assert tuple(out["cache"]["k"].shape)[4] == S   # nothing appended


def test_exact_launcher_cli_on_cpu(capsys):
  out = launch.main(["--device", "cpu", "--mode", "exact", "--prompt-len",
                     "64", "--tokens", "3", "--batch", "1"])
  assert out["budgets"] == [0, 0, 0]
  assert tuple(out["tokens"].shape) == (1, 4)
  printed = capsys.readouterr().out
  assert "[prefill]" in printed and "generated:" in printed


def test_exact_mode_refuses_a_budget():
  with pytest.raises(SystemExit) as e:
    launch.main(["--device", "cpu", "--mode", "exact", "--budget", "1",
                 "--tokens", "1"])
  assert e.value.code != 0
  cfg = get_config("llama3-8b", smoke=True)
  with pytest.raises(ValueError, match="exact"):
    launch.run(cfg, batch=1, prompt_len=16, tokens=1, device="cpu",
               mode="exact", budgets=[1])
  with pytest.raises(ValueError, match="mode"):
    launch.run(cfg, batch=1, prompt_len=16, tokens=1, device="cpu",
               mode="approx")

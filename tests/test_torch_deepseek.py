"""deepseek-v2-236b in the port against the JAX package on the CPU (f32
SMOKE config; the JAX weights bridged over).

deepseek SMOKE: 2 layers, d 128, 4 heads, vocab 512; MLA with q_lora 64,
kv_lora 32, qk_nope 32, qk_rope 16, v_head 32 (the prefill attends at D =
48 with G = 1, v padded from 32; the absorbed decode reads one latent head
of 32 + 16 = 48 with all 4 query heads in f32); every layer an MoE of 4
experts of 64 (top 2) with 1 shared expert; C 16, i_max 2, recent 16.  At
full width the latent head is 576 wide and read by 128 query heads, the
prefill attends at D = 192, and each layer holds 160 experts (top 6) and
2 shared ones.

Tolerance: 4e-5 of max|reference| throughout (the floor of an arch
without a softcap, ROADMAP.md §C).  The checks shared with arctic-480b
and command-r-plus-104b are in ``tests/torch_arch_parity.py``.

* The config against the JAX one (MLA and MoE fields too), the registry,
  the tree (MLA's attention leaves, the shared experts), its count against
  JAX's (the port adds the norm gains, MLA's q_norm and kv_norm among
  them) and the 7-layer cut the card runs; the bridge refusing a missing
  shared-expert leaf and an extra GQA leaf.
* ``mla_latent``, ``mla_queries`` and ``mla_train`` on one layer.
* The MoE with shared experts against JAX's ``moe_ffn``, the routing
  compared exactly; the combine in the reference's scatter-add order,
  bit for bit in bf16 at k = 2 and k = 6 (and at k = 2 the old
  ``index_add_``'s bits).
* Prefill logits and the latent cache, one absorbed step at budgets 0, 1
  and M and exact, every step of both loops (18 steps, one absorb) and of
  the loop under each quant spec; the engine under ``int8+kv``; every
  quant spec passing the card's check (gemma2's ``+kv`` still refused).
* The slot pool's leaves; the engine's ids, budgets and every step's
  logits under ``fixed``, ``basic`` and ``accuracytrader``.
* ``supports_delta`` False as in JAX: an extension of a cached prefix
  takes the full build; a corpus hit gives the miss's ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_arch_parity as tap
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.serve import corpus_cache as jccache
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.common import MoEConfig
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import EngineConfig, ServingEngine, make_requests
from repro_torch.serve.prefill import make_extend_step
from repro_torch.serve.serve_step import check_quant_device

ARCH = "deepseek-v2-236b"


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
  return tap.load(ARCH)


@pytest.fixture(scope="module")
def caches(model):
  return tap.synopsis_cache(model)


def _x(rows, d, seed=4):
  return np.random.default_rng(seed).standard_normal(
      (*rows, d)).astype(np.float32)


# -- config and parameters ----------------------------------------------------

def test_config_matches_jax():
  tap.check_config(ARCH)
  full = get_config(ARCH)
  m = full.mla
  assert (m.kv_lora_rank + m.qk_rope_dim, full.n_heads) == (576, 128)
  assert (full.moe.num_experts, full.moe.top_k, full.moe.num_shared) == (
      160, 6, 2)
  # The port also counts the norm gains: ln1, ln2, q_norm and kv_norm a
  # layer, and final_norm.
  norms = (2 * full.n_layers + 1) * full.d_model + full.n_layers * (
      m.q_lora_rank + m.kv_lora_rank)
  assert full.param_count() == 239_375_569_920
  assert j_get_config(ARCH).param_count() == 239_374_827_520
  assert full.param_count() - j_get_config(ARCH).param_count() == norms
  assert full.param_count(active=True) - j_get_config(ARCH).param_count(
      active=True) == norms
  # The card's cut: 7 of 60 layers, ~57.7 GB of bf16 weights (58.8 GB with
  # the f32 unembedding the logits read).
  cut = dataclasses.replace(full, n_layers=7)
  assert cut.param_count() == 28_853_396_480


def test_parameter_tree_and_count(model):
  tap.check_tree(model, {"ln1", "attn", "ln2", "moe"})
  _, jparams, _, params, _, _ = model
  layer = params["blocks"]["pos0"]
  assert set(layer["attn"]) == set(jparams["blocks"]["pos0"]["attn"]) == {
      "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
  assert set(layer["moe"]["shared"]) == {"w1", "w3", "w2"}
  assert tuple(layer["moe"]["shared"]["w1"].shape) == (2, 128, 64)


def test_init_draws_the_jax_scales(model):
  """The port's own init: MLA's norms zero, wo at (H v_head)^-0.5, the
  other MLA leaves at their shape[-2] fan-in (H for wq_b, wk_b, wv_b), the
  shared experts at d and d_ff fan-in: each leaf's std within 15% of the
  JAX init's (truncated normal, std 0.88 of its scale)."""
  _, jparams, cfg, _, _, _ = model
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  jl, ml = jparams["blocks"]["pos0"], mine["blocks"]["pos0"]
  for sub, names in (("attn", ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
                               "wo")),
                     ("moe", ("router",))):
    for name in names:
      want = float(np.asarray(jl[sub][name]).std())
      assert abs(float(ml[sub][name].std()) - want) < 0.15 * want, name
  for name in ("w1", "w3", "w2"):
    want = float(np.asarray(jl["moe"]["shared"][name]).std())
    got = float(ml["moe"]["shared"][name].std())
    assert abs(got - want) < 0.15 * want, name
  for name in ("q_norm", "kv_norm"):
    assert not ml["attn"][name].any()


def test_bridge_refuses_a_missing_and_an_extra_leaf(model):
  tap.check_bridge_refuses(model, "blocks/pos0/moe/shared/w3",
                           "blocks/pos0/attn/bq")


# -- MLA ----------------------------------------------------------------------

def test_mla_latent_queries_and_train_match_jax(model):
  """One layer's latent (c_kv rms-normed, k_pe rope'd), its queries
  (through q_norm, q_pe rope'd) and the prefill's MLA attention (per-head
  keys, v padded from 32 to 48 and sliced back, scale 48^-0.5) with its
  latent cache (B, 1, S, 48), against JAX's functions."""
  jcfg, jparams, cfg, params, _, _ = model
  jlp = tap.layer_slice(jparams["blocks"]["pos0"])["attn"]
  lp = tf.layer_params(params["blocks"]["pos0"], 0)["attn"]
  x = _x((tap.B, tap.S), cfg.d_model)
  jx, xt = jnp.asarray(x), torch.from_numpy(x)
  jpos, pos = jnp.arange(tap.S)[None], torch.arange(tap.S)
  for jfn, fn in ((jattn.mla_latent, attn.mla_latent),
                  (jattn.mla_queries, attn.mla_queries)):
    for got, want in zip(fn(xt, lp, cfg, pos), jfn(jx, jlp, jcfg, jpos)):
      tap.close(got, want)
  y_j, (lat_j, lat2_j) = jattn.mla_train(jx, jlp, jcfg, jpos, return_kv=True,
                                         impl="xla")
  y, (lat, lat2) = attn.mla_train(xt, lp, cfg, pos)
  tap.close(y, y_j)
  assert lat is lat2 and tuple(lat.shape) == (tap.B, 1, tap.S, 48)
  tap.close(lat, lat_j)
  np.testing.assert_array_equal(np.asarray(lat_j), np.asarray(lat2_j))
  v = torch.ones(2, 3)
  assert attn.v_pad(v, 3) is v
  assert attn.v_pad(v, 5).tolist() == [[1, 1, 1, 0, 0]] * 2


# -- MoE with shared experts ----------------------------------------------------

def _jax_moe(x, jp, jcfg, monkeypatch):
  """JAX ``moe_ffn`` on x, eagerly, with the routing its two
  ``lax.top_k`` calls chose: (y, token-side top-k indices (T, K), each
  expert's kept tokens (E, cap))."""
  calls = []
  top_k = jax.lax.top_k

  def record(a, k):
    out = top_k(a, k)
    calls.append(np.asarray(out[1]))
    return out
  monkeypatch.setattr(jax.lax, "top_k", record)
  y, _ = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
  monkeypatch.setattr(jax.lax, "top_k", top_k)
  topi, tok = calls
  return np.asarray(y), topi[0], tok[0]


@pytest.mark.parametrize("rows,cap", [((tap.B, tap.S), 80), ((tap.B, 1), 1)],
                         ids=["prefill", "decode"])
def test_moe_with_shared_experts_matches_jax(model, monkeypatch, rows, cap):
  """The routed experts (routing compared exactly) plus the shared
  expert's SwiGLU: JAX's output; zeroing the shared w2 moves it by
  exactly the shared term."""
  jcfg, jparams, cfg, params, _, _ = model
  jp = tap.layer_slice(jparams["blocks"]["pos0"])["moe"]
  p = tf.layer_params(params["blocks"]["pos0"], 0)["moe"]
  x = _x(rows, cfg.d_model)
  y_j, topi_j, tok_j = _jax_moe(x, jp, jcfg, monkeypatch)
  xt = torch.from_numpy(x)
  tok, _, topi, _ = moe.route(xt.reshape(-1, cfg.d_model), p["router"], cfg)
  assert moe.capacity(cfg, rows[0] * rows[1]) == cap == tok.shape[1]
  np.testing.assert_array_equal(topi.numpy(), topi_j)
  np.testing.assert_array_equal(tok.numpy(), tok_j)
  y, _ = moe.moe_ffn(xt, p, cfg)
  tap.close(y, y_j)
  s = p["shared"]
  shared = tf.swiglu(xt, s["w1"], s["w3"], s["w2"])
  assert float(shared.abs().max()) > 0.1 * float(y.abs().max())
  no_shared = dict(p, shared=dict(s, w2=torch.zeros_like(s["w2"])))
  tap.close(y - moe.moe_ffn(xt, no_shared, cfg)[0], shared)


@pytest.mark.parametrize("k", [2, 6])
def test_combine_adds_in_the_reference_scatter_order(k):
  """The combine of 64 tokens' kept expert outputs (8 experts, top k, bf16)
  equals JAX's scatter-add over the flattened (E, cap) slots bit for bit:
  each token's terms in ascending expert order, one rounding an add.  At k
  = 2 that is also the old ``index_add_`` (two terms commute); at k = 6
  the order matters: the same terms added in descending expert order give
  other bits."""
  cfg = dataclasses.replace(get_config(ARCH, smoke=True), moe=MoEConfig(
      num_experts=8, top_k=k, d_ff_expert=64))
  g = torch.Generator().manual_seed(k)
  x = torch.randn((64, cfg.d_model), generator=g)
  tok, gate, topi, _ = moe.route(x, torch.randn((cfg.d_model, 8),
                                                generator=g), cfg)
  y = (torch.randn((8, tok.shape[1], 32), generator=g)
       * gate[..., None]).bfloat16()
  got = moe.combine(y, tok, topi)
  want = jnp.zeros((64, 32), jnp.bfloat16).at[tok.reshape(-1).numpy()].add(
      jnp.asarray(y.float().numpy(), jnp.bfloat16).reshape(-1, 32))
  np.testing.assert_array_equal(got.float().numpy(),
                                np.asarray(want, np.float32))
  old = torch.zeros((64, 32), dtype=torch.bfloat16).index_add_(
      0, tok.reshape(-1), y.reshape(-1, 32))
  if k == 2:
    assert torch.equal(got, old)
  else:
    flipped = moe.combine(y.flip(0), tok.flip(0), 7 - topi)
    assert not torch.equal(got, flipped)
    tap.close(flipped.double(), got.double(), rel=2.0 ** -6)


# -- prefill, steps and the loop ----------------------------------------------

def test_prefill_logits_and_latent_cache_match_jax(model):
  tap.check_prefill(model)


@pytest.mark.parametrize("mode,budget", [("synopsis", 0), ("synopsis", 1),
                                         ("synopsis", tap.S // 16),
                                         ("exact", 0)])
def test_absorbed_step_matches_jax(model, caches, mode, budget):
  tap.check_step(model, caches, mode, budget)


@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_loop_matches_jax_every_step(model, mode):
  tap.check_loop(model, mode)


def _quantized(model, quant):
  """The model tuple with both configs under ``quant``."""
  jcfg, jparams, cfg, params, prompt, basis = model
  jq = dataclasses.replace(jcfg, synopsis=dataclasses.replace(
      jcfg.synopsis, quant=quant))
  return jq, jparams, launch.apply_quant(cfg, quant), params, prompt, basis


@pytest.mark.parametrize("quant", ["int8", "fp8", "int8+kv", "fp8+kv"])
def test_int8_kv_loop_matches_jax(model, quant):
  """Every quant spec on the CPU: the latent's tables (and under ``+kv``
  its sorted rows) as int8 / fp8 codes, the plain versions of the
  quantized branches; ids and every step's logits of the 18-step loop
  (one absorb)."""
  jq, jparams, cq, params, prompt, basis = _quantized(model, quant)
  want_ids, want_logits, _ = tap._jax_loop(jq, jparams, prompt, tap.BUDGETS,
                                           "synopsis")
  out = launch.run(cq, batch=tap.B, prompt_len=tap.S,
                   tokens=len(tap.BUDGETS), device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(),
                   budgets=tap.BUDGETS, pca_basis=torch.from_numpy(basis),
                   keep_logits=True, log=lambda _: None)
  kind = quant.split("+")[0]
  kv = torch.int8 if kind == "int8" else torch.float8_e4m3fn
  assert out["cache"]["k_syn"].dtype == kv and out["absorbs"] == 1
  assert (out["cache"]["k"].dtype == kv) == quant.endswith("+kv")
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for got, want in zip(out["step_logits"], want_logits):
    tap.close(got, want)


def test_int8_kv_engine_matches_jax(model):
  """The SMOKE engine under int8+kv against the JAX engine: events, ids,
  budgets and every step's logits (``fixed`` at budget 1)."""
  tap.check_engine(_quantized(model, "int8+kv"), "fixed", fixed_budget=1)


@pytest.mark.parametrize("quant", ["int8", "fp8", "int8+kv", "fp8+kv"])
def test_quant_specs_pass_the_card_check(quant):
  """On a CUDA device every quant spec passes ``check_quant_device`` for
  MLA, at SMOKE and full width (the latent core has the quantized stage 1
  and stage 2), as on the CPU; the check runs nothing."""
  for smoke in (False, True):
    cfg = launch.apply_quant(get_config(ARCH, smoke=smoke), quant)
    for device in ("cuda", "cuda:0", "cpu"):
      check_quant_device(cfg, device)


@pytest.mark.parametrize("quant", ["int8+kv", "fp8+kv"])
def test_gemma2_kv_specs_still_refused_on_the_card(quant):
  """gemma2's local layers would hand flash_decode raw codes under ``+kv``
  (a reference quirk refused on purpose, ROADMAP C): still refused on a
  CUDA device, and passed on the CPU and under the table-only specs."""
  cfg = launch.apply_quant(get_config("gemma2-2b"), quant)
  with pytest.raises(ValueError, match="local"):
    check_quant_device(cfg, "cuda")
  check_quant_device(cfg, "cpu")
  check_quant_device(launch.apply_quant(get_config("gemma2-2b"),
                                        quant.split("+")[0]), "cuda")


# -- the engine and the corpus cache ------------------------------------------

@pytest.mark.parametrize("synopsis", [True, False])
def test_slot_pool_leaves_match_jax(model, synopsis):
  tap.check_pool(model, synopsis)


@pytest.mark.parametrize("policy,kw", [("fixed", dict(fixed_budget=1)),
                                       ("basic", {}),
                                       ("accuracytrader", {})],
                         ids=["fixed", "basic", "accuracytrader"])
def test_engine_matches_jax(model, policy, kw):
  tap.check_engine(model, policy, **kw)


def test_extension_miss_takes_the_full_build(model):
  """supports_delta is False in both packages, the engine builds no extend
  step and refuses one; a prompt extending a cached 32-token prefix by a
  whole number of clusters misses, runs the full prefill and build, and
  gives the ids of the same request with the cache off."""
  jcfg, _, cfg, params, _, basis = model
  assert jccache.supports_delta(jcfg) is ccache.supports_delta(cfg) is False
  with pytest.raises(NotImplementedError, match="MLA"):
    make_extend_step(cfg)
  kw = dict(n_slots=1, prompt_len=tap.S, max_new_tokens=tap.NEW,
            policy="fixed", fixed_budget=1)
  engs = [ServingEngine(cfg, EngineConfig(**kw, **extra), params=params,
                        pca_basis=torch.from_numpy(basis), device="cpu")
          for extra in ({}, dict(cache=CacheConfig(capacity=4,
                                                   delta_unit=16)))]
  off, on = engs
  assert not on._delta_ok and on._extend is None
  prompt = np.random.default_rng(8).integers(0, cfg.vocab, tap.S).astype(
      np.int32)
  P = tap.S // 2
  logits, c = on._prefill(params, torch.from_numpy(prompt[None, :P]).long())
  on.corpus_cache.publish(prompt[:P], on._build(c), logits.argmax(-1))
  ids = []
  for eng in engs:
    reqs = make_requests([0.0], tap.S, tap.NEW, cfg.vocab, seed=0)
    reqs[0].prompt = prompt
    eng.run(reqs)
    ids.append(reqs[0].tokens)
  assert ids[0] == ids[1]
  s = on.summary()
  assert (s["cache_hits"], s["cache_misses"], s["prefills"]) == (0, 1, 1)
  assert on.corpus_cache.stats()["delta_hits"] == 0


def test_corpus_hit_gives_the_miss_ids(model):
  tap.check_corpus_hit(model)

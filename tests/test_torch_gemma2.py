"""gemma2-2b in the port against the JAX package, on the CPU (f32 SMOKE
config: 2 layers, local then global, d 128, 4/2 heads, hd 32, window 16,
C 16, i_max 2, recent 16; the JAX weights bridged over).

Tolerance, unless a test states otherwise: 1e-5 of max|reference| (the
same f32 arithmetic summed in another order, through softcaps, sandwich
norms and two layers).  The random init attends nearly one-hot, so the
ids repeat one token; every test that runs decode steps holds the logits
of every step, not only the ids.

* The config (full and SMOKE) and its parameter count.
* ``flash_prefill``'s plain version against the Pallas kernel in interpret
  mode at D = 256 with a window and cap 50, at a small S.
* The prefill step: last-token logits and the whole cache, prompt 64 (the
  window of 16 masks keys).
* One serve step on the JAX synopsis cache at budgets 0, 1 and M, and in
  exact mode (local layers decode exactly over the window of the layer's
  own cache, global layers run the synopsis or exact path, all capped).
* The loop: 18 tokens (one absorb), every step's logits.
* The engine: ids and every step's logits under ``fixed`` and ``basic``;
  the raw loss estimates under ``deadline_with_bound`` (the coverage
  profile averages the global layers only).
* ``supports_delta`` is False, as in the JAX package.
* ``int8+kv`` at SMOKE size: the loop's ids and logits; ``int8`` and
  ``fp8`` (tables only: the sorted cache stays in the model's dtype) the
  same.  On a CUDA device ``int8+kv`` / ``fp8+kv`` are refused at the entry
  of the loop and of the engine (flash_decode does not attend over the
  codes the local layers would hand it), before any tensor is made.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import corpus_cache as jccache
from repro.serve import synopsis_kv as jskv
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as tf
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve.engine import EngineConfig, ServingEngine, make_requests
from repro_torch.serve.prefill import make_extend_step, make_prefill_step
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.serve_step import (check_quant_device,
                                          global_positions, make_serve_step)

ARCH = "gemma2-2b"
B, S = 2, 64
REL = 1e-5
# Budgets 0..2 in a fixed order: every step kind, and one absorb at 16.
BUDGETS = [2, 1, 0, 2, 2, 1, 0, 2, 1, 2, 0, 1, 2, 2, 1, 0, 2, 1]
N_SLOTS, NEW, PROMPT = 2, 4, 64
ARRIVALS = [0.0, 1.0, 2.0, 3.0]


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gemma():
  """(JAX cfg, JAX params, port cfg, port params, prompt, PCA basis)."""
  jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32), basis


def _close(got, want, rel=REL):
  got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def _torch_cache(jc):
  return {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


# -- config and model ----------------------------------------------------------

def test_config_is_gemma2_2b(gemma):
  jcfg, jparams, cfg, _, _, _ = gemma
  names = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
           "hd", "rope_theta", "norm_eps", "sliding_window", "attn_softcap",
           "logit_softcap", "sandwich_norm", "scale_embed", "tie_embeddings")
  for smoke in (False, True):
    got, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH,
                                                             smoke=smoke)
    for name in names:
      assert getattr(got, name) == getattr(want, name), (smoke, name)
    assert [s.local for s in got.block_pattern] == \
        [s.local for s in want.block_pattern] == [True, False]
    assert dataclasses.asdict(got.synopsis) == {
        k: v for k, v in dataclasses.asdict(want.synopsis).items()
        if k in ("cluster_size", "i_max", "recent", "quant")}
    assert got.param_count() - want.param_count() == (
        got.d_model * (1 + 4 * got.n_layers))      # the port counts norms
  full = get_config(ARCH)
  assert full.hd == 256 and full.n_blocks == 13 and full.dtype == \
      torch.bfloat16
  assert abs(full.param_count() / 1e9 - 2.614) < 0.001
  # The parameter tree: tied (no unembed), post norms on every layer.
  assert cfg.param_count() == sum(
      leaf.size for leaf in jax.tree_util.tree_leaves(jparams))
  assert global_positions(cfg) == (1,)


def test_init_model_tree_and_tied_logits(gemma):
  jcfg, jparams, cfg, params, _, _ = gemma
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
  for path, leaf in flat_j:
    node = mine
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
  assert "unembed" not in jparams
  # The logits read one f32 copy of embed.T (the bridged tree's too).
  for p in (mine, params):
    assert p["unembed"].dtype == torch.float32
    assert torch.equal(p["unembed"], p["embed"].float().t())
  bf16 = tf.init_model(dataclasses.replace(cfg, dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0), "cpu")
  assert bf16["embed"].dtype == torch.bfloat16
  assert torch.equal(bf16["unembed"], bf16["embed"].float().t())
  h = np.random.default_rng(3).standard_normal((2, 1, cfg.d_model))
  want = jtf.logits_fn(jparams, jcfg, jnp.asarray(h, jnp.float32))
  got = tf.logits_fn(params, cfg, torch.from_numpy(h).float())
  _close(got, want)
  assert float(got.abs().max()) <= cfg.logit_softcap
  with pytest.raises(KeyError, match="ln1_post"):
    tree = jax.tree.map(np.asarray, jparams)
    del tree["blocks"]["pos0"]["ln1_post"]
    bridge.params_from_numpy(tree, cfg, "cpu")
  with pytest.raises(KeyError, match="unembed"):
    tf.finish_params({**params, "unembed": params["unembed"]}, cfg)


def test_embedding_scale_is_rounded_to_the_dtype():
  full = get_config(ARCH)
  assert tf.embed_scale(full) == 48.0            # sqrt(2304) in bf16
  smoke = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype=torch.float32)
  assert tf.embed_scale(smoke) == float(np.float32(128 ** 0.5))
  assert tf.embed_scale(get_config("llama3-8b")) is None


@pytest.mark.parametrize("S_,window,G", [(80, 24, 2), (48, 7, 4)])
def test_prefill_plain_matches_pallas_at_d256(S_, window, G):
  """The plain version (what CPU tensors run, and what the card's kernel
  is held to) against the Pallas kernel in interpret mode, D = 256, cap
  50, a window edge inside a block."""
  rng = np.random.default_rng(5)
  Hkv, D = 2, 256
  q = rng.standard_normal((1, S_, Hkv * G, D)).astype(np.float32)
  k = rng.standard_normal((1, S_, Hkv, D)).astype(np.float32)
  v = rng.standard_normal((1, S_, Hkv, D)).astype(np.float32)
  kw = dict(sm_scale=D ** -0.5, cap=50.0, window=window)
  want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         block_q=16, block_k=16, interpret=True, **kw)
  got = ref.flash_prefill_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
  _close(got, want)


def test_prefill_matches_jax(gemma):
  jcfg, jparams, cfg, params, prompt, _ = gemma
  lg_j, cache_j = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  assert S > cfg.sliding_window              # the window masks keys
  _close(lg, lg_j)
  for name in ("k", "v"):
    _close(cache[name], cache_j[name])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))


# -- decode ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def synopsis_cache(gemma):
  jcfg, jparams, _, _, prompt, _ = gemma
  _, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3     # a partly filled ring
  return cache, jc


@pytest.mark.parametrize("mode,budget", [("synopsis", 0), ("synopsis", 1),
                                         ("synopsis", S // 16),
                                         ("exact", 0)])
def test_serve_step_matches_jax(gemma, synopsis_cache, mode, budget):
  jcfg, jparams, cfg, params, _, _ = gemma
  exact_cache, jc = synopsis_cache
  jc = jc if mode == "synopsis" else exact_cache
  tok = np.array([[5], [77]], np.int32)
  kw = dict(mode=mode, i_max=budget)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, impl="xla", **kw))(
      jparams, jc, jnp.asarray(tok))
  lg, st = make_serve_step(cfg, **kw)(params, _torch_cache(jc),
                                      torch.from_numpy(tok).long())
  _close(lg, lg_j)
  for name in ("k_delta", "v_delta"):
    _close(st[name], st_j[name])
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))


def test_local_layer_reads_its_window_only(gemma, synopsis_cache):
  """The local layer's decode sees the last ``window`` rows of its own k/v
  and nothing else of the cache: changing rows before the window, the
  ring or the synopsis tables of layer 0 moves no logit."""
  _, _, cfg, params, _, _ = gemma
  _, jc = synopsis_cache
  tc = _torch_cache(jc)
  tok = torch.tensor([[5], [77]])
  step = make_serve_step(cfg, i_max=1)
  want, _ = step(params, tc, tok)
  W = cfg.sliding_window
  for name in ("k", "v"):
    tc[name][0, 0, :, :, :-W] = 7.0
  for name in ("k_syn", "v_syn", "recent_k", "recent_v"):
    tc[name][0, 0] = 3.0
  got, _ = step(params, tc, tok)
  assert torch.equal(got, want)
  tc["k"][0, 0, :, :, -1] += 1.0
  assert not torch.equal(step(params, tc, tok)[0], want)


def _jax_loop(jcfg, jparams, prompt, budgets):
  """The JAX single-batch loop with fixed budgets; every step's logits."""
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  cache = jskv.build(cache, jcfg, impl="xla")
  steps, out = {}, [np.asarray(logits)]
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  ids = [tok]
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
    ids.append(tok)
    out.append(np.asarray(logits))
  return np.asarray(jnp.concatenate(ids, 1)), out, cache


def _port_loop(cfg, params, prompt, basis, budgets):
  return launch.run(cfg, batch=B, prompt_len=S, tokens=len(budgets),
                    device="cpu", params=params,
                    prompt=torch.from_numpy(prompt).long(), budgets=budgets,
                    pca_basis=torch.from_numpy(basis), keep_logits=True,
                    log=lambda _: None)


def test_loop_matches_jax_logits_every_step(gemma):
  jcfg, jparams, cfg, params, prompt, basis = gemma
  want_ids, want_logits, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS)
  out = _port_loop(cfg, params, prompt, basis, BUDGETS)
  assert out["absorbs"] == 1
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  assert len(out["step_logits"]) == len(want_logits) == len(BUDGETS) + 1
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)
  for name in ("k", "k_syn", "counts", "recent_k", "recent_len"):
    assert tuple(out["cache"][name].shape) == jcache[name].shape, name
  _close(out["cache"]["k"], jcache["k"])


def test_exact_loop_matches_jax(gemma):
  """--mode exact: never appends (the JAX loop only advances pos); every
  step over the prompt cache, the local layers over its last 16 rows."""
  jcfg, jparams, cfg, params, prompt, _ = gemma
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  step = jax.jit(j_make_serve_step(jcfg, mode="exact", impl="xla"))
  want = [np.asarray(logits)]
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  for _ in range(6):
    logits, st = step(jparams, cache, tok)
    cache["pos"] = st["pos"]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want.append(np.asarray(logits))
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=6, device="cpu",
                   params=params, prompt=torch.from_numpy(prompt).long(),
                   mode="exact", keep_logits=True, log=lambda _: None)
  for got, w in zip(out["step_logits"], want):
    _close(got, w)


def test_int8_kv_loop_matches_jax(gemma):
  """int8+kv: the quantized arena in every layer (the local layers read
  their int8 sorted cache as given, as the JAX step does); ids and every
  step's logits, budgets [2, 1, 0] * 6."""
  jcfg, jparams, cfg, params, prompt, basis = gemma
  jq = dataclasses.replace(jcfg, synopsis=dataclasses.replace(
      jcfg.synopsis, quant="int8+kv"))
  q = launch.apply_quant(cfg, "int8+kv")
  budgets = [2, 1, 0] * 6
  want_ids, want_logits, _ = _jax_loop(jq, jparams, prompt, budgets)
  out = _port_loop(q, params, prompt, basis, budgets)
  assert out["cache"]["k"].dtype == torch.int8 and out["absorbs"] == 1
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_table_quant_loop_matches_jax(gemma, quant):
  """int8 / fp8 quantize the synopsis tables only: the global layers run
  stage 1 on the quantized tables, the local layers read their window of
  the unquantized sorted cache; ids and every step's logits, budgets [2,
  1, 0] * 6 (one absorb)."""
  jcfg, jparams, cfg, params, prompt, basis = gemma
  jq = dataclasses.replace(jcfg, synopsis=dataclasses.replace(
      jcfg.synopsis, quant=quant))
  q = launch.apply_quant(cfg, quant)
  budgets = [2, 1, 0] * 6
  want_ids, want_logits, _ = _jax_loop(jq, jparams, prompt, budgets)
  out = _port_loop(q, params, prompt, basis, budgets)
  assert out["cache"]["k"].dtype == torch.float32 and out["absorbs"] == 1
  assert out["cache"]["k_syn"].dtype == (torch.int8 if quant == "int8" else
                                         torch.float8_e4m3fn)
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)


@pytest.mark.parametrize("quant", ["int8+kv", "fp8+kv"])
def test_kv_quant_refused_on_the_card_at_entry(gemma, quant, monkeypatch):
  """On a CUDA device the +kv specs raise at the entry of the loop and of
  the engine, naming the local layers, before any tensor is made: the
  device is not even resolved (here, without a card, resolving it would
  raise something else).  The table-only spec, another arch's +kv and the
  CPU pass the check."""
  _, _, cfg, _, _, _ = gemma
  q = launch.apply_quant(cfg, quant)

  def reached(*a, **kw):
    raise AssertionError("the refusal came after the entry")
  for mod in (launch, engine_mod):
    monkeypatch.setattr(mod, "resolve_device", reached)
  monkeypatch.setattr(tf, "init_model", reached)
  with pytest.raises(ValueError, match=r"local .* layers \[0\]"):
    launch.run(q, batch=B, prompt_len=S, tokens=4, device="cuda")
  with pytest.raises(ValueError, match="flash_decode"):
    ServingEngine(q, EngineConfig(n_slots=N_SLOTS, prompt_len=PROMPT,
                                  max_new_tokens=NEW), device="cuda")
  full = launch.apply_quant(get_config(ARCH), quant)
  with pytest.raises(ValueError, match=r"layers \[0, 2, .*, 24\]"):
    check_quant_device(full, "cuda:0")
  check_quant_device(q, "cpu")
  check_quant_device(launch.apply_quant(cfg, quant.split("+")[0]), "cuda")
  check_quant_device(launch.apply_quant(get_config("llama3-8b"), quant),
                     "cuda")


def test_delta_replay_stays_off(gemma):
  jcfg, _, cfg, params, _, _ = gemma
  assert not jccache.supports_delta(jcfg)
  assert not ccache.supports_delta(cfg)
  assert ccache.supports_delta(get_config("llama3-8b", smoke=True))
  with pytest.raises(NotImplementedError, match="sliding-window"):
    make_extend_step(cfg)
  eng = ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, prompt_len=PROMPT,
                                        max_new_tokens=NEW),
                      params=params, device="cpu")
  assert not eng._delta_ok and eng._extend is None


# -- the engine --------------------------------------------------------------------

def _record_port(eng, log):
  """Each decode step's (active lanes, their logits)."""
  inner = eng._decode_step

  def step(active, *a, **kw):
    inner(active, *a, **kw)
    log.append(eng.step_out["logits"][list(active)].numpy().copy())
  eng._decode_step = step


def _record_jax(eng, log):
  inner_step, inner_fn = eng._decode_step, eng._step_fn
  active_now = []

  def step_fn(budget):
    fn = inner_fn(budget)

    def run(*a):
      logits, st = fn(*a)
      log.append(np.asarray(logits)[active_now[-1]])
      return logits, st
    return run

  def step(active, *a, **kw):
    active_now.append(list(active))
    inner_step(active, *a, **kw)
  eng._step_fn, eng._decode_step = step_fn, step


def _engines(gemma, **kw):
  jcfg, jparams, cfg, params, _, basis = gemma
  kw = dict(prompt_len=PROMPT, max_new_tokens=NEW, overlap_admission=False,
            **kw)
  jeng = JServingEngine(jcfg, JEngineConfig(n_slots=N_SLOTS, impl="xla",
                                            **kw), params=jparams)
  eng = ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, **kw),
                      params=params, pca_basis=torch.from_numpy(basis),
                      device="cpu")
  return jeng, eng


def _ids(reqs):
  return [r.tokens for r in sorted(reqs, key=lambda r: r.rid)]


@pytest.mark.parametrize("arm", [dict(policy="fixed", fixed_budget=1),
                                 dict(policy="fixed", fixed_budget=0),
                                 dict(policy="basic")],
                         ids=["fixed1", "fixed0", "basic"])
def test_engine_matches_jax_ids_and_logits(gemma, arm):
  jeng, eng = _engines(gemma, **arm)
  jlog, log = [], []
  _record_jax(jeng, jlog)
  _record_port(eng, log)
  vocab = gemma[2].vocab
  jreqs = j_make_requests(ARRIVALS, PROMPT, NEW, vocab, seed=13)
  jeng.run(jreqs)
  reqs = make_requests(ARRIVALS, PROMPT, NEW, vocab, seed=13)
  eng.run(reqs)
  assert _ids(reqs) == _ids(jreqs)
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  assert len(log) == len(jlog) >= NEW
  for got, want in zip(log, jlog):
    _close(got, want)


def test_engine_contract_profile_over_global_layers(gemma):
  """deadline_with_bound at budget 1: the same ids, and every step's raw
  loss estimate within 1e-5 (the JAX engine averages the coverage
  profile over the layers that run the synopsis: the global ones)."""
  kw = dict(policy="fixed", fixed_budget=1, contract="deadline_with_bound")
  jeng, eng = _engines(gemma, **kw)
  vocab = gemma[2].vocab
  jreqs = j_make_requests(ARRIVALS, PROMPT, NEW, vocab, seed=13)
  jeng.run(jreqs)
  reqs = make_requests(ARRIVALS, PROMPT, NEW, vocab, seed=13)
  eng.run(reqs)
  assert _ids(reqs) == _ids(jreqs)
  for r, jr in zip(sorted(reqs, key=lambda r: r.rid),
                   sorted(jreqs, key=lambda r: r.rid)):
    assert len(r.est_raw) == len(jr.est_raw) == NEW
    np.testing.assert_allclose(r.est_raw, jr.est_raw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.est_spread, jr.est_spread, rtol=0,
                               atol=1e-5)

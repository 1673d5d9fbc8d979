"""jamba-v0.1-52b in the port against the JAX package on the CPU (f32 SMOKE
config; the JAX weights bridged over).

jamba SMOKE: 4 layers in 2 blocks of a 2-layer pattern: an attention
layer (4/2 heads of 32, dense SwiGLU MLP, d_ff 256) then a mamba layer
(8 SSM heads of 32, state 16) with an MoE FFN (4 experts of 256, top 2);
d 128, vocab 512, untied; C 16, i_max 2, recent 16.  The cache stacks
k / v and the synopsis over the one attention position, the SSM state
over the one mamba position.

Tolerance: 4e-5 of max|reference| throughout (the largest distance seen
is ~1e-5 of max, the prefill's ``ssd_state``; logits ~2e-6).  Routing is
compared exactly: the token side's top-k and each expert's kept tokens.
If a near-tie ever flips a choice, the failure message gives the margin
between the choices.

* The config against the JAX one, the registry, the parameter tree and
  its count (and the 16-layer cut the card runs), the bridge's checks.
* ``moe_ffn`` at prefill (64 tokens a row, capacity 80) and at decode
  (one token a row, capacity 1), outputs, aux loss and routing; two rows
  that choose one expert at capacity 1, where both packages keep the
  higher-gated row and drop the other.
* The prefill step (logits, k / v, ``conv_state`` / ``ssd_state``), one
  serve step per budget and exact, and the synopsis and exact loops (18
  steps, one absorb): ids and every step's logits.  The loop never writes
  a step's SSM state back, as in JAX.
* The slot pool's leaves against the JAX pool's; the engine's ids, every
  step's logits and the final pool's SSM state against the JAX engine's,
  under ``fixed`` 1 and ``basic``, admission overlap on and off; the SSM
  state advancing per step (the twin of the JAX
  ``test_hybrid_ssm_state_advances_per_step``).
* ``supports_delta`` False as in JAX; a corpus hit restores the SSM state
  of the prefill that published the arena and gives the miss's ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import corpus_cache as jccache
from repro.serve import kv_cache as jkvc
from repro.serve import prefill as jpf
from repro.serve import synopsis_kv as jskv
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import serve as launch
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.serve import corpus_cache as ccache
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import EngineConfig, ServingEngine, make_requests
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

ARCH = "jamba-v0.1-52b"
B, S = 2, 64
REL = 4e-5
BUDGETS = [2, 1, 0, 2, 2, 1, 0, 2, 1, 2, 0, 1, 2, 2, 1, 0, 2, 1]
NEW = 4
ARRIVALS = [0.0, 1.0, 2.0, 3.0]
SSM_LEAVES = ("conv_state", "ssd_state")


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
  """(JAX cfg, JAX params, port cfg, port params, prompt, PCA basis) in
  f32."""
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
  got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def _torch_cache(jc):
  return {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


def _prefill_jax(jcfg, jparams, prompt):
  return jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))


# -- config and parameters ----------------------------------------------------

def test_config_matches_jax():
  for smoke in (False, True):
    got, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH,
                                                             smoke=smoke)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "rope_theta", "norm_eps", "tie_embeddings"):
      assert getattr(got, name) == getattr(want, name), (smoke, name)
    assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert [(s.kind, s.use_moe) for s in got.block_pattern] == \
        [(s.kind, s.use_moe) for s in want.block_pattern]
    assert kvc.n_attn_positions(got) == jkvc.n_attn_positions(want) == 1
  assert ARCH in list_archs()
  full = get_config(ARCH)
  assert full.dtype == torch.bfloat16 and full.n_blocks == 4
  assert [s.kind for s in full.block_pattern].index("attn") == 4
  assert sum(s.use_moe for s in full.block_pattern) == 4
  # The port also counts the norm gains and the SSM's small leaves.
  assert full.param_count() == 51_460_000_640
  assert j_get_config(ARCH).param_count() == 51_443_662_848
  # The card's cut: 16 of 32 layers, ~52.0 GB of bf16 weights.
  cut = dataclasses.replace(full, n_layers=16)
  assert cut.n_blocks == 2 and cut.param_count() == 25_998_437_824


def test_parameter_tree_and_count(model):
  _, jparams, cfg, params, _, _ = model
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  n = 0
  for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
    node = mine
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
    n += leaf.size
  assert cfg.param_count() == n
  assert set(mine["blocks"]["pos0"]) == {"ln1", "attn", "ln2", "mlp"}
  assert set(mine["blocks"]["pos1"]) == {"ln1", "ssm", "ln2", "moe"}
  e = cfg.moe
  assert cfg.param_count(active=True) == n - 3 * cfg.d_model * \
      e.d_ff_expert * (e.num_experts - e.top_k) * cfg.n_blocks


def test_bridge_checks_both_subtrees(model):
  _, jparams, cfg, _, _, _ = model
  for sub, leaf in (("ssm", "A_log"), ("moe", "router"), ("moe", "w2")):
    tree = jax.tree.map(np.asarray, jparams)
    del tree["blocks"]["pos1"][sub][leaf]
    with pytest.raises(KeyError, match=f"{sub}/{leaf}"):
      bridge.params_from_numpy(tree, cfg, "cpu")
  tree = jax.tree.map(np.asarray, jparams)
  tree["blocks"]["pos1"]["moe"]["w1"] = tree["blocks"]["pos1"]["moe"]["w1"][
      :, :3]
  with pytest.raises(KeyError, match="moe/w1"):
    bridge.params_from_numpy(tree, cfg, "cpu")
  p = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_config(ARCH, smoke=True), "cpu")
  assert {t.dtype for t in (*p["blocks"]["pos1"]["ssm"].values(),
                            *p["blocks"]["pos1"]["moe"].values())} == {
      torch.bfloat16}


# -- MoE ----------------------------------------------------------------------

def _jax_moe(x, jp, jcfg, monkeypatch):
  """JAX ``moe_ffn`` on x, eagerly, with the routing its two
  ``lax.top_k`` calls chose: (y, aux, token-side top-k indices (T, K),
  each expert's kept tokens (E, cap), their gates)."""
  calls = []
  top_k = jax.lax.top_k

  def record(a, k):
    out = top_k(a, k)
    calls.append((np.asarray(out[0]), np.asarray(out[1])))
    return out
  monkeypatch.setattr(jax.lax, "top_k", record)
  y, aux = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
  monkeypatch.setattr(jax.lax, "top_k", top_k)
  (_, topi), (gate, tok) = calls
  return (np.asarray(y), float(aux), topi[0], tok[0],
          np.where(gate[0] > 0, gate[0], 0.0))


def _margins(x, p, cfg):
  """The smallest gap, over the tokens, between the k-th and (k+1)-th
  router probability: how near the token side's choice is to a tie."""
  probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
  top = torch.sort(probs, -1, descending=True).values
  k = cfg.moe.top_k
  return float((top[:, k - 1] - top[:, k]).min())


def _moe_layer(jparams, params):
  return (jax.tree.map(lambda a: a[0], jparams["blocks"]["pos1"]["moe"]),
          tf.layer_params(params["blocks"]["pos1"], 0)["moe"])


@pytest.mark.parametrize("rows,cap", [((B, S), 80), ((B, 1), 1),
                                      ((6, 1), 3)],
                         ids=["prefill", "decode", "decode6"])
def test_moe_ffn_matches_jax(model, monkeypatch, rows, cap):
  jcfg, jparams, cfg, params, _, _ = model
  jp, p = _moe_layer(jparams, params)
  x = np.random.default_rng(4).standard_normal(
      (*rows, cfg.d_model)).astype(np.float32)
  y_j, aux_j, topi_j, tok_j, gate_j = _jax_moe(x, jp, jcfg, monkeypatch)
  xt = torch.from_numpy(x)
  tok, gate, topi, aux = moe.route(xt.reshape(-1, cfg.d_model), p["router"],
                                   cfg)
  assert moe.capacity(cfg, rows[0] * rows[1]) == cap == tok.shape[1]
  margin = _margins(xt, p, cfg)
  np.testing.assert_array_equal(topi.numpy(), topi_j,
                                err_msg=f"token-side margin {margin:.3e}")
  np.testing.assert_array_equal(tok.numpy(), tok_j,
                                err_msg=f"token-side margin {margin:.3e}")
  _close(gate, gate_j)
  y, aux2 = moe.moe_ffn(xt, p, cfg)
  _close(y, y_j)
  assert abs(float(aux) - aux_j) <= 1e-6 * abs(aux_j)
  assert float(aux2) == float(aux)


def test_moe_capacity_one_drops_the_lower_gated_row(model, monkeypatch):
  """Two rows at decode (capacity 1) whose top expert is the same: both
  packages keep the row with the higher gate there and drop the other,
  whose output then lacks that expert's term."""
  jcfg, jparams, cfg, params, _, _ = model
  jp, p = _moe_layer(jparams, params)
  rng = np.random.default_rng(5)
  a = rng.standard_normal(cfg.d_model)
  x = np.stack([a, a + 0.05 * rng.standard_normal(cfg.d_model)])[:, None]
  x = x.astype(np.float32)
  y_j, _, topi_j, tok_j, gate_j = _jax_moe(x, jp, jcfg, monkeypatch)
  xt = torch.from_numpy(x)
  tok, gate, topi, _ = moe.route(xt.reshape(2, -1), p["router"], cfg)
  e = int(topi[0, 0])
  assert int(topi[1, 0]) == e == topi_j[0, 0] == topi_j[1, 0]
  probs = torch.softmax(xt.reshape(2, -1) @ p["router"], -1)
  in_topk = torch.zeros_like(probs).scatter_(
      1, topi, torch.gather(probs, 1, topi)
      / torch.gather(probs, 1, topi).sum(-1, keepdim=True))
  keep = int(in_topk[:, e].argmax())
  assert float(in_topk[keep, e] - in_topk[1 - keep, e]) > 1e-4
  assert int(tok[e, 0]) == tok_j[e, 0] == keep
  y, _ = moe.moe_ffn(xt, p, cfg)
  _close(y, y_j)
  # Without the drop (room for every token) the dropped row changes; the
  # kept row's terms do not depend on the other row.
  roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
      cfg.moe, capacity_factor=4.0))
  y_all, _ = moe.moe_ffn(xt, p, roomy)
  assert not torch.allclose(y_all[1 - keep], y[1 - keep], atol=1e-3)


# -- prefill, steps and the loop ----------------------------------------------

def test_prefill_matches_jax(model):
  jcfg, jparams, cfg, params, prompt, _ = model
  lg_j, cache_j = _prefill_jax(jcfg, jparams, prompt)
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  assert set(cache) == set(cache_j) == {"k", "v", "conv_state", "ssd_state",
                                        "pos"}
  _close(lg, lg_j)
  for name in ("k", "v") + SSM_LEAVES:
    _close(cache[name], cache_j[name])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))


@pytest.fixture(scope="module")
def synopsis_cache(model):
  jcfg, jparams, _, _, prompt, _ = model
  _, cache = _prefill_jax(jcfg, jparams, prompt)
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3     # a partly filled ring
  return cache, jc


@pytest.mark.parametrize("mode,budget", [("synopsis", 0), ("synopsis", 1),
                                         ("synopsis", S // 16),
                                         ("exact", 0)])
def test_serve_step_matches_jax(model, synopsis_cache, mode, budget):
  jcfg, jparams, cfg, params, _, _ = model
  exact_cache, jc = synopsis_cache
  jc = jc if mode == "synopsis" else exact_cache
  tok = np.array([[5], [77]], np.int32)
  kw = dict(mode=mode, i_max=budget)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, impl="xla", **kw))(
      jparams, jc, jnp.asarray(tok))
  lg, st = make_serve_step(cfg, **kw)(params, _torch_cache(jc),
                                      torch.from_numpy(tok).long())
  _close(lg, lg_j)
  assert set(st) == set(st_j)
  for name in ("k_delta", "v_delta") + SSM_LEAVES:
    _close(st[name], st_j[name])
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))


def _jax_loop(jcfg, jparams, prompt, budgets, mode):
  """The JAX loop with fixed budgets (exact: budget 0, no build, only
  ``pos`` advancing): ids, every step's logits, the final cache.  Neither
  mode writes a step's SSM state back."""
  logits, cache = _prefill_jax(jcfg, jparams, prompt)
  if mode == "synopsis":
    cache = jskv.build(cache, jcfg, impl="xla")
  steps, out = {}, [np.asarray(logits)]
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  ids = [tok]
  for b in budgets:
    b = b if mode == "synopsis" else 0
    if b not in steps:
      steps[b] = jax.jit(j_make_serve_step(jcfg, mode=mode, i_max=b,
                                           impl="xla"))
    logits, st = steps[b](jparams, cache, tok)
    if mode == "synopsis":
      cache = jskv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if mode == "synopsis" and \
        int(cache["recent_len"][0]) >= jcfg.synopsis.recent:
      cache = jskv.absorb_recent(cache, jcfg, impl="xla")
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ids.append(tok)
    out.append(np.asarray(logits))
  return np.asarray(jnp.concatenate(ids, 1)), out, cache


@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_loop_matches_jax_every_step(model, mode):
  jcfg, jparams, cfg, params, prompt, basis = model
  want_ids, want_logits, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS,
                                            mode)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=len(BUDGETS),
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(),
                   budgets=BUDGETS if mode == "synopsis" else None,
                   mode=mode, pca_basis=torch.from_numpy(basis),
                   keep_logits=True, log=lambda _: None)
  assert out["absorbs"] == (1 if mode == "synopsis" else 0)
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  assert len(out["step_logits"]) == len(want_logits) == len(BUDGETS) + 1
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)
  # Both loops end on the prefill's SSM state: no step wrote it back.
  _, pre = _prefill_jax(jcfg, jparams, prompt)
  for name in SSM_LEAVES:
    np.testing.assert_array_equal(np.asarray(jcache[name]),
                                  np.asarray(pre[name]))
    _close(out["cache"][name], pre[name])
  if mode == "synopsis":
    for name in ("k", "k_syn", "counts", "recent_k", "recent_len"):
      assert tuple(out["cache"][name].shape) == jcache[name].shape, name
    _close(out["cache"]["k"], jcache["k"])


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("synopsis", [True, False])
def test_slot_pool_leaves_match_jax(model, synopsis):
  jcfg, _, cfg, _, _, _ = model
  want = jkvc.cache_struct(jcfg, 3, S, synopsis=synopsis)
  got = kvc.cache_struct(cfg, 3, S, synopsis=synopsis)
  assert list(got) == [k for k in want if k in got] and set(got) == set(want)
  for name, (shape, dt, axes) in got.items():
    assert shape == want[name][0], name
    assert axes == want[name][2], name
    assert str(dt).split(".")[-1] == np.dtype(want[name][1]).name, name
  assert set(SSM_LEAVES) <= set(kvc.PRIVATE_LEAVES)
  assert not set(SSM_LEAVES) & set(kvc.ARENA_LEAVES)


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


def _engines(model, n_slots, **kw):
  jcfg, jparams, cfg, params, _, basis = model
  jeng = JServingEngine(jcfg, JEngineConfig(n_slots=n_slots, impl="xla",
                                            **kw), params=jparams)
  eng = ServingEngine(cfg, EngineConfig(n_slots=n_slots, **kw),
                      params=params, pca_basis=torch.from_numpy(basis),
                      device="cpu")
  return jeng, eng


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("arm", [dict(policy="fixed", fixed_budget=1),
                                 dict(policy="basic")],
                         ids=["fixed1", "basic"])
def test_engine_matches_jax(model, arm, overlap):
  """Same weights, basis and requests: the same ids, every step's logits
  and the same SSM state in every lane at the end.  The rows of a step
  share the experts' capacity (1), so a lane's output depends on the
  others, the inactive ones included: both engines' steps read the same
  pool, the pre-admission one under overlap."""
  kw = dict(prompt_len=S, max_new_tokens=NEW, overlap_admission=overlap,
            **arm)
  jeng, eng = _engines(model, 2, **kw)
  jlog, log = [], []
  _record_jax(jeng, jlog)
  _record_port(eng, log)
  vocab = model[2].vocab
  jreqs = j_make_requests(ARRIVALS, S, NEW, vocab, seed=13)
  jeng.run(jreqs)
  reqs = make_requests(ARRIVALS, S, NEW, vocab, seed=13)
  eng.run(reqs)
  assert [ev[:3] for ev in eng.events] == [ev[:3] for ev in jeng.events]
  assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  # Overlap on: the later requests are admitted beside a step.
  walls = [r.admit_wall_ms > 0 for r in reqs]
  assert all(walls) if not overlap else walls.count(False) >= 1
  assert len(log) == len(jlog) >= NEW
  for got, want in zip(log, jlog):
    _close(got, want)
  for name in SSM_LEAVES:
    _close(eng.cache[name], jeng.cache[name])


def test_engine_ssm_state_advances_per_step(model):
  """The twin of the JAX ``test_hybrid_ssm_state_advances_per_step``: one
  and two decode steps leave different SSM states in the slot (the step
  writes its state back), each equal to the JAX engine's."""
  states = {}
  for n_new in (1, 2):
    kw = dict(prompt_len=S, max_new_tokens=n_new, policy="fixed",
              fixed_budget=1)
    jeng, eng = _engines(model, 1, **kw)
    jeng.run(j_make_requests([0.0], S, n_new, model[2].vocab, seed=3))
    eng.run(make_requests([0.0], S, n_new, model[2].vocab, seed=3))
    for name in SSM_LEAVES:
      _close(eng.cache[name], jeng.cache[name])
    states[n_new] = eng.cache["ssd_state"].clone()
  assert not torch.allclose(states[1], states[2])


# -- the corpus cache ---------------------------------------------------------

def test_supports_delta_is_false_as_jax(model):
  jcfg, _, cfg, params, _, _ = model
  assert jccache.supports_delta(jcfg) is ccache.supports_delta(cfg) is False
  eng = ServingEngine(cfg, EngineConfig(n_slots=2, prompt_len=S,
                                        max_new_tokens=2),
                      params=params, device="cpu")
  assert not eng._delta_ok and eng._extend is None
  with pytest.raises(NotImplementedError, match="mamba"):
    from repro_torch.serve.prefill import make_extend_step
    make_extend_step(cfg)


def test_corpus_hit_restores_the_ssm_state_and_gives_the_miss_ids(model):
  """One corpus three times, one slot: the first admission misses and
  publishes its arena (the SSM state of its prefill among the leaves),
  the others hit and write that state into the lane with the rest, and
  all three give the ids of the same trace with the cache off, which the
  JAX engine gives too."""
  _, _, cfg, _, _, _ = model
  kw = dict(prompt_len=S, max_new_tokens=NEW, policy="fixed",
            fixed_budget=1)
  jeng, off = _engines(model, 1, **kw)
  _, on = _engines(model, 1, cache=CacheConfig(capacity=4), **kw)
  prompt = np.random.default_rng(7).integers(0, cfg.vocab, S).astype(
      np.int32)

  def trace(mk):
    reqs = mk([0.0, 0.0, 0.0], S, NEW, cfg.vocab, seed=0)
    for r in reqs:
      r.prompt = prompt
    return reqs
  ids = {}
  for name, eng, mk in (("jax", jeng, j_make_requests),
                        ("off", off, make_requests),
                        ("on", on, make_requests)):
    reqs = trace(mk)
    eng.run(reqs)
    ids[name] = [r.tokens for r in reqs]
  assert ids["on"] == ids["off"] == ids["jax"]
  assert ids["on"][0] == ids["on"][1] == ids["on"][2]
  s = on.summary()
  assert (s["cache_hits"], s["cache_misses"], s["prefills"]) == (2, 1, 1)
  (entry,) = on.corpus_cache.entries.values()
  _, pre = make_prefill_step(cfg)(on.params, torch.from_numpy(prompt)[None]
                                  .long())
  for name in SSM_LEAVES:
    assert torch.equal(entry.arena[name], pre[name])

"""The port's continuous-batching engine against the JAX package's, on the
CPU (the programs run eagerly there; the card captures them as CUDA
graphs, ``tests/test_torch_card.py``).

* Token ids: the same JAX weights (``bridge.params_from_numpy``), the same
  PCA basis, the same requests from ``make_requests``' numpy seed, SMOKE
  llama3-8b in f32, n_slots 2, prompt 32 / 64: the port's engine generates
  the ids of ``repro.serve.engine.ServingEngine(impl="xla")`` under
  ``fixed`` (budgets 0 and 1) and ``basic``, with admission overlap on and
  off.  Ids are compared exactly.
* The engine's parts: ``append_recent_slots`` (exact: it moves values),
  the slot pool's leaves, shapes and dtypes (quantized included) and
  ``write_slot`` (exact), ``poisson_arrivals`` (exact),
  ``DeadlineBudgetPolicy`` and the three predictors on one observation
  sequence (within 1e-12: the same float64 arithmetic), the simulator's
  copy (exact: the same numpy draws), and ``summary()``'s keys.
* A step backend other than the cluster tier's (the fleet tier, ROADMAP
  A.7b) raises, and so do ``--fleet`` / ``--autoscale`` on the command
  line; the cluster tier (``--cluster``, the simulator's ``faults``), the
  corpus cache, admission and the contracts, ported since, are taken
  (``tests/test_torch_cluster.py``, ``tests/test_torch_resilience.py``,
  ``tests/test_torch_contracts.py`` and ``tests/test_torch_corpus_cache.py``
  hold them against the JAX package).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.control import DeadlineBudgetPolicy as JPolicy
from repro.control import make_predictor as j_make_predictor
from repro.control.predictors import TailTracker as JTailTracker
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import kv_cache as jkvc
from repro.serve import synopsis_kv as jskv
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import MeasuredStepBackend as JMeasured
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro.serving import workload as jworkload
from repro.serving.service import ScatterGatherService as JService
from repro.serving.service import ServiceConfig as JServiceConfig
from repro.serving.service import _default_concentration as j_concentration
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.control import (AdmissionConfig, DeadlineBudgetPolicy,
                                 TailTracker, make_predictor)
from repro_torch.launch import serve as launch
from repro_torch.launch.serve import apply_quant
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import synopsis_kv as skv
from repro_torch.serve.corpus_cache import CacheConfig
from repro_torch.serve.engine import (EngineConfig, MeasuredStepBackend,
                                      ServingEngine, make_requests,
                                      run_open_loop)
from repro_torch.serve.resilience import parse_fault_spec
from repro_torch.serving import workload
from repro_torch.serving.service import (ScatterGatherService, ServiceConfig,
                                         _default_concentration)

N_SLOTS, NEW = 2, 4
# Request 0 is admitted alone (serially); every later one arrives while a
# lane decodes, so it is admitted beside the step when overlap is on.
# Ids do not depend on the schedule: under fixed and basic each request's
# budgets are fixed and the lanes do not interact.
ARRIVALS = [0.0, 1.0, 2.0, 3.0, 4.0]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
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
  # The JAX build's PCA start (its default), handed to the port.
  basis = torch.from_numpy(np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32)))
  return jcfg, jparams, cfg, params, basis


def _port_engine(llama, **kw):
  _, _, cfg, params, basis = llama
  return ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, **kw),
                       params=params, pca_basis=basis, device="cpu")


def _jax_engine(llama, **kw):
  jcfg, jparams, _, _, _ = llama
  return JServingEngine(jcfg, JEngineConfig(n_slots=N_SLOTS, impl="xla",
                                            **kw), params=jparams)


def _ids(reqs):
  return [r.tokens for r in sorted(reqs, key=lambda r: r.rid)]


# -- token ids against the JAX engine -----------------------------------------

ARMS = {"fixed0": dict(policy="fixed", fixed_budget=0),
        "fixed1": dict(policy="fixed", fixed_budget=1),
        "basic": dict(policy="basic")}


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "serial"])
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("prompt", [32, 64])
def test_engine_generates_jax_token_ids(llama, arm, overlap, prompt):
  """Same weights, basis and requests: the same ids, every request, every
  step.  With overlap on, both steps read the pre-admission pool (the
  port launches the admissions between the step's graph and the
  append's)."""
  kw = dict(prompt_len=prompt, max_new_tokens=NEW, overlap_admission=overlap,
            **ARMS[arm])
  jreqs = j_make_requests(ARRIVALS, prompt, NEW, llama[2].vocab, seed=13)
  _jax_engine(llama, **kw).run(jreqs)
  reqs = make_requests(ARRIVALS, prompt, NEW, llama[2].vocab, seed=13)
  eng = _port_engine(llama, **kw)
  eng.run(reqs)
  assert _ids(reqs) == _ids(jreqs)
  assert [r.budgets for r in reqs] == [r.budgets for r in jreqs]
  assert all(len(r.tokens) == NEW + 1 for r in reqs)
  # The engine's own dispatch: serial admissions where no lane decodes,
  # overlapped ones where one does.
  walls = [r.admit_wall_ms > 0 for r in reqs]
  assert all(walls) if not overlap else walls.count(False) >= 1


def test_engine_summary_keys_match_jax(llama):
  kw = dict(prompt_len=32, max_new_tokens=2, policy="fixed", fixed_budget=1)
  js = _jax_engine(llama, **kw).run(
      j_make_requests(ARRIVALS, 32, 2, llama[2].vocab, seed=3))
  eng = _port_engine(llama, **kw)
  s = eng.run(make_requests(ARRIVALS, 32, 2, llama[2].vocab, seed=3))
  assert set(s) == set(js)
  for k in ("n", "served_n", "prefills", "shed_admission_n", "mean_budget",
            "accuracy_loss_pct", "acc_p50"):
    assert s[k] == js[k], k


def test_slot_admit_retire_invariants(llama):
  """Mirrors tests/test_engine.py: every request admitted once into a free
  lane, retired from it, never more residents than lanes; the late
  arrival finds an idle engine."""
  eng = _port_engine(llama, prompt_len=64, max_new_tokens=NEW,
                     deadline_ms=60.0, policy="accuracytrader")
  reqs = make_requests([0.0, 0.0, 0.0, 2.0, 2.0, 250.0], 64, NEW,
                       llama[2].vocab, seed=7)
  eng.run(reqs)
  assert len(eng.completed) == len(reqs)
  admits = {r.rid: [] for r in reqs}
  occupied = {}
  for kind, rid, slot, t in eng.events:
    assert 0 <= slot < N_SLOTS
    if kind == "admit":
      assert slot not in occupied, "admit into an occupied slot"
      occupied[slot] = rid
      admits[rid].append(t)
    else:
      assert occupied.get(slot) == rid, "retire of a non-resident request"
      del occupied[slot]
    assert len(occupied) <= N_SLOTS
  assert not occupied, "every admitted request retires"
  for r in reqs:
    assert len(admits[r.rid]) == 1
    assert r.admit_ms >= r.arrival_ms
    assert r.finish_ms > r.admit_ms
    assert len(r.tokens) == NEW + 1 and len(r.budgets) == NEW
    assert all(b in eng.buckets for b in r.budgets)
    assert 0.0 <= r.accuracy <= 1.0
  late = next(r for r in reqs if r.arrival_ms == 250.0)
  assert late.queue_ms < 50.0
  # reset() zeroes the pool in place: the same tensors, all zero.
  ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
  eng.reset()
  assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
  assert all(not v.any() for v in eng.cache.values())


def test_partial_drops_at_deadline_and_frees_lane(llama):
  eng = _port_engine(llama, prompt_len=32, max_new_tokens=NEW,
                     deadline_ms=1.0, policy="partial")
  reqs = make_requests([0.0, 0.0, 0.0], 32, NEW, llama[2].vocab, seed=7)
  eng.run(reqs)
  assert len(eng.completed) == len(reqs)
  for r in reqs:
    assert r.accuracy == 0.0 and r.dropped
    assert len(r.tokens) < NEW + 1


def test_measured_backend_feeds_the_simulator(llama):
  eng = _port_engine(llama, prompt_len=64, max_new_tokens=2)
  backend = MeasuredStepBackend(eng, iters=1, full_items=100)
  assert set(backend.table) == set(eng.buckets) == {0, 1, 2, 4}
  assert all(v > 0 for v in backend.table.values())
  assert backend.step_ms(200) == backend.table[4]
  assert backend.step_ms(0) == backend.table[0]
  assert backend.step_ms(50) == backend.table[2]
  s = run_open_loop(eng, rate_per_s=30.0, duration_s=0.2, seed=5)
  assert s["n"] == len(eng.completed) > 0


# -- the parts ---------------------------------------------------------------

def test_append_recent_slots_matches_jax_on_per_slot_positions():
  nb, na, B, H, R, D = 2, 1, 4, 2, 4, 3
  rng = np.random.default_rng(0)
  ring_k = rng.standard_normal((nb, na, B, H, R, D)).astype(np.float32)
  ring_v = rng.standard_normal((nb, na, B, H, R, D)).astype(np.float32)
  rl = np.array([0, 2, 3, 4], np.int32)              # lane 3: ring full
  jc = {"recent_k": jnp.asarray(ring_k), "recent_v": jnp.asarray(ring_v),
        "recent_len": jnp.asarray(rl)}
  tc = {"recent_k": torch.from_numpy(ring_k.copy()),
        "recent_v": torch.from_numpy(ring_v.copy()),
        "recent_len": torch.from_numpy(rl.copy())}
  for step, active in enumerate(([True, False, True, True],
                                 [True, True, True, False],
                                 [False, False, True, True])):
    kd = rng.standard_normal((nb, na, B, H, 1, D)).astype(np.float32)
    vd = rng.standard_normal((nb, na, B, H, 1, D)).astype(np.float32)
    jc = jskv.append_recent_slots(jc, jnp.asarray(kd), jnp.asarray(vd),
                                  jnp.asarray(active))
    out = skv.append_recent_slots(tc, torch.from_numpy(kd),
                                  torch.from_numpy(vd), torch.tensor(active))
    assert out is tc                                   # in place
    for name in ("recent_k", "recent_v", "recent_len"):
      np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                    err_msg=f"{name} after step {step}")


QUANTS = ["none", "int8", "fp8", "int8+kv", "fp8+kv"]


def _bits(t):
  """One-byte codes as bytes (torch's CPU ops take no fp8)."""
  return t.view(torch.uint8) if t.element_size() == 1 else t


def _torch_dtype_name(dt):
  return {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int32: "int32",
          torch.float8_e4m3fn: "float8_e4m3fn"}[dt]


@pytest.mark.parametrize("quant", QUANTS)
def test_slot_pool_leaves_shapes_and_dtypes_match_jax(quant):
  jcfg = j_get_config("llama3-8b", smoke=True)
  if quant != "none":
    jcfg = dataclasses.replace(jcfg, synopsis=dataclasses.replace(
        jcfg.synopsis, quant=quant))
  cfg = apply_quant(get_config("llama3-8b", smoke=True), quant)
  for synopsis in (True, False):
    want = jkvc.cache_struct(jcfg, 3, 64, synopsis=synopsis)
    got = kvc.cache_struct(cfg, 3, 64, synopsis=synopsis)
    assert list(got) == list(want)
    for name, (shape, dt, axes) in got.items():
      wshape, wdt, waxes = want[name]
      assert shape == wshape and axes == waxes, name
      assert _torch_dtype_name(dt) == np.dtype(wdt).name, name
    assert kvc.slot_batch_axes(cfg, 3, 64, synopsis=synopsis) == \
        jkvc.slot_batch_axes(jcfg, 3, 64, synopsis=synopsis)
  pool = kvc.zeros_cache(cfg, 3, 64, synopsis=True, device="cpu")
  jpool = jkvc.zeros_cache(jcfg, 3, 64, synopsis=True)
  for name, t in pool.items():
    assert tuple(t.shape) == jpool[name].shape and not _bits(t).any(), name


@pytest.mark.parametrize("quant", QUANTS)
def test_write_slot_copies_one_lane_in_place(llama, quant):
  """A built B=1 synopsis cache into lane 1 of a 3-lane pool: lane 1 holds
  it (cast to the pool's dtypes), lanes 0 and 2 stay zero, no leaf is
  reallocated."""
  _, _, cfg, params, basis = llama
  qcfg = apply_quant(cfg, quant)
  from repro_torch.serve.prefill import make_prefill_step
  prompt = torch.from_numpy(np.random.default_rng(1).integers(
      0, cfg.vocab, (1, 32)))
  _, cache1 = make_prefill_step(qcfg)(params, prompt)
  sub = skv.build(cache1, qcfg, basis=basis)
  pool = kvc.zeros_cache(qcfg, 3, 32, synopsis=True, device="cpu")
  ptrs = {k: v.data_ptr() for k, v in pool.items()}
  bx = kvc.slot_batch_axes(qcfg, 3, 32, synopsis=True)
  assert kvc.write_slot(pool, sub, 1, bx) is pool
  assert {k: v.data_ptr() for k, v in pool.items()} == ptrs
  assert set(sub) == set(pool)
  for name, t in pool.items():
    assert torch.equal(_bits(t.narrow(bx[name], 1, 1)),
                       _bits(sub[name].to(t.dtype))), name
    for other in (0, 2):
      assert not _bits(t.narrow(bx[name], other, 1)).any(), name


@pytest.mark.parametrize("rate,duration,seed", [(20.0, 1.0, 0),
                                                (3.5, 3.0, 0),
                                                (90.0, 0.5, 7)])
def test_poisson_arrivals_match_jax(rate, duration, seed):
  got = workload.poisson_arrivals(rate, duration, seed=seed)
  want = jworkload.poisson_arrivals(rate, duration, seed=seed)
  np.testing.assert_array_equal(got, want)
  assert workload.CF_RATES == jworkload.CF_RATES
  assert [workload.hour_rate(h) for h in range(25)] == \
      [jworkload.hour_rate(h) for h in range(25)]


def _observations():
  rng = np.random.default_rng(3)
  buckets = (0, 1, 2, 4, 8, 16)
  return [(int(rng.choice(buckets)), float(rng.lognormal(2.0, 0.5)))
          for _ in range(60)], buckets


@pytest.mark.parametrize("spec", ["affine", "ewma", "quantile",
                                  "quantile:95"])
def test_predictors_match_jax(spec):
  obs, buckets = _observations()
  kw = {"base": 2.0, "slope": 0.5, "alpha": 0.1} if spec == "affine" else {}
  got, want = make_predictor(spec, **kw), j_make_predictor(spec, **kw)
  for b, lat in obs:
    got.observe(b, lat)
    want.observe(b, lat)
    for q in (*buckets, 3, 32):
      assert got.predict(q) == pytest.approx(want.predict(q), abs=1e-12)
  assert got.observed_buckets() == want.observed_buckets()
  assert got.table().keys() == want.table().keys()


@pytest.mark.parametrize("policy", ["accuracytrader", "basic", "partial",
                                    "fixed"])
@pytest.mark.parametrize("spec", ["affine", "ewma", "quantile:90"])
def test_deadline_budget_policy_matches_jax(policy, spec):
  obs, buckets = _observations()
  kw = dict(policy=policy, buckets=buckets, i_max_cap=16, fixed_budget=4)
  got = DeadlineBudgetPolicy(predictor=make_predictor(spec), **kw)
  want = JPolicy(predictor=j_make_predictor(spec), **kw)
  for i, (b, lat) in enumerate(obs):
    for deadline in (0.0, 3.0, 7.5, 12.0, 40.0, 1e3):
      assert got.budget_for(deadline, queue_delay=i % 3) == \
          want.budget_for(deadline, queue_delay=i % 3)
    assert got.budget_for_contract(9.0) == want.budget_for_contract(9.0)
    got.observe(b, lat)
    want.observe(b, lat)


def test_tail_tracker_and_concentration_match_jax():
  rng = np.random.default_rng(4)
  got, want = TailTracker(), JTailTracker()
  for x in rng.lognormal(3.0, 1.0, 200):
    got.observe(float(x))
    want.observe(float(x))
  assert got.summary() == want.summary()
  assert TailTracker().summary() == JTailTracker().summary()
  for f in np.linspace(0.0, 1.0, 23):
    assert _default_concentration(f) == j_concentration(f)


class _Table:
  """A fixed per-bucket step table on both sides of the simulator."""
  buckets, M = (0, 1, 2, 4, 8), 8
  full_items = 100
  table = {0: 9.5, 1: 10.25, 2: 11.0, 4: 12.5, 8: 15.75}
  step_ms = MeasuredStepBackend.step_ms
  step_ms_j = JMeasured.step_ms


@pytest.mark.parametrize("technique,skew,shed",
                         [("accuracytrader", 0.0, False),
                          ("accuracytrader", 1.1, True),
                          ("basic", 0.0, False), ("partial", 0.8, False),
                          ("reissue", 0.0, False)])
def test_simulator_copy_matches_jax(technique, skew, shed):
  backend = _Table()
  kw = dict(n_components=12, technique=technique, deadline_ms=20.0,
            skew=skew, shed=shed, seed=2)
  got = ScatterGatherService(ServiceConfig(**kw), step_backend=backend)

  class JTable(_Table):
    step_ms = _Table.step_ms_j
  want = JService(JServiceConfig(**kw), step_backend=JTable())
  for rate, dur in ((40.0, 0.5), (80.0, 0.5)):
    assert got.run_open_loop(rate, dur) == want.run_open_loop(rate, dur)


# -- the off forms -------------------------------------------------------------

@pytest.mark.parametrize("field,value,item", [
    ("cache", CacheConfig(capacity=2), "A.5"),
    ("admission", AdmissionConfig(), "A.4"),
    ("contract", "error_bounded", "A.3"),
    ("contract", "deadline_with_bound", "A.3"), ("backend", object(), "A.7")])
def test_engine_refuses_what_it_has_not_ported(llama, field, value, item):
  """A step backend that is neither the cluster tier's nor the fleet
  tier's (A.7a-b, ported since) raises; the corpus cache (A.5), admission
  (A.4) and the contracts (A.3), ported since, build an engine that
  serves.  The deadline is one no step misses: predictive shedding
  follows the host clock, and at the default 80 ms a loaded host would
  shed a request."""
  _, _, cfg, params, _ = llama
  kw = dict(prompt_len=32, max_new_tokens=2, deadline_ms=1e6)
  extra = {}
  if field == "backend":
    extra["backend"] = value
  else:
    kw[field] = value
  if item == "A.7":
    with pytest.raises(NotImplementedError,
                       match="FleetStepBackend\\) are ported"):
      ServingEngine(cfg, EngineConfig(**kw), params=params, device="cpu",
                    **extra)
    return
  eng = ServingEngine(cfg, EngineConfig(**kw), params=params, device="cpu")
  s = eng.run(make_requests([0.0, 1.0], 32, 2, cfg.vocab, seed=1))
  assert s["n"] == 2 and s["served_n"] == 2


def test_engine_is_freed_at_del(llama):
  """No reference cycle: the last reference gone, the engine, its pool
  and its programs go at once, without the cyclic collector (on the card
  a collection could release graphs inside another engine's capture)."""
  import gc
  import weakref
  _, _, cfg, params, _ = llama
  gc.disable()
  try:
    eng = ServingEngine(cfg, EngineConfig(
        prompt_len=32, max_new_tokens=2, contract="error_bounded",
        admission=AdmissionConfig(order="slack"),
        cache=CacheConfig(capacity=2)), params=params, device="cpu")
    eng.run(make_requests([0.0, 1.0], 32, 2, cfg.vocab, seed=1))
    ref, pool = weakref.ref(eng), weakref.ref(eng.cache["k"])
    del eng
    assert ref() is None and pool() is None
  finally:
    gc.enable()


def test_engine_rejects_bad_configs(llama):
  _, _, cfg, params, _ = llama
  for kw, match in ((dict(prompt_len=40), "cluster_size"),
                    (dict(prompt_len=32, max_new_tokens=17), "recent"),
                    (dict(prompt_len=32, policy="reissue"), "policy"),
                    (dict(prompt_len=32, contract="eps"), "contract"),
                    (dict(prompt_len=32, buckets=(0, 3)), "outside")):
    with pytest.raises(ValueError, match=match):
      ServingEngine(cfg, EngineConfig(**kw), params=params, device="cpu")
  with pytest.raises(ValueError, match="unknown predictor"):
    make_predictor("median")
  # Injected faults, ported since, serve: a crashed component's shard
  # falls back to its stage-1 synopsis (tests/test_torch_resilience.py
  # holds the round trip against the JAX simulator).
  svc = ScatterGatherService(ServiceConfig(
      n_components=4, faults=parse_fault_spec("crash=1@0,seed=2")))
  s = svc.run_open_loop(20.0, 0.5)
  assert s["n"] > 0 and s["availability_pct"] == 100.0


def test_engine_refuses_without_cuda(monkeypatch, llama):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  _, _, cfg, params, _ = llama
  with pytest.raises(RuntimeError, match="CUDA"):
    ServingEngine(cfg, EngineConfig(prompt_len=32, max_new_tokens=2),
                  params=params)


@pytest.mark.parametrize("flags,item", [
    (["--cluster", "4"], "A.7"), (["--fleet"], "A.7"),
    (["--admission", "edf"], "A.4"), (["--cache-capacity", "8"], "A.5"),
    (["--contract", "error_bounded"], "A.3"), (["--mode", "exact"], "exact"),
    (["--budget", "1"], "budget"), (["--autoscale"], "A.7")])
def test_engine_cli_refuses_unported_flags(capsys, monkeypatch, flags, item):
  """What the engine does not take exits with its reason; the flags of
  A.3-A.5, ``--cluster`` (A.7a) and the fleet tier's (A.7b), ported since,
  reach the engine, ``--cluster`` without ``--engine`` too; ``--fleet``
  and ``--autoscale`` still exit without ``--cluster N``, naming it."""
  seen = []
  monkeypatch.setattr(launch, "engine_main",
                      lambda args, device: seen.append(args))
  if item in ("A.3", "A.4", "A.5"):
    launch.main(["--engine", "--device", "cpu", *flags])
    args, = seen
    assert (args.admission, args.cache_capacity, args.contract) != \
        ("off", 0, "deadline")
    return
  if flags[0] == "--cluster":
    launch.main(["--engine", "--device", "cpu", *flags])
    launch.main(["--device", "cpu", *flags])
    assert [a.cluster for a in seen] == [4, 4]
    return
  with pytest.raises(SystemExit) as e:
    launch.main(["--engine", "--device", "cpu", *flags])
  assert e.value.code != 0 and not seen
  err = capsys.readouterr().err
  if item == "A.7":
    assert "--cluster N" in err
    launch.main(["--device", "cpu", "--cluster", "4", *flags])
    args, = seen
    assert args.cluster == 4 and (args.fleet or args.autoscale)
    return
  assert item in err


def test_engine_cli_on_cpu(tmp_path, capsys):
  out = launch.main(["--engine", "--device", "cpu", "--prompt-len", "32",
                     "--tokens", "2", "--trace", "sogou_hourly", "--hours",
                     "3,21", "--rate-scale", "0.2", "--duration", "0.5",
                     "--predictor", "quantile:90", "--json",
                     str(tmp_path / "e.json")])
  assert out["device"] == "cpu" and set(out["results"]) == {"hour03",
                                                             "hour21"}
  assert out["results"]["hour21"]["rate_per_s"] == pytest.approx(18.0)
  assert (tmp_path / "e.json").is_file()
  assert "[hour21]" in capsys.readouterr().out


def test_engine_cli_contract_admission_cache_on_cpu(tmp_path, capsys):
  out = launch.main(["--engine", "--device", "cpu", "--prompt-len", "32",
                     "--tokens", "2", "--trace", "sogou_hourly", "--hours",
                     "21", "--rate-scale", "0.2", "--duration", "0.5",
                     "--contract", "deadline_with_bound", "--admission",
                     "edf", "--slo-classes", "interactive:500,batch:2000",
                     "--cache-capacity", "4", "--zipf-corpora", "2",
                     "--json", str(tmp_path / "e.json")])
  r = out["results"]["hour21"]
  assert set(r["classes"]) == {"interactive", "batch"}
  assert r["cache_hits"] + r["cache_misses"] == r["served_n"]
  assert 0.0 <= r["band_cover_pct"] <= 100.0 and r["pred_loss_mean"] >= 0.0
  assert "band_cov=" in capsys.readouterr().out
  assert (tmp_path / "e.json").is_file()

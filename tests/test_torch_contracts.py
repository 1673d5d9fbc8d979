"""The port's serving contracts and queue-aware admission against the JAX
package's, on the CPU.

* ``coverage_profile`` (torch, on the step's device) against the JAX one
  on the same scores and counts, NEG_INF slots and zero counts included:
  within 1e-6 (f32 sums in another order).
* The estimator's host half (``raw_loss``, ``spread_from_profile``,
  ``fit``, ``predict``, ``band``, ``bucket_for_epsilon``, ``spearman``,
  ``isotonic_fit``): the same float64 numpy arithmetic, so equal.
* ``DeadlineBudgetPolicy``'s contracts: a mirror of the JAX package's
  ``test_policy_contract_dispatch``, and the same (granted, base) as the
  JAX policy on recorded profiles.
* Admission: ``AdmissionPolicy``'s order keys (fifo / edf / slack),
  ``TokenBucket.take``, ``predicted_dead`` and ``parse_slo_classes`` on
  recorded ``(now_ms, demand)`` inputs: equal.  Shedding depends on the
  host clock, so it is held on these recorded inputs, not by comparing
  whole engines.
* The engine (SMOKE llama3-8b in f32, the same weights, PCA start and
  requests on both sides): under ``deadline_with_bound`` the port's and
  the JAX engine's ids are equal and every step's ``est_raw`` agrees
  within 1e-5; ``error_bounded`` at ε = 0 grants M on every step and
  gives the ``deadline`` engine's ids; ``granted + freed == base`` on
  every step under ``error_bounded`` with an estimator fit from recorded
  pairs; EDF with two SLO classes, deadlines loose enough that nothing is
  shed, gives the JAX engine's admission order and ids.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.control import AccuracyEstimator as JEstimator
from repro.control import AdmissionConfig as JAdmissionConfig
from repro.control import AdmissionPolicy as JAdmissionPolicy
from repro.control import DeadlineBudgetPolicy as JPolicy
from repro.control import SLOClass as JSLOClass
from repro.control import TokenBucket as JTokenBucket
from repro.control import estimator as jest
from repro.control import make_predictor as j_make_predictor
from repro.control import parse_slo_classes as j_parse_slo_classes
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.engine import make_requests as j_make_requests
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.control import (AccuracyEstimator, AdmissionConfig,
                                 AdmissionPolicy, DeadlineBudgetPolicy,
                                 SLOClass, TokenBucket, calibration_pairs,
                                 coverage_profile, isotonic_fit,
                                 make_predictor, parse_slo_classes, spearman)
from repro_torch.serve.engine import (EngineConfig, EngineRequest,
                                      ServingEngine, make_requests)

NEG_INF = -1e30
N_SLOTS, NEW, PROMPT = 2, 4, 32
ARRIVALS = [0.0, 1.0, 2.0, 3.0, 4.0]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- coverage profile ------------------------------------------------------

def _scores_counts(seed, B=3, H=2, M=9):
  rng = np.random.default_rng(seed)
  scores = (rng.standard_normal((B, H, M)) * 4.0).astype(np.float32)
  counts = rng.integers(0, 20, (B, M)).astype(np.float32)
  scores[0, :, -2:] = NEG_INF                # invalid slots
  counts[1, :3] = 0.0                        # empty clusters
  scores[2, 1, :] = NEG_INF                  # an all-invalid head
  scores[1, 0, 4] = scores[1, 0, 5]          # a tie
  return scores, counts


@pytest.mark.parametrize("rank", ["score", "mass"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coverage_profile_matches_jax(seed, rank):
  scores, counts = _scores_counts(seed)
  got = coverage_profile(torch.from_numpy(scores), torch.from_numpy(counts),
                         rank=rank)
  want = np.asarray(jest.coverage_profile(jnp.asarray(scores),
                                          jnp.asarray(counts), rank=rank))
  assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the estimator's host half -------------------------------------------------

def _profiles(n, M, seed):
  rng = np.random.default_rng(seed)
  inc = rng.exponential(1.0, (n, M)) ** 3
  cum = np.cumsum(inc, axis=1) / inc.sum(axis=1, keepdims=True)
  return np.concatenate([np.zeros((n, 1)), cum], axis=1)


def _pairs(seed, n):
  rng = np.random.default_rng(seed)
  raws = rng.uniform(0.0, 0.07, n)
  meas = np.clip(0.6 * raws + rng.normal(0.0, 0.004, n), 0.0, 1.0)
  return raws, meas


@pytest.mark.parametrize("n_pairs", [0, 5, 12, 40])
def test_estimator_matches_jax(n_pairs):
  got, want = AccuracyEstimator(floor=0.07), JEstimator(floor=0.07)
  if n_pairs:
    raws, meas = _pairs(n_pairs, n_pairs)
    assert got.fit(raws, meas) == want.fit(raws, meas)
    assert got.calibrated and want.calibrated
  buckets = (0, 1, 2, 4, 8, 16)
  for prof in _profiles(12, 16, seed=n_pairs):
    for b in (0, 1, 3, 8, 16, 40):
      assert got.raw_loss(prof, b) == want.raw_loss(prof, b)
      assert got.spread_from_profile(prof, b) == \
          want.spread_from_profile(prof, b)
    raw = got.raw_loss(prof, 2)
    assert got.predict(raw) == want.predict(raw)
    assert got.band(raw, spread=0.003) == want.band(raw, spread=0.003)
    for eps in (-1.0, 0.0, 0.001, 0.01, 0.03, 0.07):
      assert got.bucket_for_epsilon(prof, buckets, eps) == \
          want.bucket_for_epsilon(prof, buckets, eps)
  xs = np.array([0.1, 0.3, 0.3, 0.2, 0.9])
  np.testing.assert_array_equal(got.predict(xs), want.predict(xs))


def test_calibration_helpers_match_jax():
  rng = np.random.default_rng(5)
  x = np.round(rng.uniform(0, 1, 30), 1)          # ties included
  y = x + rng.normal(0, 0.2, 30)
  kx, ky = isotonic_fit(x, y)
  jx, jy = jest.isotonic_fit(x, y)
  np.testing.assert_array_equal(kx, jx)
  np.testing.assert_array_equal(ky, jy)
  assert spearman(x, y) == jest.spearman(x, y)
  reqs = [EngineRequest(rid=i, arrival_ms=0.0, prompt=np.zeros(1, np.int32),
                        max_new_tokens=1, est_raw=[0.01 * i, 0.02],
                        accuracy=0.9 + 0.01 * i, dropped=i == 2,
                        shed_admission=i == 3) for i in range(5)]
  assert calibration_pairs(reqs) == jest.calibration_pairs(reqs)
  assert len(calibration_pairs(reqs)[0]) == 3


# -- the contracts in the policy ---------------------------------------------

def test_policy_contract_dispatch():
  """Mirrors the JAX package's test of the same name."""
  est = AccuracyEstimator(floor=0.07)
  pol = DeadlineBudgetPolicy(policy="basic", buckets=(0, 1, 2, 4),
                             i_max_cap=4, contract="error_bounded",
                             epsilon=0.07, estimator=est)
  prof = np.linspace(0.0, 1.0, 5)
  granted, base = pol.budget_for_contract(50.0, profiles=[prof])
  assert base == 4 and granted == 0          # ε = floor: stage 1 alone
  assert pol.budget_for_contract(50.0) == (4, 4)
  pol2 = DeadlineBudgetPolicy(policy="basic", buckets=(0, 1, 2, 4),
                              i_max_cap=4)
  assert pol2.budget_for_contract(50.0, profiles=[prof]) == (4, 4)
  with pytest.raises(ValueError, match="contract"):
    DeadlineBudgetPolicy(policy="basic", buckets=(0,), i_max_cap=0,
                         contract="nope")
  with pytest.raises(ValueError, match="estimator"):
    DeadlineBudgetPolicy(policy="basic", buckets=(0,), i_max_cap=0,
                         contract="error_bounded")


@pytest.mark.parametrize("contract", ["deadline", "error_bounded",
                                      "deadline_with_bound"])
@pytest.mark.parametrize("policy", ["accuracytrader", "basic", "fixed"])
def test_budget_for_contract_matches_jax(contract, policy):
  raws, meas = _pairs(3, 24)
  est, jest_ = AccuracyEstimator(floor=0.07), JEstimator(floor=0.07)
  est.fit(raws, meas)
  jest_.fit(raws, meas)
  buckets = (0, 1, 2, 4, 8, 16)
  kw = dict(policy=policy, buckets=buckets, i_max_cap=16, fixed_budget=4,
            contract=contract, epsilon=0.01)
  got = DeadlineBudgetPolicy(predictor=make_predictor("affine"),
                             estimator=est, **kw)
  want = JPolicy(predictor=j_make_predictor("affine"), estimator=jest_,
                 **kw)
  profs = _profiles(9, 16, seed=4)
  for i, deadline in enumerate((0.0, 3.0, 7.5, 12.0, 40.0, 1e3)):
    for j in range(0, 9, 3):
      p = list(profs[j:j + 1 + i % 3])
      assert got.budget_for_contract(deadline, profiles=p) == \
          want.budget_for_contract(deadline, profiles=p)
    got.observe(buckets[i], 2.0 + i)
    want.observe(buckets[i], 2.0 + i)


# -- admission on recorded inputs ----------------------------------------------

CLASSES = "interactive:80@60/2,batch:400"


def _admission_pair(order, shed=True, margin=1.0):
  demand = {}
  kw = dict(order=order, shed=shed, shed_margin=margin)
  got = AdmissionPolicy(AdmissionConfig(
      classes=parse_slo_classes(CLASSES), **kw), 120.0,
      lambda r: demand[r.rid])
  want = JAdmissionPolicy(JAdmissionConfig(
      classes=j_parse_slo_classes(CLASSES), **kw), 120.0,
      lambda r: demand[r.rid])
  return got, want, demand


@pytest.mark.parametrize("order", ["fifo", "edf", "slack"])
@pytest.mark.parametrize("shed,margin", [(True, 1.0), (True, 1.5),
                                         (False, 1.0)])
def test_admission_decisions_match_jax(order, shed, margin):
  """The same requests, the same recorded (now_ms, demand) sequence: the
  same rate gates, sheds and order."""
  got, want, demand = _admission_pair(order, shed, margin)
  rng = np.random.default_rng(11)
  names = ["interactive", "batch", "default"]
  reqs = [EngineRequest(rid=i, arrival_ms=float(rng.uniform(0, 200)),
                        prompt=np.zeros(1, np.int32), max_new_tokens=4,
                        slo=names[i % 3],
                        deadline_ms=50.0 if i % 7 == 0 else None)
          for i in range(40)]
  for step, now in enumerate(np.cumsum(rng.uniform(0, 15, 30))):
    for r in reqs:
      demand[r.rid] = float(rng.uniform(0, 150))
    window = [r for r in reqs if r.arrival_ms <= now][step % 5:]
    for r in window:
      assert got.deadline_for(r) == want.deadline_for(r)
      assert got.rate_admit(r, now) == want.rate_admit(r, now)
      assert got.predicted_dead(r, now) == want.predicted_dead(r, now)
      assert got.predicted_dead(r, now, demand_ms=30.0) == \
          want.predicted_dead(r, now, demand_ms=30.0)
      assert got.key(r, now) == want.key(r, now)
    assert sorted(window, key=lambda r: got.key(r, now)) == \
        sorted(window, key=lambda r: want.key(r, now))
  got.reset()
  want.reset()
  r = reqs[0]
  assert got.rate_admit(r, 0.0) == want.rate_admit(r, 0.0)


def test_token_bucket_and_slo_parsing_match_jax():
  got, want = TokenBucket(40.0, burst=3.0), JTokenBucket(40.0, burst=3.0)
  rng = np.random.default_rng(2)
  now = 0.0
  for _ in range(200):
    now += float(rng.exponential(20.0)) * float(rng.integers(0, 2))
    assert got.take(now) == want.take(now)
    assert got.tokens == want.tokens
  for spec in ("interactive:80@60,batch:400", "a:1.5@2/7", "", None,
               "x:10,y:20@1,z:30@3/1"):
    assert parse_slo_classes(spec) == tuple(
        SLOClass(c.name, c.deadline_ms, c.rate_per_s, c.burst)
        for c in j_parse_slo_classes(spec))
  for bad in ("nodeadline", "a:0", "a:1@0"):
    with pytest.raises(ValueError):
      parse_slo_classes(bad)
    with pytest.raises(ValueError):
      j_parse_slo_classes(bad)
  with pytest.raises(ValueError, match="order"):
    AdmissionConfig(order="lifo")
  with pytest.raises(ValueError, match="duplicate"):
    AdmissionConfig(classes=(SLOClass("a", 1.0), SLOClass("a", 2.0)))
  assert math.isinf(SLOClass("a", 1.0).rate_per_s) and \
      math.isinf(JSLOClass("a", 1.0).rate_per_s)


# -- the engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  basis = torch.from_numpy(np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32)))
  return jcfg, jparams, cfg, params, basis


def _port(llama, estimator=None, **kw):
  _, _, cfg, params, basis = llama
  kw.setdefault("prompt_len", PROMPT)
  kw.setdefault("max_new_tokens", NEW)
  return ServingEngine(cfg, EngineConfig(n_slots=N_SLOTS, **kw),
                       params=params, pca_basis=basis, estimator=estimator,
                       device="cpu")


def _jax(llama, **kw):
  jcfg, jparams, _, _, _ = llama
  kw.setdefault("prompt_len", PROMPT)
  kw.setdefault("max_new_tokens", NEW)
  return JServingEngine(jcfg, JEngineConfig(n_slots=N_SLOTS, impl="xla",
                                            **kw), params=jparams)


def _ids(reqs):
  return [r.tokens for r in sorted(reqs, key=lambda r: r.rid)]


def test_deadline_with_bound_matches_jax(llama):
  """Fixed budget 1: the same ids, and every step's raw loss estimate
  within 1e-5 (the port takes the profile's layer mean in f32 on the
  device, the JAX engine in f64 on the host)."""
  kw = dict(policy="fixed", fixed_budget=1, contract="deadline_with_bound")
  jreqs = j_make_requests(ARRIVALS, PROMPT, NEW, llama[2].vocab, seed=13)
  js = _jax(llama, **kw).run(jreqs)
  reqs = make_requests(ARRIVALS, PROMPT, NEW, llama[2].vocab, seed=13)
  eng = _port(llama, **kw)
  s = eng.run(reqs)
  assert _ids(reqs) == _ids(jreqs)
  for r, jr in zip(reqs, jreqs):
    assert len(r.est_raw) == len(jr.est_raw) == NEW
    np.testing.assert_allclose(r.est_raw, jr.est_raw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.est_spread, jr.est_spread, rtol=0,
                               atol=1e-5)
    assert r.band_lo <= r.pred_loss <= r.band_hi
  assert set(s) == set(js)
  for k in ("pred_loss_mean", "pred_loss_mae", "band_cover_pct"):
    assert s[k] == pytest.approx(js[k], abs=1e-5), k
  assert s["freed_budget_mean"] == js["freed_budget_mean"] == 0.0
  # One more static output of the step, written by every bucket.
  assert tuple(eng.step_out["est_profile"].shape) == (N_SLOTS, eng.M + 1)


def test_error_bounded_eps0_is_the_deadline_engine(llama):
  """ε = 0 demands exactness, which no estimate certifies: every step
  gets the largest bucket (M), and the ids are the deadline engine's."""
  reqs = {}
  for contract in ("deadline", "error_bounded"):
    eng = _port(llama, policy="basic", contract=contract, epsilon=0.0)
    reqs[contract] = make_requests(ARRIVALS, PROMPT, NEW, llama[2].vocab,
                                   seed=21)
    s = eng.run(reqs[contract])
    assert all(b == eng.M for b, _, _ in eng.step_log)
  assert eng._warm_buckets() == eng.buckets       # every bucket captured
  assert s["freed_budget_mean"] == 0.0
  assert _ids(reqs["error_bounded"]) == _ids(reqs["deadline"])


def test_error_bounded_frees_budget_consistently(llama):
  """Under basic the base is M on every step; with an estimator fit from
  recorded pairs each step's grant plus the budget it freed is M, and
  some steps free budget."""
  est = AccuracyEstimator(floor=0.07)
  raws, meas = _pairs(7, 24)
  est.fit(raws, meas)
  eng = _port(llama, estimator=est, policy="basic",
              contract="error_bounded", epsilon=0.02)
  s = eng.run(make_requests(ARRIVALS, PROMPT, NEW, llama[2].vocab, seed=5))
  granted = [b for b, _, _ in eng.step_log]
  assert len(granted) == len(eng._freed_log) > 0
  assert all(g + f == eng.M for g, f in zip(granted, eng._freed_log))
  assert all(g in eng.buckets for g in granted)
  assert s["freed_budget_mean"] > 0
  assert s["n"] == len(ARRIVALS)


def test_edf_admission_order_and_ids_match_jax(llama):
  """EDF, two SLO classes with deadlines loose enough that nothing is
  shed, every request arrived at 0: the admission order is EDF's on both
  sides whatever the host clock (interactive first, then batch; rid
  breaks ties)."""
  classes = "interactive:100000,batch:400000"
  kw = dict(policy="fixed", fixed_budget=1, deadline_ms=1e6)
  at_zero = [0.0] * len(ARRIVALS)
  jreqs = j_make_requests(at_zero, PROMPT, NEW, llama[2].vocab, seed=17)
  reqs = make_requests(at_zero, PROMPT, NEW, llama[2].vocab, seed=17)
  for r, jr in zip(reqs, jreqs):
    r.slo = jr.slo = ("interactive", "batch")[r.rid % 2]
  jeng = _jax(llama, admission=JAdmissionConfig(
      order="edf", shed=True, classes=j_parse_slo_classes(classes)), **kw)
  js = jeng.run(jreqs)
  eng = _port(llama, admission=AdmissionConfig(
      order="edf", shed=True, classes=parse_slo_classes(classes)), **kw)
  s = eng.run(reqs)

  def order(events):
    return [(rid, slot) for kind, rid, slot, _ in events if kind == "admit"]
  assert order(eng.events) == order(jeng.events)
  assert [rid for rid, _ in order(eng.events)] == [0, 2, 4, 1, 3]
  assert _ids(reqs) == _ids(jreqs)
  assert s["shed_admission_n"] == js["shed_admission_n"] == 0
  assert set(s["classes"]) == set(js["classes"]) == {"interactive", "batch"}
  for name in ("interactive", "batch"):
    for k in ("served_n", "shed_admission_n", "goodput_n"):
      assert s["classes"][name][k] == js["classes"][name][k]


def test_engine_sheds_the_predicted_dead(llama):
  """A request whose deadline has passed before it could be admitted is
  shed at admission: no prefill, accuracy 0, counted in its class."""
  eng = _port(llama, policy="fixed", fixed_budget=0, deadline_ms=1e6,
              admission=AdmissionConfig(order="edf", shed=True))
  reqs = make_requests([0.0, 0.0, 0.0, 0.0], PROMPT, NEW, llama[2].vocab,
                       seed=3)
  reqs[3].deadline_ms = 1e-3            # dead at arrival once demand > 0
  eng._admit_ms_ewma = 1.0
  s = eng.run(reqs)
  assert reqs[3].shed_admission and reqs[3].dropped
  assert reqs[3].accuracy == 0.0 and len(reqs[3].tokens) == 0
  assert s["shed_admission_n"] == 1 and s["served_n"] == 3
  assert s["prefills"] == 3
  assert ("shed", 3, -1, reqs[3].finish_ms) in eng.events

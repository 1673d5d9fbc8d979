"""The port's resilience and contract pieces against the JAX package's, on
the CPU: all of it is numpy on the host, so every comparison is exact.

* ``serve.resilience``: ``parse_fault_spec`` and ``FaultPlan``'s worlds
  (alive, slow) for the same spec, seed and window reseed.
* ``control.recovery``: ``RetryPolicy.delays``, ``plan_recovery`` and
  ``realized_recovery`` on drawn completion times and fault worlds; the
  policy's ``gather_modes`` / ``recover_modes`` per technique.
* The simulator (``serving.service.ScatterGatherService``): the fault
  round trip (a crashed component's shard on its ring replica, the
  stage-1 fallback, the exact techniques' lost shard) gives JAX's summary
  under ``accuracytrader`` with R = 1 and R = 2 and under ``basic``; the
  ε-or-deadline contracts give JAX's summary, ``pred_loss_mean``
  included, under all three; and a per-component measured vector
  (``step_ms_per_component``) is served as JAX serves it.
"""
import numpy as np
import pytest

from repro.control import DeadlineBudgetPolicy as JPolicy
from repro.control import RetryPolicy as JRetryPolicy
from repro.control import plan_recovery as j_plan_recovery
from repro.control import realized_recovery as j_realized_recovery
from repro.serve.resilience import FaultPlan as JFaultPlan
from repro.serve.resilience import parse_fault_spec as j_parse_fault_spec
from repro.serving.latency import ComponentModel as JComponentModel
from repro.serving.service import ScatterGatherService as JService
from repro.serving.service import ServiceConfig as JServiceConfig
from repro_torch.control import (DeadlineBudgetPolicy, RetryPolicy,
                                 plan_recovery, realized_recovery)
from repro_torch.serve.resilience import FaultPlan, parse_fault_spec
from repro_torch.serving.latency import ComponentModel
from repro_torch.serving.service import ScatterGatherService, ServiceConfig

SPECS = ["crash=1@8,seed=3",
         "crash=0@4+3@10,slow_rate=0.01,slow_scale=6",
         "crash=2@0,down_steps=5,stall_rate=0.05,seed=7",
         "crash_rate=0.03,down_steps=3,stall_rate=0.02,slow_rate=0.05,"
         "slow_steps=4,seed=11"]


@pytest.mark.parametrize("spec", SPECS + ["", "none"])
def test_parse_fault_spec_matches_jax(spec):
  got, want = parse_fault_spec(spec), j_parse_fault_spec(spec)
  if want is None:
    assert got is None
    return
  assert got.__dict__ == want.__dict__


def test_parse_fault_spec_refuses_unknown_keys():
  for text in ("crash=1@2,bogus=3", "crash_rate=2.0"):
    with pytest.raises(ValueError):
      j_parse_fault_spec(text)
    with pytest.raises(ValueError):
      parse_fault_spec(text)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("window", [0, 5, 2 ** 33 + 17])
def test_fault_plan_worlds_match_jax(spec, window):
  """The same seed and window give the same world at every step, queried
  in any order; a reseed rewinds it."""
  n = 6
  got = FaultPlan(parse_fault_spec(spec), n)
  want = JFaultPlan(j_parse_fault_spec(spec), n)
  for plan in (got, want):
    plan.reseed(window)
  for step in [7, 0, 3, 40, 12, 39]:
    g, w = got.at(step), want.at(step)
    np.testing.assert_array_equal(g.alive, w.alive)
    np.testing.assert_array_equal(g.slow, w.slow)
    assert g.clean == w.clean
  got.reseed(window + 1)
  want.reseed(window + 1)
  for step in range(20):
    np.testing.assert_array_equal(got.at(step).alive, want.at(step).alive)
    np.testing.assert_array_equal(got.at(step).slow, want.at(step).slow)


def test_disabled_fault_plan_is_all_alive():
  got = FaultPlan(None, 4)
  assert not got.enabled
  st = got.at(9)
  assert st.alive.all() and (st.slow == 1.0).all() and st.clean


@pytest.mark.parametrize("k,base,mult", [(1, 0.5, 2.0), (3, 0.5, 2.0),
                                         (4, 0.25, 1.5), (0, 0.5, 2.0)])
def test_retry_delays_match_jax(k, base, mult):
  t = np.random.default_rng(k).uniform(1.0, 9.0, 5)
  got = RetryPolicy(max_retries=k, backoff_base=base, backoff_mult=mult)
  want = JRetryPolicy(max_retries=k, backoff_base=base, backoff_mult=mult)
  np.testing.assert_array_equal(got.delays(t), want.delays(t))
  np.testing.assert_array_equal(got.delays(3.0), want.delays(3.0))
  with pytest.raises(ValueError):
    RetryPolicy(max_retries=-1)
  with pytest.raises(ValueError):
    RetryPolicy(backoff_mult=0.5)


@pytest.mark.parametrize("policy", ["basic", "partial", "accuracytrader",
                                    "fixed"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_recovery_ladder_matches_jax(policy, seed):
  rng = np.random.default_rng(seed)
  n, k = 5, int(rng.integers(0, 4))
  t_pred = rng.uniform(1.0, 20.0, n)
  t_retry = rng.uniform(1.0, 30.0, (k, n)) if k else None
  alive = rng.random(n) > 0.3
  retry_alive = rng.random((k, n)) > 0.3 if k else None
  deadline = float(rng.uniform(5.0, 15.0))
  got = plan_recovery(policy, t_pred, deadline, t_retry, alive, retry_alive)
  want = j_plan_recovery(policy, t_pred, deadline, t_retry, alive,
                         retry_alive)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  t_real = t_pred * rng.uniform(0.5, 2.0, n)
  t_rr = t_retry * rng.uniform(0.5, 2.0, (k, n)) if k else None
  np.testing.assert_array_equal(
      realized_recovery(t_real, t_rr, got[1], alive, retry_alive),
      j_realized_recovery(t_real, t_rr, want[1], alive, retry_alive))
  # The policy's own dispatch: the hedged gather and the ladder.
  kw = dict(policy=policy, buckets=(0, 1, 2), i_max_cap=2)
  pol, jpol = DeadlineBudgetPolicy(**kw), JPolicy(**kw)
  t_hedged = rng.uniform(1.0, 20.0, n)
  for th in (None, t_hedged):
    for g, w in zip(pol.gather_modes(t_pred, deadline, th),
                    jpol.gather_modes(t_pred, deadline, th)):
      np.testing.assert_array_equal(g, w)
  for g, w in zip(pol.recover_modes(t_pred, deadline, t_retry, alive,
                                    retry_alive),
                  jpol.recover_modes(t_pred, deadline, t_retry, alive,
                                     retry_alive)):
    np.testing.assert_array_equal(g, w)
  with pytest.raises(ValueError):
    plan_recovery("reissue", t_pred, deadline)


# -- the simulator ------------------------------------------------------------

@pytest.mark.parametrize("technique,replicas", [
    ("accuracytrader", 1), ("accuracytrader", 2), ("basic", 1),
    ("partial", 2)])
@pytest.mark.parametrize("spec", SPECS[:3])
def test_simulator_fault_round_trip_matches_jax(technique, replicas, spec):
  kw = dict(n_components=8, technique=technique, replicas=replicas,
            deadline_ms=25.0, seed=4)
  got = ScatterGatherService(ServiceConfig(faults=parse_fault_spec(spec),
                                           **kw))
  want = JService(JServiceConfig(faults=j_parse_fault_spec(spec), **kw))
  for rate, dur in ((40.0, 1.0), (80.0, 0.5)):
    s = got.run_open_loop(rate, dur)
    assert s == want.run_open_loop(rate, dur)
    assert 0.0 <= s["availability_pct"] <= 100.0


def test_simulator_faults_cost_the_exact_techniques_availability():
  spec = "crash=1@0,seed=1"
  avail = {}
  for tech in ("accuracytrader", "basic"):
    svc = ScatterGatherService(ServiceConfig(
        n_components=4, technique=tech, faults=parse_fault_spec(spec)))
    avail[tech] = svc.run_open_loop(20.0, 1.0)["availability_pct"]
  assert avail["accuracytrader"] == 100.0 and avail["basic"] == 0.0


@pytest.mark.parametrize("contract", ["deadline", "error_bounded",
                                      "deadline_with_bound"])
@pytest.mark.parametrize("epsilon,skew", [(0.02, 0.0), (0.005, 0.8),
                                          (0.0, 0.0), (0.07, 0.0)])
def test_simulator_contracts_match_jax(contract, epsilon, skew):
  """The repair of the contracts: ``error_bounded`` clamps the budget to
  the smallest bucket the accuracy model says meets ε, and both new
  contracts report ``pred_loss_mean``; ``deadline`` reports none."""
  kw = dict(n_components=20, contract=contract, epsilon=epsilon, skew=skew,
            seed=1)
  got = ScatterGatherService(ServiceConfig(**kw))
  want = JService(JServiceConfig(**kw))
  for rate, dur in ((20.0, 5.0), (60.0, 1.0)):
    s = got.run_open_loop(rate, dur)
    assert s == want.run_open_loop(rate, dur)
    assert ("pred_loss_mean" in s) == (contract != "deadline")


def test_error_bounded_frees_budget_in_the_simulator():
  """At a loose deadline the controller's budget is i_max_cap; ε = 0.07
  is met by the synopsis alone (loss 0.07 at budget 0), so the clamp is
  budget 0, and the loss the model predicts is the loss it reports."""
  svc = ScatterGatherService(ServiceConfig(
      n_components=6, contract="error_bounded", epsilon=0.07,
      deadline_ms=1e6, seed=0))
  s = svc.run_open_loop(10.0, 2.0)
  assert svc._epsilon_budget() == 0
  assert s["pred_loss_mean"] == pytest.approx(0.07)
  assert s["accuracy_loss_pct"] == pytest.approx(7.0)


class _Export:
  """A measured per-component table, as ``ClusterMeasuredExport``."""

  def step_ms_per_component(self, budget):
    return np.asarray([1.0, 2.5, 4.0]) * (1.0 + budget / 40.0)

  def step_ms(self, budget):
    return float(self.step_ms_per_component(budget).max())


@pytest.mark.parametrize("contract", ["deadline", "error_bounded"])
def test_simulator_per_component_export_matches_jax(contract):
  kw = dict(n_components=3, skew=1.2, contract=contract, seed=3,
            faults=None)
  got = ScatterGatherService(ServiceConfig(**kw), step_backend=_Export())
  want = JService(JServiceConfig(**kw), step_backend=_Export())
  assert got.per_component_ms
  assert got.run_open_loop(50.0, 1.0) == want.run_open_loop(50.0, 1.0)
  # A component picks its own entry of a measured vector.
  for Model in (ComponentModel, JComponentModel):
    comp = Model(seed=0, comp_id=1, interference=0.0, straggler_prob=0.0)
    assert comp.submit(10.0, 5, service_ms=np.asarray([3.0, 7.5]),
                       scale=2.0) == pytest.approx(25.0)

"""The port's fleet autoscaler, its simulator round trip and the diurnal
workload against the JAX package, on the CPU.

* ``serving.workload``: ``canonical_hour``, ``hour_rate``, ``hour_trend``
  and ``hour_trace`` over all 25 hours (0..24, both conventions), equal to
  JAX's (exact: numpy).
* Every test of ``tests/test_autoscaler.py`` on the port's classes: the
  bounds, the queueing model's shape, sizing monotone in load, hysteresis
  (a flat trace never flaps; scale-up immediate and elementwise; shrink
  only after the cooldown and with headroom), the 24-hour trace's cost
  saving, ``ScaledFleetExport``'s counterfactuals, and ``drain`` on the
  port's fleet engine (nothing dropped).
* ``Autoscaler`` decisions and log, the queueing model's p99 and
  ``ScaledFleetExport``'s numbers equal to JAX's hour by hour over the
  Sogou trace, and the simulator's windows at the chosen sizes.
"""
import numpy as np
import pytest
import torch

from repro.control import Autoscaler as JAutoscaler
from repro.control import AutoscalerConfig as JAutoscalerConfig
from repro.control import FleetSize as JFleetSize
from repro.serving import workload as jwl
from repro.serving.service import ScaledFleetExport as JScaledFleetExport
from repro.serving.service import ScatterGatherService as JService
from repro.serving.service import ServiceConfig as JServiceConfig
from repro_torch.control import Autoscaler, AutoscalerConfig, FleetSize, drain
from repro_torch.serving import workload as wl
from repro_torch.serving.service import (ScaledFleetExport,
                                         ScatterGatherService, ServiceConfig)


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# -- the workload --------------------------------------------------------------

@pytest.mark.parametrize("hour", range(25))
def test_hour_trace_matches_jax(hour):
  assert wl.canonical_hour(hour) == jwl.canonical_hour(hour)
  assert wl.hour_rate(hour) == jwl.hour_rate(hour)
  assert wl.hour_trend(hour) == jwl.hour_trend(hour)
  for sessions, seed in ((60, 0), (17, 5)):
    np.testing.assert_array_equal(wl.hour_trace(hour, sessions, seed),
                                  jwl.hour_trace(hour, sessions, seed))
  assert wl.SOGOU_HOURLY == jwl.SOGOU_HOURLY


def test_midnight_aliases():
  np.testing.assert_array_equal(wl.hour_trace(0), wl.hour_trace(24))
  assert wl.hour_trend(9) == "increasing"
  assert wl.hour_trend(23) == wl.hour_trend(24) == "decreasing"


# -- the decision rule (tests/test_autoscaler.py on the port) ------------------

def _step_ms(n, r):
  """Synthetic but shaped like the measured model: step wall falls with
  the component count and the straggler excess with the replica rows."""
  return (24.0 / n) * (1.0 + 0.6 / r)


def _cfg(cls=AutoscalerConfig, **kw):
  kw.setdefault("p99_target_ms", 60.0)
  kw.setdefault("max_components", 6)
  kw.setdefault("max_replicas", 2)
  return cls(**kw)


def test_bounds_validation():
  with pytest.raises(ValueError, match="component bounds"):
    Autoscaler(_cfg(min_components=0), _step_ms)
  with pytest.raises(ValueError, match="replica bounds"):
    Autoscaler(_cfg(min_replicas=3, max_replicas=2), _step_ms)


def test_p99_model_shape():
  asc = Autoscaler(_cfg(), _step_ms)
  s = FleetSize(2, 1)
  p99s = [asc.p99_of(r, s) for r in (1.0, 5.0, 10.0, 15.0)]
  assert all(a < b for a, b in zip(p99s, p99s[1:]))
  cap = asc.cfg.slots * 1000.0 / (4.0 * _step_ms(2, 1))
  assert asc.p99_of(cap, s) == float("inf")
  assert asc.p99_of(10.0, FleetSize(4, 1)) < asc.p99_of(10.0, FleetSize(2, 1))
  assert asc.p99_of(10.0, FleetSize(2, 2)) < asc.p99_of(10.0, FleetSize(2, 1))


def test_size_monotone_in_load():
  asc = Autoscaler(_cfg(), _step_ms)
  rates = sorted(set(list(np.linspace(0.5, 400.0, 120))
                     + [float(wl.hour_rate(h)) for h in range(24)]))
  sizes = [asc.size_for(r) for r in rates]
  for a, b in zip(sizes, sizes[1:]):
    assert b.n_components >= a.n_components
    assert b.devices >= a.devices
  assert asc.size_for(1e9) == FleetSize(6, 2)
  assert all(asc.p99_of(r, s) <= 60.0 for r, s in zip(rates, sizes)
             if s != FleetSize(6, 2))


def test_flat_trace_never_flaps():
  asc = Autoscaler(_cfg(), _step_ms)
  size = None
  for _ in range(50):
    size = asc.decide(30.0, size)
  actions = [e["action"] for e in asc.log]
  assert actions[0] == "init"
  assert set(actions[1:]) == {"hold"}


def test_scale_up_immediate_and_elementwise_max():
  asc = Autoscaler(_cfg(), _step_ms)
  assert asc.decide(5.0, FleetSize(5, 2)) == FleetSize(5, 2)
  asc2 = Autoscaler(_cfg(), _step_ms)
  want = asc2.size_for(300.0)
  got = asc2.decide(300.0, FleetSize(1, 2))
  assert got.n_components == max(want.n_components, 1)
  assert got.replicas == max(want.replicas, 2)
  assert asc2.log[-1]["action"] == "up"


def test_shrink_requires_cooldown_and_headroom():
  asc = Autoscaler(_cfg(cooldown_windows=2, headroom=0.05), _step_ms)
  big = FleetSize(6, 2)
  s1 = asc.decide(0.1, big)
  assert s1 == big and asc.log[-1]["action"] == "cooldown"
  s2 = asc.decide(300.0, s1)
  assert s2 == big
  s3 = asc.decide(0.1, s2)
  assert s3 == big and asc.log[-1]["action"] == "cooldown"
  s4 = asc.decide(0.1, s3)
  assert s4.devices < big.devices and asc.log[-1]["action"] == "down"
  asc4 = Autoscaler(_cfg(cooldown_windows=1, headroom=0.05), _step_ms)
  tgt = asc4.size_for(2.0)
  assert 60.0 * (1.0 - 0.05) < asc4.p99_of(2.0, tgt) <= 60.0
  assert asc4.decide(2.0, big) == big
  assert asc4.log[-1]["action"] == "cooldown" and asc4._shrink_streak == 0
  asc5 = Autoscaler(_cfg(cooldown_windows=1, headroom=0.9), _step_ms)
  small = asc5.size_for(10.0)
  assert asc5.p99_of(10.0, small) > 60.0 * (1.0 - 0.9)
  held = asc5.decide(10.0, FleetSize(6, 2))
  assert held == FleetSize(6, 2) and asc5._shrink_streak == 0


def test_diurnal_trace_tracks_and_saves_cost():
  asc = Autoscaler(_cfg(headroom=0.05), _step_ms)
  size = None
  cost_auto = 0
  static = FleetSize(6, 2)
  for h in range(24):
    rate = float(wl.SOGOU_HOURLY[h])
    size = asc.decide(rate, size)
    cost_auto += size.devices
    assert asc.p99_of(rate, size) <= 60.0 or size == static
  assert cost_auto < 24 * static.devices


class _Export:
  def step_ms_per_component(self, budget):
    return np.array([4.0, 2.0, 2.0, 2.0]) * (1.0 + 0.01 * budget)


def test_scaled_fleet_export_model():
  exp = ScaledFleetExport(_Export(), 4, replicas=1)
  v = exp.step_ms_per_component(8)
  assert v.shape == (4,)
  base = _Export().step_ms_per_component(8)
  assert float(v.max()) == pytest.approx(float(base.max()))
  assert exp.step_model(8, 1) < exp.step_model(4, 1) < exp.step_model(2, 1)
  assert exp.step_model(4, 2) < exp.step_model(4, 1)
  bal = ScaledFleetExport(_Export(), 4, replicas=10 ** 6)
  assert bal.step_ms(8) == pytest.approx(float(base.sum()) / 4, rel=1e-3)
  with pytest.raises(ValueError):
    ScaledFleetExport(_Export(), 0)
  with pytest.raises(ValueError):
    ScaledFleetExport(_Export(), 2, replicas=0)


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("n_max,r_max,scale,target", [
    (4, 2, 1.0, 50.0), (6, 3, 0.3, 40.0), (2, 2, 0.2, 25.0)])
def test_decisions_match_jax_hour_by_hour(n_max, r_max, scale, target):
  """The 24-hour loop of the launcher's ``--autoscale`` in both packages on
  one export: the same size each hour, the same log, the same predicted
  p99 and the same simulated window at that size."""
  exp = _Export()
  kw = dict(p99_target_ms=target, max_components=n_max, max_replicas=r_max,
            slots=4)
  asc = Autoscaler(AutoscalerConfig(**kw),
                   ScaledFleetExport(exp, n_max, r_max).step_model)
  jasc = JAutoscaler(JAutoscalerConfig(**kw),
                     JScaledFleetExport(exp, n_max, r_max).step_model)
  size = jsize = None
  for h in range(24):
    rate = wl.hour_rate(h) * scale
    size, jsize = asc.decide(rate, size), jasc.decide(rate, jsize)
    assert (size.n_components, size.replicas) == (jsize.n_components,
                                                  jsize.replicas)
    assert asc.p99_of(rate, size) == jasc.p99_of(
        rate, JFleetSize(jsize.n_components, jsize.replicas))
    scaled = ScaledFleetExport(exp, size.n_components, size.replicas)
    jscaled = JScaledFleetExport(exp, jsize.n_components, jsize.replicas)
    np.testing.assert_array_equal(scaled.step_ms_per_component(8),
                                  jscaled.step_ms_per_component(8))
    if h % 6 == 0:
      skw = dict(n_components=size.n_components, deadline_ms=50.0, seed=h)
      assert ScatterGatherService(ServiceConfig(**skw),
                                  step_backend=scaled).run_open_loop(
          rate, 0.5) == JService(JServiceConfig(**skw),
                                 step_backend=jscaled).run_open_loop(rate,
                                                                     0.5)
  assert asc.log == jasc.log


# -- drain-before-retire -------------------------------------------------------

def test_drain_before_retire_drops_nothing():
  from repro_torch.configs.registry import get_config
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  cfg = get_config("llama3-8b", smoke=True)
  eng = ServingEngine(cfg, EngineConfig(
      n_slots=2, prompt_len=64, max_new_tokens=3, deadline_ms=1e6,
      policy="accuracytrader"), device="cpu",
      backend=FleetStepBackend(FleetConfig(n_components=2, replicas=2)))
  eng.reset()
  reqs = make_requests([0.0, 0.0], 64, 3, cfg.vocab, seed=4)
  eng._admit(reqs[0], 0)
  eng._admit(reqs[1], 1)
  assert drain(eng) == 2
  assert all(s is None for s in eng.slots)
  assert len(eng.completed) == 2
  assert not any(r.dropped for r in eng.completed)
  assert all(len(r.budgets) == r.max_new_tokens for r in eng.completed)
  assert drain(eng) == 0

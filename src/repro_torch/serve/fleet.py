"""The fleet tier: materialized replica shards on the stacked path
(counterpart of ``repro.serve.fleet``).

The cluster tier (``serve.cluster``) replicates in the accounting only: a
hedged gather is priced against a modelled replica while the step reads
the primary shard.  The fleet tier makes the replicas real.  Replica row
``r`` holds, at component column ``j``, a copy of shard ``(j - r) % N``
(``dist.topology.plan_2d``): row r is row 0 ring-rotated by r.  One
admission writes ONE arena, scatters it over the components of row 0
and copies the rows r >= 1 from it (``kv_cache.replicate_leaf``'s
layout), so every copy is bit-identical to its primary, and the engine
pins a corpus-cache arena once for each of the R mappings
(``replica_mappings``).

Each step the frontend selects, for every shard, the holder predicted to
finish first under the step's interference and straggler draws
(``topology.select_replica``), and the gather reads that holder's actual
shard; the partials fold in fixed shard order, so the output equals the
all-primary gather bit for bit whatever the selection.  Accounting prices
shard c at the earliest completion among its holders: at R = 2 and the
same seeds that is exactly the cluster tier's modelled-hedge minimum.

On a ``("replica", "component")`` mesh of R*N ranks
(``dist.topology.make_fleet_mesh``) each rank is one lane: rank (r, j)
holds a materialized copy of shard ``(j - r) % N`` (:func:`_fleet_sharded`).
Every lane computes stage 1 and its refinement, one all-gather over both
axes brings every lane's partials, and the selected lane of each shard is
folded in shard order, as in JAX.  Stacked (``mesh=None``) the R x N lanes
are one program on one card.  The stacked pool keeps the replica axis
between the batch and the component axes,

    k / v          (nb, na, B, R, N, Hkv, m_max*C, D)
    k_syn / v_syn  (nb, na, B, R, N, Hkv, m_max, D)
    counts         (nb, na, B, R, N, m_max)
    *_scale        (nb, na, B, R, N, Hkv, m_max)      (a quantized arena)

so a layer's shards are, without a copy, ``B*R*N`` rows of
``(Hkv, m_max*C, D)``.  JAX's stacked body picks the selected lanes with
an index, which in PyTorch would copy a whole replica's shards every layer
of every step (and never read the selected holder's own shard).  Here the
selection becomes a row map of ``B*N`` entries, entry ``b*N + c`` the row
``(b*R + sel[c])*N + (c + sel[c]) % N``, computed on the device from the
frontend vector inside the step's graph: stage 2
(``block_gather_attention``) reads each selected shard in place through
it, and only stage 1's small tables, counts and scales (about 0.5 MB a
layer at llama3-8b's --cluster 4 window) are gathered by index.  A rank's
pool on the mesh is its lane alone, ``(nb, na, B, Hkv, m_max*C, D)`` and so
on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.control import MODE_DROP, MODE_FULL, MODE_STAGE1
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.dist.topology import make_fleet_mesh, plan_2d, select_replica
from repro_torch.kernels import ops
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.cluster import (ClusterConfig, ClusterStepBackend,
                                       _aux, _cluster_stacked, _compose,
                                       _frontend, _local_stage1,
                                       _local_stage2, _pick_one, _StepPlan)
from repro_torch.serve.serve_step import make_serve_step

__all__ = ["FleetConfig", "FleetStepBackend", "make_fleet_attention"]

# The arena leaves stage 1 reads (gathered at the selected lanes); stage 2
# reads k / v in place through the row map.
_TABLES = ("k_syn", "v_syn", "counts", "k_syn_scale", "v_syn_scale",
           "k_scale", "v_scale")


@dataclasses.dataclass
class FleetConfig(ClusterConfig):
  """The fleet tier's knobs: a ``ClusterConfig`` whose ``replicas`` is a
  real grid dimension (R >= 1 rows of materialized shards).  The
  resilience knobs stay at their defaults: faults and the retry ladder
  ride the cluster tier."""
  replicas: int = 2


def _select_lanes(sel: torch.Tensor, N: int):
  """Grid coordinates of each shard's selected holder: shard c served from
  replica row ``sel[c]`` lives at column ``(c + sel[c]) % N``."""
  cols = (torch.arange(N, dtype=sel.dtype, device=sel.device) + sel) % N
  return sel, cols


def fleet_rows(sel: torch.Tensor, B: int, R: int, N: int) -> torch.Tensor:
  """The row map (B*N,) of a selection ``sel`` (N,): entry ``b*N + c`` is
  the row of shard c's selected lane in the ``B*R*N``-row view of a
  layer's pool, ``(b*R + sel[c])*N + (c + sel[c]) % N``."""
  rows, cols = _select_lanes(sel, N)
  lane = (rows * N + cols).long()
  base = torch.arange(B, device=sel.device)[:, None] * (R * N)
  return (base + lane[None]).reshape(B * N)


def make_fleet_attention(topo, alloc: str = "mass", mesh=None,
                         recirculate: bool = True, telemetry: bool = False):
  """Returns ``attention_fn(q, cache_sl, ...) -> (ctx, aux)`` over one
  layer of the fleet layout (see the module doc):

    k / v          (B, R, N, Hkv, m_max*C, D)   ring-rotated shard copies
    k_syn / v_syn  (B, R, N, Hkv, m_max, D)
    counts         (B, R, N, m_max)
    fe_mode        (N,) int32                   per-shard gather mode
    fe_replica     (N,) int32                   per-shard selected holder

  The body is the cluster tier's, on the selected lanes (stage 2 through
  the row map, stage 1 on the gathered tables); ``aux`` as the cluster
  tier's.  With ``mesh`` (the port's ``Mesh`` of (replica R, component
  N)) the body is :func:`_fleet_sharded` on this rank's lane, the layer's
  leaves without the replica and component axes; anything else given as
  ``mesh`` raises ``TypeError``."""
  if alloc not in ("mass", "topk", "gain"):
    raise ValueError(f"alloc {alloc!r} not in ('mass', 'topk', 'gain')")
  if mesh is not None:
    shd.require_mesh(mesh)
    want = {"replica": topo.replicas, "component": topo.n_components}
    if mesh.shape != want:
      raise ValueError(f"mesh {mesh.shape} is not the fleet's {want}")

  def attention(q, csl, *, i_max, cluster_size, sm_scale, cap=None,
                self_kv=None):
    if mesh is not None:
      return _fleet_sharded(
          q, csl, mesh, topo, alloc, i_max=i_max, cluster_size=cluster_size,
          sm_scale=sm_scale, cap=cap, self_kv=self_kv,
          recirculate=recirculate, telemetry=telemetry)
    return _fleet_stacked(
        q, csl, topo, alloc, i_max=i_max, cluster_size=cluster_size,
        sm_scale=sm_scale, cap=cap, self_kv=self_kv,
        recirculate=recirculate, telemetry=telemetry)

  return attention


def _fleet_stacked(q, csl, topo, alloc, *, i_max, cluster_size, sm_scale,
                   cap, self_kv, recirculate=True, telemetry=False):
  """The cluster tier's stacked body on every shard's selected lane: the
  tables gathered by index (B*N rows), k / v as the ``B*R*N``-row view
  that stage 2 reads through the row map.  Every copy is bit-identical,
  so the output cannot depend on the selection."""
  R, N = topo.replicas, topo.n_components
  B = csl["k_syn"].shape[0]
  rows = fleet_rows(csl["fe_replica"], B, R, N)
  flat = {kk: vv for kk, vv in csl.items() if kk != "fe_replica"}
  for name in _TABLES:
    if name in csl:
      t = csl[name]
      flat[name] = t.view(B * R * N, *t.shape[3:]).index_select(
          0, rows).view(B, N, *t.shape[3:])
  for name in ("k", "v"):
    t = csl[name]
    flat[name] = t.view(B * R * N, *t.shape[3:])
  return _cluster_stacked(
      q, flat, alloc, i_max=i_max, cluster_size=cluster_size,
      sm_scale=sm_scale, cap=cap, self_kv=self_kv, recirculate=recirculate,
      mode_caps=False, telemetry=telemetry, kv_rows=rows)


def _fleet_sharded(q, csl, mesh, topo, alloc, *, i_max, cluster_size,
                   sm_scale, cap, self_kv, recirculate=True,
                   telemetry=False):
  """One rank = lane (r, j) of the (replica, component) mesh, holding shard
  ``(j - r) % N``: stage 1 over its tables, one all-gather of the scores
  along its row (a row holds every shard once; rotated back to shard
  order, so every lane sees the same table), the frontend replicated, stage
  2 over its shard, its mode's contribution, then one all-gather of the
  packed partials over both axes and the fold of each shard's SELECTED lane
  in shard order: the stacked fold's order, whatever ``fe_replica``
  says."""
  R, N, Mp = topo.replicas, topo.n_components, topo.m_max
  rid, j = mesh.axis_index("replica"), mesh.axis_index("component")
  c_loc = (j - rid) % N
  B, Hkv = csl["k_syn"].shape[:2]
  dev = q.device
  sc_l, p_syn, syn_scales = _local_stage1(q, csl, sm_scale, cap)
  to_shard = (torch.arange(N, device=dev) + rid) % N
  sc_all = mesh.all_gather(sc_l, "component", dim=2).view(
      B, Hkv, N, Mp).index_select(2, to_shard)
  counts_g = None
  if alloc == "gain" or telemetry:
    cg = mesh.all_gather(csl["counts"], "component", dim=1)
    counts_g = cg.view(B, N, Mp).index_select(1, to_shard).reshape(B, N * Mp)
  mode, sel_arr = csl["fe_mode"], csl["fe_replica"]
  sel, mass, cover = _frontend(sc_all, counts_g, mode, alloc, i_max,
                               recirculate=recirculate, mode_caps=False)
  p_full = p_syn
  if sel is not None:
    p_ref = _local_stage2(q, csl, sel[:, c_loc].contiguous(), syn_scales,
                          cluster_size=cluster_size, sm_scale=sm_scale,
                          cap=cap)
    p_full = ops.merge_partials(p_syn, p_ref)
  contrib = _pick_one(mode[c_loc], p_full, p_syn)
  lanes = mesh.all_gather(ops.pack_partials(contrib),
                          ("replica", "component"), dim=0,
                          tiled=False)                      # (R*N, B, H, D+2)
  rows, cols = _select_lanes(sel_arr, N)
  parts = lanes.index_select(0, (rows * N + cols).long())   # shard order
  ctx = _compose(parts, q, csl, self_kv, sm_scale=sm_scale, cap=cap)
  return ctx, _aux(mass, cover, sc_all, counts_g, alloc, telemetry)


@dataclasses.dataclass
class _FleetPlan(_StepPlan):
  """The cluster step plan and this step's per-shard replica selection."""
  sel: Optional[np.ndarray] = None       # (N,) int32 selected replica row


class FleetStepBackend(ClusterStepBackend):
  """``ServingEngine`` step backend running the fleet tier: the cluster
  tier's backend with the R-row grid (``plan_2d``), the replicating slot
  write, the selection-aware attention, and plan / account that price
  every shard at the earliest completion among its R holders.  The
  frontend vector is packed (2, N) int32: row 0 the gather modes, row 1
  the selected replicas."""

  def bind(self, engine) -> None:
    super().bind(engine)
    cc = self.ccfg
    if self.resilient:
      raise ValueError(
          "fleet tier is non-resilient by construction (faults=None, "
          "retries=1, recovery=True): fault injection and the retry "
          "ladder ride the 1-D cluster tier")
    self.topo = plan_2d(self.M, cc.n_components, cc.replicas, skew=cc.skew)
    full = self.full_mode()
    self.fe_mode = torch.as_tensor(full).to(self.dev)
    self._fe_host = torch.as_tensor(full).pin_memory() \
        if self.dev.type == "cuda" else torch.as_tensor(full).clone()

  def _make_mesh(self):
    """The (replica, component) mesh of R*N ranks when ``use_mesh`` is None
    and the world has them, or ``use_mesh`` is True (fewer ranks raise);
    None (the stacked path) otherwise."""
    cc = self.ccfg
    if cc.use_mesh is False:
      return None
    n = cc.replicas * cc.n_components
    mesh = make_fleet_mesh(cc.n_components, cc.replicas)
    if mesh is None and cc.use_mesh:
      raise RuntimeError(
          f"use_mesh=True but the world has {world.world_size()} < {n} ranks "
          f"for the (replica={cc.replicas}, component={cc.n_components}) "
          f"mesh; start {n} (torchrun --nproc-per-node {n}, or "
          "repro_torch.dist.world.run_world)")
    return self._check_member(mesh)

  def _make_attention(self):
    cc = self.ccfg
    return make_fleet_attention(self.topo, alloc=cc.alloc, mesh=self.mesh,
                                recirculate=cc.recirculate,
                                telemetry=self.telemetry)

  def _holds(self, comp: int) -> bool:
    """Whether this rank's lane (r, j) holds row 0's component ``comp``:
    row r column j is row 0's column ``(j - r) % N``."""
    if self.mesh is None:
      return True
    r, j = (self.mesh.axis_index(a) for a in ("replica", "component"))
    return comp == (j - r) % self.topo.n_components

  @property
  def replica_mappings(self) -> int:
    """Pins per slot admission: each replica row maps the arena once."""
    return self.topo.replicas

  # -- cache layout ----------------------------------------------------------
  def _pool_struct(self) -> Dict[str, tuple]:
    """The cluster layout with the replica axis after the slot axis (on a
    mesh, the rank's lane alone)."""
    if self.mesh is not None:
      return super()._pool_struct()
    R = self.topo.replicas
    return {name: ((sh[:3] + (R,) + sh[3:]) if name in kvc.ARENA_LEAVES
                   else sh, dt)
            for name, (sh, dt) in super()._pool_struct().items()}

  def write_slot(self, cache, syn, slot: int):
    """One admission backs R replica mappings: scatter the arena over row
    0's components (and route it, as the cluster tier does), then copy
    row r's column j from row 0's column ``(j - r) % N``, in place.  On a
    mesh the rank writes its own lane's shard straight from the arena."""
    if self.mesh is not None:
      return super().write_slot(cache, syn, slot)
    self._scatter(syn, slot,
                  lambda name, comp: cache[name][:, :, slot, 0, comp])
    N = self.topo.n_components
    for name in kvc.ARENA_LEAVES:
      if name not in syn:
        continue
      lane = cache[name][:, :, slot]            # (nb, na, R, N, ...)
      for r in range(1, self.topo.replicas):
        for j in range(N):
          lane[:, :, r, j].copy_(lane[:, :, 0, (j - r) % N])
    private = {k: v for k, v in syn.items() if k not in kvc.ARENA_LEAVES}
    return kvc.write_slot(cache, private, slot, self._bx)

  # -- the step --------------------------------------------------------------
  def step_fn(self, budget: int):
    """The serve step at ``budget`` over the fleet layout, reading the
    packed frontend vector from the static buffer (a graph input)."""
    step = make_serve_step(self.cfg, mode="synopsis", i_max=budget,
                           attention_fn=self.attention)
    fe = self.fe_mode

    def run(params, cache, tok):
      return step(params, {**cache, "fe_mode": fe[0], "fe_replica": fe[1]},
                  tok)

    return run

  def full_mode(self) -> np.ndarray:
    N = self.topo.n_components
    return np.stack([np.full((N,), MODE_FULL, np.int32),
                     np.zeros((N,), np.int32)])

  def load_plan(self, plan: _FleetPlan) -> None:
    """Load the packed frontend vector: the modes and the selection."""
    self.load_mode(np.stack([plan.mode, plan.sel]).astype(np.int32))

  # -- frontend plan / account ----------------------------------------------
  def _replica_times(self, wall: float, u: np.ndarray, usum: float,
                     noise: np.ndarray, noise2: np.ndarray) -> np.ndarray:
    """(R, N) completion of shard c served from its r-th holder.  Row 0 is
    the primary's own completion; row r >= 1 at holder j = (c + r) % N
    queues behind j's own shard (u[j] at noise[j]), then streams c's stage
    1 and granted clusters (u[c]) under the reissue draw noise2[j].  Row 1
    is the cluster tier's ``_hedge_time``; the rows share the step's two
    draws whatever R."""
    N = self.topo.n_components
    c = np.arange(N)
    rows = [wall * (u / usum) * noise]
    for r in range(1, self.topo.replicas):
      j = (c + r) % N
      rows.append(wall * (u[j] * noise[j] + u * noise2[j]) / usum)
    return np.stack(rows)

  def plan_step(self, budget: int, step_deadline_ms: float) -> _FleetPlan:
    """Predict every (shard, holder) completion under this step's draws,
    select each shard's fastest holder (ties to the primary), and let the
    policy mark the shards whose best completion still misses the deadline
    STAGE1 / DROP."""
    massf = self.mass_ewma / max(self.mass_ewma.sum(), 1e-30)
    b_est = float(budget) * massf
    u = self._units(b_est)
    usum = max(u.sum(), 1e-30)
    noise, noise2 = self._draw_noise(), self._draw_noise()
    wall = self.predictor.predict(budget)
    t_rc = self._replica_times(wall, u, usum, noise, noise2)
    sel = select_replica(t_rc)
    mode, _ = self.engine.controller.gather_modes(t_rc.min(axis=0),
                                                  step_deadline_ms)
    return _FleetPlan(mode=mode.astype(np.int32), noise=noise,
                      noise2=noise2, hedged=sel != 0, b_est=b_est,
                      deadline_ms=step_deadline_ms, sel=sel)

  def account(self, budget: int, wall_ms: float, plan: _FleetPlan, st,
              warming: bool = False) -> Dict[str, float]:
    """Re-price the (R, N) completions with the measured wall and the
    refined rows, and take each shard at its earliest holder: never worse
    than the cluster tier's modelled hedge under the same draws."""
    full = plan.mode == MODE_FULL
    if not warming:
      self.predictor.observe(budget, wall_ms)
      if "fe_mass" in st:
        m = np.asarray(st["fe_mass"]).mean(axis=(0, 1))
        mix = 0.7 * self.mass_ewma + 0.3 * m
        self.mass_ewma = mix / max(mix.sum(), 1e-30)
    cover = np.asarray(st["fe_cover"]).mean(axis=(0, 1)) \
        if "fe_cover" in st else np.zeros_like(self.comp_share)
    u = self._units(np.where(full, cover, 0.0))
    usum = max(u.sum(), 1e-30)
    f0 = self._units(np.zeros_like(cover)) / usum
    done_full = self._replica_times(wall_ms, u, usum, plan.noise,
                                    plan.noise2).min(axis=0)
    t_stage1 = wall_ms * f0 * plan.noise
    done = np.where(full, done_full,
                    np.where(plan.mode == MODE_STAGE1, t_stage1, 0.0))
    valid = np.maximum(self.comp_share * self.M, 1.0)
    frac = np.minimum(cover / valid, 1.0)
    acc_c = np.where(
        full, [self.accuracy_fn(x) for x in frac],
        np.where(plan.mode == MODE_STAGE1, self.accuracy_fn(0.0), 0.0))
    step_acc = float(np.sum(self.comp_share * acc_c))
    parallel_ms = float(max(done.max(), 1e-3))
    sharesum = max(self.comp_share.sum(), 1e-30)
    drop_share = float(np.sum(np.where(plan.mode == MODE_DROP,
                                       self.comp_share, 0.0)) / sharesum)
    self.step_idx += 1
    off_primary = int((plan.sel != 0).sum()) if plan.sel is not None else 0
    return {"parallel_ms": parallel_ms, "step_acc": step_acc,
            "wall_ms": wall_ms, "gathered": int(full.sum()),
            "hedged": off_primary, "comp_ms": done,
            "drop_share": drop_share, "retried": 0,
            "off_primary": off_primary}

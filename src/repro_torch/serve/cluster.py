"""Multi-component scatter-gather serving tier, on its stacked path
(counterpart of ``repro.serve.cluster``).

The paper's architecture: a frontend scatter-gathers over parallel
components, each answering at once from its local synopsis and then
refining the corpus parts most related to the request.

  * The corpus KV of every resident request is partitioned across N
    *components* (``dist.topology.ComponentTopology``): a contiguous range
    of its M clusters each, padded to a common ``m_max``.
  * Stage 1 runs the fused synopsis scoring on every component's shard;
    the *frontend aggregator* ranks the gathered scores globally and
    splits the step's refinement budget over the components in proportion
    to their synopsis relevance mass (``control.allocate_budget``), or
    takes the global top-k (``alloc="topk"``) or the top-k by marginal
    accuracy gain (``alloc="gain"``).
  * The gather is deadline-driven: per step each component is FULL (stage
    1 + refinement), STAGE1 (its synopsis answer stands in) or DROP (its
    contribution is skipped), and the online-softmax composer folds the
    granted partials in component order, then the frontend's recent ring
    and the new token's self KV.
  * With replicas R >= 2 the frontend hedges: a component predicted to
    miss the step deadline has its refinement reissued to the shard's ring
    replica and the earlier completion counts; with faults injected
    (``serve.resilience``) the single hedge becomes the bounded-retry
    recovery ladder of ``control.recovery``.

The tier runs in one of two ways, as the JAX package's does.  Stacked
(``mesh=None``), the N components are one program on one device.  On a
``("component",)`` mesh (``dist.topology.make_component_mesh``: a world of
at least N ranks), each rank is one component and holds only its own
shard; the frontend runs on every rank after one all-gather of the
scores, and the result composer folds the all-gathered partials in
component order (:func:`_cluster_sharded`).  The stacked layout differs
from the JAX one: the component axis sits next to the batch axis,

    k / v          (nb, na, B, N, Hkv, m_max*C, D)
    k_syn / v_syn  (nb, na, B, N, Hkv, m_max, D)
    counts         (nb, na, B, N, m_max)
    *_scale        (nb, na, B, N, Hkv, m_max)      (a quantized arena)

(JAX: ``(nb, na, B, Hkv, N, ...)`` and ``(nb, na, B, N, m_max)``), so each
layer's shard is, without a copy, ``B*N`` rows of ``(Hkv, m_max*C, D)``.
Stage 1 and stage 2 then run as ONE launch each over all ``B*N`` rows, with
the query repeated N times: each component's partials are independent of
the others', so this is the math of JAX's loop over the components, at the
single-component step's launch count.  A slice of the JAX layout would be
strided, and the wrappers' ``.contiguous()`` would copy the whole corpus
every layer and step without an error.  On a mesh a rank's pool is the
layout without the component axis, its component's slice ``[:, :, :, sid]``
stored contiguously: ``(nb, na, B, Hkv, m_max*C, D)`` and so on.

:class:`ClusterStepBackend` plugs the tier into ``ServingEngine``:
admission scatters each slot's built synopsis over the components (per-slot
routing, optionally rotated), each budget bucket's step is one captured
graph whose gather modes are a static device buffer loaded before each
replay, and the backend keeps a measured-latency attribution per component
(:class:`ClusterMeasuredExport`) that round-trips into the simulator.

Stacked, one card runs the N components as one program, so the *total*
step wall is measured and attributed to components in proportion to their corpus
share and allocated budget; per-step interference and straggler draws
model the co-located jobs the measurement cannot see, as
``serving.latency.ComponentModel`` does.  The engine clock advances by the
*parallel* completion time (the max over the gathered components), which
is what the frontend of an N-machine deployment would observe.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.control import (MODE_DROP, MODE_FULL, MODE_STAGE1,
                                 RetryPolicy, allocate_budget, make_predictor,
                                 realized_recovery)
from repro_torch.control.estimator import coverage_profile
from repro_torch.core.cluster import top_k
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.dist.topology import ComponentTopology, make_component_mesh
from repro_torch.kernels import ops
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.resilience import FaultPlan, FaultSpec
from repro_torch.serve.serve_step import make_serve_step

NEG_INF = ops.NEG_INF

__all__ = ["MODE_DROP", "MODE_STAGE1", "MODE_FULL", "allocate_budget",
           "ClusterConfig", "ClusterStepBackend", "ClusterMeasuredExport",
           "make_cluster_attention", "gain_rank", "gain_budgets"]


@dataclasses.dataclass
class ClusterConfig:
  """Scatter-gather tier knobs (the model's shape comes from its config)."""
  n_components: int = 4
  skew: float = 0.0            # Zipf exponent over component corpus shares
  alloc: str = "mass"          # "mass" (relevance mass) | "topk" (global by
                               # raw score) | "gain" (global by marginal
                               # accuracy gain: count-biased score)
  route: str = "fixed"         # per-slot cluster routing; "rotate" balances
  replicas: int = 1            # shard copies; R >= 2 enables hedged reissue
  predictor: str = "ewma"      # control-plane wall predictor
  recirculate: bool = True     # stranded-budget recirculation in allocate
  interference: float = 0.25   # lognormal sigma (co-located jobs, per step)
  straggler_prob: float = 0.02
  straggler_scale: float = 8.0
  use_mesh: Optional[bool] = None   # None: the mesh iff the world has
                                    # >= N ranks; True: the mesh or raise
  seed: int = 0
  # -- resilience (faults=None, recovery=True and retries=1 take the
  # plan/account path with no fault branch) ------------------------------
  faults: Optional[FaultSpec] = None   # injected fault world
  recovery: bool = True        # False: no retry, no stage-1 fallback: a
                               # dead shard stalls the gather and its mass
                               # is dropped (the chaos baseline)
  retries: int = 1             # bounded reissues per shard per step over
                               # the replica ring (needs replicas >= 2)
  retry_backoff: float = 0.5   # retry r waits timeout*backoff*mult^(r-1)
  retry_backoff_mult: float = 2.0
  fault_stall_wait: float = 3.0   # no recovery: the gather waits this many
                                  # step deadlines on a dead shard


# ---------------------------------------------------------------------------
# Frontend aggregator: global ranking and budget allocation across
# components.  Every op runs on the device with no host sync: the step's
# graph captures them.
# ---------------------------------------------------------------------------

def _frontend_rank(sc_all: torch.Tensor, i_max: int, ranked: bool = True):
  """Global ranking over the gathered per-component scores.

  ``sc_all`` (B, Hkv, N, Mp) with padded slots at NEG_INF.  Returns (gsel
  (B, Hkv, K) flat cluster ids with -1 pads, or None at budget 0, and the
  per-component relevance mass (B, Hkv, N)).  With ``ranked=False``
  (``alloc="mass"``, which reads the mass alone) the global top-k is
  skipped and ``gsel`` is True wherever it would be a tensor."""
  B, Hkv, N, Mp = sc_all.shape
  gmax = sc_all.amax(dim=(2, 3))                              # (B, Hkv)
  mass = torch.exp(sc_all - gmax[:, :, None, None]).sum(-1)
  if i_max <= 0:
    return None, mass
  if not ranked:
    return True, mass
  K = min(i_max, N * Mp)
  tsc, gsel = top_k(sc_all.reshape(B, Hkv, N * Mp), K)
  gsel = torch.where(tsc > NEG_INF / 2, gsel.to(torch.int32), -1)
  return gsel, mass


def gain_rank(sc_all: torch.Tensor, counts: torch.Tensor, i_max: int):
  """Marginal-accuracy-gain global ranking: greedy top-k on ``score +
  log(count)``, the share of the answer a cluster's refinement recovers.
  ``sc_all`` (B, Hkv, N, Mp) padded scores, ``counts`` (B, N, Mp).
  Returns flat global ids (B, Hkv, K) with -1 pads."""
  B, Hkv, N, Mp = sc_all.shape
  bias = torch.log(torch.clamp_min(counts.float(), 1e-30))[:, None]
  g = torch.where(sc_all > NEG_INF / 2, sc_all + bias, NEG_INF)
  K = min(i_max, N * Mp)
  tsc, gsel = top_k(g.reshape(B, Hkv, N * Mp), K)
  return torch.where(tsc > NEG_INF / 2, gsel.to(torch.int32), -1)


def gain_budgets(gsel: torch.Tensor, Mp: int, N: int) -> torch.Tensor:
  """Per-component budget implied by a global selection: how many of the
  selected flat ids land on each component; (B, Hkv, N) int32, summing
  to the number of non-pad selections."""
  comp_of = torch.where(gsel >= 0, gsel // Mp, -1)
  onehot = comp_of[..., None] == torch.arange(N, device=gsel.device)
  return onehot.to(torch.int32).sum(2)


def _select_local(sc: torch.Tensor, gsel, budgets, alloc: str, i_max: int,
                  Mp: int) -> torch.Tensor:
  """Every component's stage-2 selection at once: (B, N, Hkv, K) local
  cluster ids with -1 pads, from stage 1's scores ``sc`` (B, N, Hkv, Mp).

  ``alloc="topk"`` / ``"gain"``: component c refines exactly the globally
  selected clusters it owns (the two-level top-k; "topk" equals the
  single-component reference).  ``alloc="mass"``: component c refines its
  own top-scored clusters up to the budget the frontend allocated it
  (``budgets`` (B, Hkv, N))."""
  N = sc.shape[1]
  if alloc in ("topk", "gain"):
    comp_of = torch.where(gsel >= 0, gsel // Mp, -1)          # (B, Hkv, K)
    comps = torch.arange(N, device=gsel.device)[None, :, None, None]
    mine = comp_of[:, None] == comps                          # (B,N,Hkv,K)
    return torch.where(mine, (gsel % Mp)[:, None], -1).to(torch.int32)
  Kc = min(i_max, Mp)
  tsc, sel = top_k(sc, Kc)                                   # (B,N,Hkv,Kc)
  b_c = budgets.permute(0, 2, 1)[..., None]                   # (B, N, Hkv, 1)
  keep = (torch.arange(Kc, device=sc.device) < b_c) & (tsc > NEG_INF / 2)
  return torch.where(keep, sel.to(torch.int32), -1)


def _pick_mode(mode: torch.Tensor, full, syn):
  """Deadline-driven partial gather over partials with a component axis
  (B, N, ...): FULL -> the merged stage-1 + 2 partial, STAGE1 -> the
  synopsis answer alone, DROP -> a zero-weight partial.  ``mode`` (N,)."""
  out = []
  for f, s, fill in zip(full, syn, (0.0, NEG_INF, 0.0)):
    m = mode.view(1, -1, *([1] * (f.dim() - 2)))
    out.append(torch.where(m == MODE_FULL, f,
                           torch.where(m == MODE_STAGE1, s, fill)))
  return tuple(out)


def _extras_partial(q, csl, self_kv, *, sm_scale, cap):
  """The frontend's recent-ring + self-KV partial, merged once at the
  composer (never routed to a component, so a partial gather never loses
  the new token); ``flash_decode`` over the extras."""
  extras = ops.build_extras(csl.get("recent_k"), csl.get("recent_v"),
                            csl.get("recent_len"), self_kv)
  if extras is None:
    return None
  ek, ev, eb = extras
  # The bias at flash_decode's (B, Hkv, E) shape, made so (an expanded
  # view would be copied by the wrapper, every layer).
  bias = torch.where(eb[:, None, :] > NEG_INF / 2,
                     torch.zeros((1, ek.shape[1], 1), device=eb.device),
                     NEG_INF)
  return ops.decode_partials(q, ek, ev, bias, sm_scale=sm_scale, cap=cap)


def _frontend(sc_all, counts_g, fe_mode, alloc, i_max, *, recirculate,
              mode_caps):
  """The frontend aggregator on the gathered scores (every rank runs it on
  the same inputs): the global ranking, the mass, each component's budget
  and every component's stage-2 selection (B, N, Hkv, K) (None at budget
  0), with ``fe_cover`` (N,) from the selections, as the stacked body
  computes them."""
  B, Hkv, N, Mp = sc_all.shape
  gsel, mass = _frontend_rank(sc_all, i_max, ranked=alloc == "topk")
  if gsel is not None and alloc == "gain":
    gsel = gain_rank(sc_all, counts_g.view(B, N, Mp), i_max)
  if gsel is None:
    return None, mass, torch.zeros((N,), dtype=torch.float32,
                                   device=sc_all.device)
  budgets = None
  if alloc == "mass":
    caps = (sc_all > NEG_INF / 2).sum(-1)                     # (B, Hkv, N)
    if mode_caps:
      caps = torch.where(fe_mode[None, None, :] == MODE_FULL, caps, 0)
    budgets = allocate_budget(mass, i_max, caps, recirculate=recirculate)
  sel = _select_local(sc_all.permute(0, 2, 1, 3), gsel, budgets, alloc,
                      i_max, Mp)                              # (B,N,Hkv,K)
  return sel, mass, (sel >= 0).float().sum(-1).mean(dim=(0, 2))


def _aux(mass, cover, sc_all, counts_g, alloc, telemetry):
  """The per-layer telemetry: ``fe_cover``, ``fe_mass`` and, with
  ``telemetry``, the coverage profile over the global ranking."""
  B, Hkv, N, Mp = sc_all.shape
  mass_frac = mass / torch.clamp_min(mass.sum(-1, keepdim=True), 1e-30)
  aux = {"fe_cover": cover, "fe_mass": mass_frac.mean(dim=(0, 1))}
  if telemetry:
    aux["est_profile"] = coverage_profile(
        sc_all.reshape(B, Hkv, N * Mp), counts_g,
        rank="mass" if alloc == "gain" else "score")
  return aux


# ---------------------------------------------------------------------------
# The scatter-gather attention body, plugged into
# make_serve_step(attention_fn=...).
# ---------------------------------------------------------------------------

def make_cluster_attention(topo: ComponentTopology, alloc: str = "mass",
                           mesh=None, recirculate: bool = True,
                           mode_caps: bool = False,
                           telemetry: bool = False):
  """Returns ``attention_fn(q, cache_sl, ...) -> (ctx, aux)`` over the
  component layout of one layer (see the module doc):

    k / v          (B, N, Hkv, m_max*C, D)
    k_syn / v_syn  (B, N, Hkv, m_max, D)
    counts         (B, N, m_max)              0 on padded slots
    fe_mode        (N,) int32                 per-component gather mode

  ``aux`` carries per-layer telemetry: ``fe_cover`` (N,) mean refined
  clusters per component and ``fe_mass`` (N,) mean relevance-mass share;
  with ``telemetry`` (the ε-or-deadline contracts) also ``est_profile``
  (B, N*m_max+1), the stage-1 coverage profile over the global ranking.

  ``mode_caps``: a component gathered as STAGE1 / DROP never folds its
  refinement, so its allocation cap is zeroed and ``allocate_budget``'s
  recirculation respends that budget on the live FULL components (the
  resilient backend turns it on).

  With ``mesh`` (the port's ``Mesh`` with a ``component`` axis of N) the
  body is :func:`_cluster_sharded` on this rank's component: the layer's
  leaves without the component axis, ``k`` / ``v`` (B, Hkv, m_max*C, D)
  and so on, ``fe_mode`` whole.  Anything else given as ``mesh`` raises
  ``TypeError``."""
  if alloc not in ("mass", "topk", "gain"):
    raise ValueError(f"alloc {alloc!r} not in ('mass', 'topk', 'gain')")
  if mesh is not None:
    shd.require_mesh(mesh)
    if mesh.shape.get("component") != topo.n_components:
      raise ValueError(f"mesh {mesh.shape} has no component axis of "
                       f"{topo.n_components}")

  def attention(q, csl, *, i_max, cluster_size, sm_scale, cap=None,
                self_kv=None):
    if mesh is not None:
      return _cluster_sharded(
          q, csl, mesh, topo, alloc, i_max=i_max, cluster_size=cluster_size,
          sm_scale=sm_scale, cap=cap, self_kv=self_kv,
          recirculate=recirculate, mode_caps=mode_caps, telemetry=telemetry)
    return _cluster_stacked(
        q, csl, alloc, i_max=i_max, cluster_size=cluster_size,
        sm_scale=sm_scale, cap=cap, self_kv=self_kv,
        recirculate=recirculate, mode_caps=mode_caps, telemetry=telemetry)

  return attention


def _cluster_stacked(q, csl, alloc, *, i_max, cluster_size, sm_scale, cap,
                     self_kv, recirculate=True, mode_caps=False,
                     telemetry=False, kv_rows=None):
  """The N components as one launch of each stage over B*N rows: the math
  of the JAX stacked path's loop over the component axis.  With
  ``kv_rows`` (B*N,) (the fleet tier) ``csl["k"]`` / ``csl["v"]`` are a
  larger stack of shard rows, which stage 2 reads in place at those
  rows."""
  k_syn, counts = csl["k_syn"], csl["counts"]
  fe_mode = csl["fe_mode"]
  B, N, Hkv, Mp = k_syn.shape[:4]
  BN = B * N

  def fold(name):
    # B and N are the leading axes of a contiguous slice: a view, never a
    # copy (``view`` raises where ``reshape`` would copy).
    t = csl[name]
    if kv_rows is not None and name in ("k", "v"):
      return t
    return t.view(BN, *t.shape[2:])

  def scales(names):
    if names[0] not in csl:
      return None
    return tuple(fold(n) for n in names)

  syn_scales = scales(("k_syn_scale", "v_syn_scale"))
  # The query of each batch row, once for each of its components.
  q_rep = q[:, None].expand(B, N, *q.shape[1:]).reshape(BN, *q.shape[1:])
  counts_f = counts.view(BN, Mp)
  sc_f, p_syn = ops.synopsis_stage1(
      q_rep, fold("k_syn"), fold("v_syn"), counts_f, sm_scale=sm_scale,
      cap=cap, valid=counts_f > 0, syn_scales=syn_scales)
  sc_all = sc_f.view(B, N, Hkv, Mp).permute(0, 2, 1, 3)      # (B,Hkv,N,Mp)
  counts_g = counts.reshape(B, N * Mp)
  sel, mass, cover = _frontend(sc_all, counts_g, fe_mode, alloc, i_max,
                               recirculate=recirculate, mode_caps=mode_caps)
  p_full = p_syn
  if sel is not None:
    p_ref = ops.refine_stage2(
        q_rep, fold("k"), fold("v"), sel.reshape(BN, Hkv, -1),
        fold("k_syn"), fold("v_syn"), counts_f, cluster_size=cluster_size,
        sm_scale=sm_scale, cap=cap, syn_scales=syn_scales,
        kv_scales=scales(("k_scale", "v_scale")), kv_rows=kv_rows)
    p_full = ops.merge_partials(p_syn, p_ref)
  unfold = lambda p: tuple(t.view(B, N, *t.shape[1:]) for t in p)  # noqa: E731
  contrib = _pick_mode(fe_mode, unfold(p_full), unfold(p_syn))
  # Component order 0..N-1, then the extras: the order decides the last
  # bits, as in the JAX loop.
  acc = tuple(t[:, 0] for t in contrib)
  for c in range(1, N):
    acc = ops.merge_partials(acc, tuple(t[:, c] for t in contrib))
  p_ex = _extras_partial(q, csl, self_kv, sm_scale=sm_scale, cap=cap)
  if p_ex is not None:
    acc = ops.merge_partials(acc, p_ex)
  return acc[0], _aux(mass, cover, sc_all, counts_g, alloc, telemetry)


def _pick_one(mode, full, syn):
  """:func:`_pick_mode` for one component's partials (``mode`` a 0-d
  tensor)."""
  return tuple(torch.where(mode == MODE_FULL, f,
                           torch.where(mode == MODE_STAGE1, s, fill))
               for f, s, fill in zip(full, syn, (0.0, NEG_INF, 0.0)))


def _compose(parts, q, csl, self_kv, *, sm_scale, cap):
  """The result composer: the components' packed partials (N, B, H, D+2)
  folded in component order, then the frontend's extras partial."""
  acc = ops.unpack_partials(parts[0])
  for c in range(1, parts.shape[0]):
    acc = ops.merge_partials(acc, ops.unpack_partials(parts[c]))
  p_ex = _extras_partial(q, csl, self_kv, sm_scale=sm_scale, cap=cap)
  if p_ex is not None:
    acc = ops.merge_partials(acc, p_ex)
  return acc[0]


def _local_stage1(q, csl, sm_scale, cap):
  """This rank's stage 1 over its component's tables (padded slots, counts
  0, masked)."""
  syn_scales = (None if "k_syn_scale" not in csl else
                (csl["k_syn_scale"], csl["v_syn_scale"]))
  counts = csl["counts"]
  sc_l, p_syn = ops.synopsis_stage1(
      q, csl["k_syn"], csl["v_syn"], counts, sm_scale=sm_scale, cap=cap,
      valid=counts > 0, syn_scales=syn_scales)
  return sc_l, p_syn, syn_scales


def _local_stage2(q, csl, sel, syn_scales, *, cluster_size, sm_scale, cap):
  """This rank's stage 2 over its own shard of the clusters ``sel``."""
  kv_scales = (None if "k_scale" not in csl else
               (csl["k_scale"], csl["v_scale"]))
  return ops.refine_stage2(
      q, csl["k"], csl["v"], sel, csl["k_syn"], csl["v_syn"], csl["counts"],
      cluster_size=cluster_size, sm_scale=sm_scale, cap=cap,
      syn_scales=syn_scales, kv_scales=kv_scales)


def _cluster_sharded(q, csl, mesh, topo, alloc, *, i_max, cluster_size,
                     sm_scale, cap, self_kv, recirculate=True,
                     mode_caps=False, telemetry=False):
  """One rank = one component of the ``("component",)`` mesh: stage 1 over
  its own tables, one all-gather of the (B, Hkv, m_max) scores (and of the
  counts where the gain ranking or the coverage profile reads them), the
  frontend replicated on every rank, stage 2 over its own shard of the
  clusters it was given, its FULL / STAGE1 / DROP contribution, and one
  all-gather of the packed (o, m, l) partials folded in component order,
  then the extras.  Every rank returns the same (ctx, aux)."""
  N, Mp = topo.n_components, topo.m_max
  sid = mesh.axis_index("component")
  B, Hkv = csl["k_syn"].shape[:2]
  sc_l, p_syn, syn_scales = _local_stage1(q, csl, sm_scale, cap)
  sc_all = mesh.all_gather(sc_l, "component", dim=2).view(B, Hkv, N, Mp)
  counts_g = None
  if alloc == "gain" or telemetry:
    counts_g = mesh.all_gather(csl["counts"], "component", dim=1)
  fe_mode = csl["fe_mode"]
  sel, mass, cover = _frontend(sc_all, counts_g, fe_mode, alloc, i_max,
                               recirculate=recirculate, mode_caps=mode_caps)
  p_full = p_syn
  if sel is not None:
    p_ref = _local_stage2(q, csl, sel[:, sid].contiguous(), syn_scales,
                          cluster_size=cluster_size, sm_scale=sm_scale,
                          cap=cap)
    p_full = ops.merge_partials(p_syn, p_ref)
  contrib = _pick_one(fe_mode[sid], p_full, p_syn)
  parts = mesh.all_gather(ops.pack_partials(contrib), "component", dim=0,
                          tiled=False)
  ctx = _compose(parts, q, csl, self_kv, sm_scale=sm_scale, cap=cap)
  return ctx, _aux(mass, cover, sc_all, counts_g, alloc, telemetry)


# ---------------------------------------------------------------------------
# ServingEngine step backend: per-slot routing, plan/account around each
# dispatched step, measured-latency attribution per component.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _StepPlan:
  """One step's pre-dispatch gather decision and its noise draws (the same
  draws price the realized completion once the wall is measured).  The
  resilience fields (None on the path with no faults) carry the step's
  fault world and the recovery ladder's decisions, so ``account`` realizes
  exactly the retries ``plan_step`` dispatched.  The engine loads ``mode``
  into the backend's static ``fe_mode`` buffer before the step."""
  mode: np.ndarray             # (N,) int32 gather modes
  noise: np.ndarray            # per-component interference multipliers
  noise2: np.ndarray           # independent draws for the replica reissues
  hedged: np.ndarray           # (N,) bool: shard c's refinement reissued
  b_est: np.ndarray            # frontend's expected per-component budget
  deadline_ms: float
  retries: Optional[np.ndarray] = None   # (N,) reissues dispatched
  noise_r: Optional[np.ndarray] = None   # (K, N) per-retry draws
  delays: Optional[np.ndarray] = None    # (K, N) backoff dispatch offsets
  alive: Optional[np.ndarray] = None     # (N,) fault world: primary alive
  slow: Optional[np.ndarray] = None      # (N,) fault slowdown multipliers


class ClusterStepBackend:
  """``ServingEngine`` step backend running the scatter-gather tier.

  The engine calls ``plan_step`` (the frontend's gather decision from the
  calibrated per-component latency attribution and this step's
  interference draws), loads the modes, replays the bucket's graph, and
  calls ``account`` with the measured wall, which recalibrates the
  attribution and returns the step's accuracy contribution and the
  *parallel* completion time the engine clock advances by."""

  def __init__(self, ccfg: ClusterConfig):
    self.ccfg = ccfg
    self.engine = None

  # -- binding ---------------------------------------------------------------
  def bind(self, engine) -> None:
    """Called by ``ServingEngine.__init__`` once the shapes and the device
    are known."""
    cc = self.ccfg
    if cc.alloc not in ("mass", "topk", "gain"):
      raise ValueError(
          f"alloc {cc.alloc!r} not in ('mass', 'topk', 'gain')")
    if cc.route not in ("fixed", "rotate"):
      raise ValueError(f"route {cc.route!r} not in ('fixed', 'rotate')")
    if cc.retries < 0:
      raise ValueError(f"retries {cc.retries} < 0")
    self.engine = engine
    self.cfg = engine.cfg
    self.dev = engine.dev
    self.M = engine.M
    self.n_slots = engine.ecfg.n_slots
    self.prompt_len = engine.ecfg.prompt_len
    self.accuracy_fn = engine.accuracy_fn
    self.topo = ComponentTopology.plan(self.M, cc.n_components,
                                       skew=cc.skew, replicas=cc.replicas)
    self.mesh = self._make_mesh()
    # Resilience: the fault world, the bounded-retry policy over the
    # replica ring and mode-aware allocation caps.  The default config
    # (faults=None, recovery=True, retries=1) keeps ``resilient`` False and
    # skips every fault and recovery branch.
    self.faults = FaultPlan(cc.faults, cc.n_components)
    self.resilient = self.faults.enabled or cc.retries != 1 \
        or not cc.recovery
    self.retry_policy = RetryPolicy(max_retries=cc.retries,
                                    backoff_base=cc.retry_backoff,
                                    backoff_mult=cc.retry_backoff_mult)
    self.n_retries = cc.retries if cc.replicas > 1 and cc.recovery else 0
    if self.n_retries:
      # Retry r's holder: walk the shard's replica ring (retries beyond
      # the copies re-ask earlier holders after backoff).
      self.retry_of = np.asarray(
          [[self.topo.replica_owner(c, 1 + r % (cc.replicas - 1))
            for c in range(cc.n_components)]
           for r in range(self.n_retries)])
    else:
      self.retry_of = None
    self.step_idx = 0
    self.fault_stats = {"crash_steps": 0, "retries": 0,
                        "stage1_fallbacks": 0, "dropped": 0}
    # The contracts' coverage-profile telemetry, gated on the engine's
    # contract so that "deadline" step programs carry none.
    self.telemetry = engine.ecfg.contract != "deadline"
    self.attention = self._make_attention()
    # Per-component corpus share: the latency and accuracy attribution
    # weights.  Rotation mixes ownership over slots by shifts 0..n_slots-1,
    # so the attribution is the mean of those rotations of the plan.
    if cc.route == "rotate":
      self.comp_share = np.mean(
          [np.roll(self.topo.shares, s) for s in range(self.n_slots)],
          axis=0)
    else:
      self.comp_share = np.asarray(self.topo.shares)
    # One wall predictor per backend, shared with the engine's policy
    # (one predictor, one observation stream); the gather modes go through
    # the engine's DeadlineBudgetPolicy.
    self.predictor = make_predictor(cc.predictor)
    self.replica_of = np.asarray(
        [self.topo.replica_owner(c, 1) for c in range(cc.n_components)]) \
        if cc.replicas > 1 else None
    self.mass_ewma = self.comp_share.copy()
    # The private leaves' slot axes (the pool's others are as the
    # single-component pool has them).
    self._bx = kvc.slot_batch_axes(self.cfg, self.n_slots, self.prompt_len,
                                   synopsis=True)
    # The step's gather modes: a static device buffer (the graphs read its
    # address), loaded from pinned host memory before each replay.
    N = cc.n_components
    self.fe_mode = torch.full((N,), MODE_FULL, dtype=torch.int32,
                              device=self.dev)
    self._fe_host = torch.full((N,), MODE_FULL, dtype=torch.int32,
                               pin_memory=self.dev.type == "cuda")
    self.reseed(cc.seed)

  def _make_mesh(self):
    """The ``("component",)`` mesh when ``use_mesh`` is None and the world
    has N ranks or more, or ``use_mesh`` is True (fewer ranks raise);
    None (the stacked path) otherwise."""
    cc = self.ccfg
    if cc.use_mesh is False:
      return None
    mesh = make_component_mesh(cc.n_components)
    if mesh is None and cc.use_mesh:
      raise RuntimeError(
          f"use_mesh=True but the world has {world.world_size()} < "
          f"{cc.n_components} ranks; start {cc.n_components} (torchrun "
          f"--nproc-per-node {cc.n_components}, or "
          "repro_torch.dist.world.run_world)")
    return self._check_member(mesh)

  @staticmethod
  def _check_member(mesh):
    if mesh is not None and not mesh.member:
      raise RuntimeError(f"rank {mesh.rank} is outside the tier's mesh "
                         f"{mesh.shape} (ranks 0..{mesh.size - 1})")
    return mesh

  def _make_attention(self):
    cc = self.ccfg
    return make_cluster_attention(self.topo, alloc=cc.alloc, mesh=self.mesh,
                                  recirculate=cc.recirculate,
                                  mode_caps=self.resilient,
                                  telemetry=self.telemetry)

  def _holds(self, comp: int) -> bool:
    """Whether this rank's pool holds (row 0's) component ``comp``: every
    component stacked, its own on the mesh."""
    return self.mesh is None or comp == self.mesh.axis_index("component")

  @property
  def n_components(self) -> int:
    return self.ccfg.n_components

  def reseed(self, seed: int) -> None:
    """Re-seed the interference / straggler draws and rewind the fault
    world and the step counter: a window's draws and faults are a pure
    function of (config seed, window seed, step), whatever ran before."""
    self.rng = np.random.default_rng(
        np.random.SeedSequence([int(self.ccfg.seed),
                                int(seed) & 0x7fffffff]))
    self.step_idx = 0
    if getattr(self, "faults", None) is not None:
      self.faults.reseed(seed)

  def load_mode(self, mode: np.ndarray) -> None:
    """Copy a step's gather modes into the static ``fe_mode`` buffer
    (without waiting: the previous step's wait has freed the pinned
    buffer)."""
    self._fe_host.copy_(torch.from_numpy(np.asarray(mode, np.int32)))
    self.fe_mode.copy_(self._fe_host, non_blocking=True)

  def load_plan(self, plan: "_StepPlan") -> None:
    """Load a planned step's frontend inputs before its replay: the gather
    modes."""
    self.load_mode(plan.mode)

  # -- cache layout ----------------------------------------------------------
  def zeros_cache(self) -> Dict[str, torch.Tensor]:
    """The engine's slot pool, with the arena leaves in component layout
    (the others as ``kv_cache.zeros_cache`` has them)."""
    return {name: torch.zeros(sh, dtype=dt, device=self.dev)
            for name, (sh, dt) in self._pool_struct().items()}

  def _pool_struct(self) -> Dict[str, tuple]:
    """Each pool leaf's (shape, dtype): the arena leaves with the
    component axis after the slot axis (on a mesh, without it: the rank's
    own component)."""
    C = self.cfg.synopsis.cluster_size
    N, Mp = self.topo.n_components, self.topo.m_max
    lane = () if self.mesh is not None else (N,)
    out = {}
    for name, (sh, dt, _) in kvc.cache_struct(
        self.cfg, self.n_slots, self.prompt_len, synopsis=True).items():
      if name in ("k", "v"):
        nb, na, B, Hkv, _, D = sh
        sh = (nb, na, B, *lane, Hkv, Mp * C, D)
      elif name in ("k_syn", "v_syn"):
        nb, na, B, Hkv, _, D = sh
        sh = (nb, na, B, *lane, Hkv, Mp, D)
      elif name == "counts":
        sh = sh[:3] + lane + (Mp,)
      elif name in kvc.ARENA_LEAVES:        # a quantized arena's scales
        sh = sh[:3] + lane + (sh[3], Mp)
      out[name] = (tuple(sh), dt)
    return out

  def _lane(self, cache, name: str, slot: int, comp: int):
    """The (nb, na, ...) view of slot ``slot``'s component ``comp`` in the
    pool leaf ``name``, or None where this rank does not hold it."""
    if self.mesh is not None:
      return cache[name][:, :, slot] if self._holds(comp) else None
    return cache[name][:, :, slot, comp]

  def write_slot(self, cache, syn, slot: int):
    """Route one request's built (B = 1, cluster-contiguous) synopsis cache
    into lane ``slot``: component c's range of clusters into its shard,
    padded to m_max with zeros (counts 0 on pads), in place (on a mesh,
    the rank's own component only).  With ``route="rotate"`` slot s's
    range r lands on component (r + s) % N.  The private leaves (ring,
    ``pos``, SSM state) are written as the single-component pool writes
    them.  A corpus-cache arena is the pre-scatter canonical state, so it
    scatters as a fresh build does."""
    self._scatter(syn, slot,
                  lambda name, comp: self._lane(cache, name, slot, comp))
    private = {k: v for k, v in syn.items() if k not in kvc.ARENA_LEAVES}
    return kvc.write_slot(cache, private, slot, self._bx)

  def _scatter(self, syn, slot: int, dst_of) -> None:
    """Scatter the arena leaves of ``syn`` over the components of slot
    ``slot`` into the views ``dst_of(name, comp)`` (nb, na, ...), None
    where this rank holds no copy of component ``comp``, in place (see
    :meth:`write_slot`)."""
    C = self.cfg.synopsis.cluster_size
    topo = self.topo
    N = topo.n_components
    rotate = self.ccfg.route == "rotate"
    for name in kvc.ARENA_LEAVES:
      if name not in syn:
        continue
      src = syn[name][:, :, 0]
      unit = C if name in ("k", "v") else 1
      # The cluster axis: the last of counts and the scales, else the one
      # before D.
      axis = -1 if src.dim() in (3, 4) else -2
      for r in range(N):
        comp = (r + slot) % N if rotate else r
        d = dst_of(name, comp)
        if d is None:
          continue
        off, cnt = topo.offsets[r] * unit, topo.counts[r] * unit
        d.narrow(axis, 0, cnt).copy_(src.narrow(axis, off, cnt))
        if d.shape[axis] > cnt:
          d.narrow(axis, cnt, d.shape[axis] - cnt).zero_()

  # -- the step --------------------------------------------------------------
  def step_fn(self, budget: int):
    """The serve step at ``budget`` over the component layout: ``run(params,
    cache, tok) -> (logits, st)``, reading the gather modes from the static
    ``fe_mode`` buffer (a graph input like the token column), so gather
    decisions never recapture."""
    step = make_serve_step(self.cfg, mode="synopsis", i_max=budget,
                           attention_fn=self.attention)
    fe_mode = self.fe_mode

    def run(params, cache, tok):
      return step(params, {**cache, "fe_mode": fe_mode}, tok)

    return run

  def full_mode(self) -> np.ndarray:
    return np.full((self.topo.n_components,), MODE_FULL, np.int32)

  # -- frontend plan / account ----------------------------------------------
  def _units(self, b_vec: np.ndarray) -> np.ndarray:
    """Rows-read compute attribution per component: stage 1 streams the
    component's ``share_c * M`` centroids, refinement ``b_c`` clusters of
    C tokens each."""
    C = self.cfg.synopsis.cluster_size
    return self.comp_share * self.M + np.maximum(b_vec, 0.0) * C

  def _draw_noise(self) -> np.ndarray:
    """One (N,) interference + straggler multiplier draw.  Two draws a step
    (primary and replica path) are consumed whatever the replication
    factor, so R=1 and R=2 runs with the same seeds see the same primary
    noise world."""
    cc = self.ccfg
    N = self.topo.n_components
    noise = self.rng.lognormal(0.0, cc.interference, N)
    return np.where(self.rng.random(N) < cc.straggler_prob,
                    noise * cc.straggler_scale, noise)

  def _hedge_time(self, wall: float, u: np.ndarray, usum: float,
                  noise: np.ndarray, noise2: np.ndarray) -> np.ndarray:
    """Completion of shard c's reissue on its replica j = replica_of[c]:
    j first finishes its own shard (u[j] at noise[j], the draw that prices
    j's own completion), then streams c's stage 1 and granted clusters
    again (u[c]) under the reissue's draw noise2[j].  One expression for
    the hedging decision and the realized accounting."""
    j = self.replica_of
    return wall * (u[j] * noise[j] + u * noise2[j]) / usum

  def _retry_times(self, wall: float, u: np.ndarray, usum: float,
                   noise: np.ndarray, noise_r: np.ndarray,
                   slow: np.ndarray, delays: np.ndarray) -> np.ndarray:
    """Completion of shard c's retry r on holder jr = retry_of[r, c]:
    dispatched after the backoff delay, the holder first finishes its own
    shard (at its fault slowdown and its own draw), then streams c's work
    again under the retry's draw.  The K=1 / delay-0 / no-fault row is
    ``_hedge_time``; one expression for plan_step and account."""
    jr = self.retry_of                                        # (K, N)
    nr = np.take_along_axis(noise_r, jr, axis=1)              # (K, N)
    return delays + wall * (u[jr] * slow[jr] * noise[jr]
                            + u[None, :] * slow[jr] * nr) / usum

  def plan_step(self, budget: int, step_deadline_ms: float) -> _StepPlan:
    """Pre-dispatch gather decision: predict each component's completion
    (the wall predictor for this bucket, attributed by rows read, times
    this step's draws), hedge the predicted stragglers onto their shard
    replicas (R >= 2), and let the policy mark the components that still
    miss the step deadline STAGE1 (accuracytrader) or DROP (partial).
    With resilience on, the recovery ladder (``recover_modes``) decides:
    dead primaries and predicted stragglers retry on the replica ring with
    backoff, and a shard with no live path degrades to its stage-1
    synopsis (accuracytrader) or is dropped (partial)."""
    massf = self.mass_ewma / max(self.mass_ewma.sum(), 1e-30)
    b_est = float(budget) * massf
    u = self._units(b_est)
    usum = max(u.sum(), 1e-30)
    noise, noise2 = self._draw_noise(), self._draw_noise()
    wall = self.predictor.predict(budget)
    if not self.resilient:
      t_pred = wall * (u / usum) * noise
      t_hedged = None
      if self.replica_of is not None:
        t_hedged = self._hedge_time(wall, u, usum, noise, noise2)
      mode, hedged = self.engine.controller.gather_modes(
          t_pred, step_deadline_ms, t_hedged)
      return _StepPlan(mode=mode, noise=noise, noise2=noise2, hedged=hedged,
                       b_est=b_est, deadline_ms=step_deadline_ms)
    fstate = self.faults.at(self.step_idx)
    alive, slow = fstate.alive, fstate.slow
    t_base = wall * (u / usum)           # per-component predictor timeout
    t_pred = t_base * noise * slow
    k = self.n_retries
    t_retry = retry_alive = delays = noise_r = None
    if k:
      noise_r = np.stack([noise2] + [self._draw_noise()
                                     for _ in range(k - 1)])
      delays = self.retry_policy.delays(t_base)               # (K, N)
      t_retry = self._retry_times(wall, u, usum, noise, noise_r, slow,
                                  delays)
      retry_alive = alive[self.retry_of]
    mode, retries, _ = self.engine.controller.recover_modes(
        t_pred, step_deadline_ms, t_retry=t_retry, alive=alive,
        retry_alive=retry_alive)
    if not self.ccfg.recovery:
      # Chaos baseline: no retries and no synopsis fallback; a dead
      # shard's mass drops (its stall is priced in account).
      mode = np.where(alive, mode, MODE_DROP).astype(np.int32)
      retries = np.zeros_like(retries)
    return _StepPlan(mode=mode, noise=noise, noise2=noise2,
                     hedged=retries > 0, b_est=b_est,
                     deadline_ms=step_deadline_ms, retries=retries,
                     noise_r=noise_r, delays=delays, alive=alive, slow=slow)

  def account(self, budget: int, wall_ms: float, plan: _StepPlan, st,
              warming: bool = False) -> Dict[str, float]:
    """Post-step accounting: fold the measured wall into the predictor,
    attribute it to components by the rows actually refined (``st``'s
    ``fe_cover`` / ``fe_mass``, (nb, na, N) on the host), take the hedged
    or retried minimum where the plan reissued, and return the parallel
    completion time (the max over the gathered components' times) and the
    step's accuracy contribution."""
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
    f = u / usum
    u0 = self._units(np.zeros_like(cover))       # stage-1-only compute
    f0 = u0 / usum
    if plan.alive is None:
      t_real = wall_ms * f * plan.noise
      if self.replica_of is not None and plan.hedged.any():
        # A hedged shard completes at the earlier of the primary and its
        # replica's reissue, priced as at plan time.
        t_hedge = self._hedge_time(wall_ms, u, usum, plan.noise,
                                   plan.noise2)
        t_real = np.where(plan.hedged, np.minimum(t_real, t_hedge),
                          t_real)
      done_full = t_real
    else:
      # The same fault world, draws and backoff delays that made the plan
      # price the completions; retry r counts only where it was dispatched.
      slow = plan.slow
      t_real = wall_ms * f * plan.noise * slow
      t_retry_real = retry_alive = None
      if plan.noise_r is not None:
        t_retry_real = self._retry_times(wall_ms, u, usum, plan.noise,
                                         plan.noise_r, slow, plan.delays)
        retry_alive = plan.alive[self.retry_of]
      done_full = realized_recovery(t_real, t_retry_real, plan.retries,
                                    plan.alive, retry_alive)
    t_stage1 = wall_ms * f0 * plan.noise
    done = np.where(full, done_full,
                    np.where(plan.mode == MODE_STAGE1, t_stage1, 0.0))
    if plan.alive is not None and not self.ccfg.recovery \
        and not plan.alive.all():
      # No recovery: the frontend waits on a dead shard until a hard
      # timeout (fault_stall_wait step deadlines), then drops its mass.
      wait = plan.deadline_ms if np.isfinite(plan.deadline_ms) else wall_ms
      done = np.where(plan.alive, done,
                      self.ccfg.fault_stall_wait * max(wait, wall_ms))
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
    retried = int(plan.retries.sum()) if plan.retries is not None \
        else int(plan.hedged.sum())
    if plan.alive is not None and not warming:
      self.fault_stats["crash_steps"] += int(not plan.alive.all())
      self.fault_stats["retries"] += retried
      self.fault_stats["stage1_fallbacks"] += int(np.sum(
          (plan.mode == MODE_STAGE1) & ~plan.alive))
      self.fault_stats["dropped"] += int(np.sum(plan.mode == MODE_DROP))
    self.step_idx += 1
    return {"parallel_ms": parallel_ms, "step_acc": step_acc,
            "wall_ms": wall_ms, "gathered": int(full.sum()),
            "hedged": int(plan.hedged.sum()), "comp_ms": done,
            "drop_share": drop_share, "retried": retried}

  def export(self, full_items: int = 100) -> "ClusterMeasuredExport":
    return ClusterMeasuredExport(self, full_items=full_items)


class ClusterMeasuredExport:
  """Measured per-component step latencies for the discrete-event
  simulator, the cluster tier's counterpart of
  ``serve.engine.MeasuredStepBackend``.

  ``step_ms_per_component(budget)`` is the (N,) vector the simulator feeds
  into ``ComponentModel.submit(service_ms=...)`` (each simulated component
  indexes its own entry); ``step_ms(budget)`` the frontend-observed
  parallel completion (the max).  A simulator budget out of
  ``full_items`` rescales onto the tier's M clusters; the nearest measured
  bucket's predicted wall (a snapshot of the backend's predictor) is
  attributed by rows read."""

  def __init__(self, backend: ClusterStepBackend, full_items: int = 100):
    self.share = backend.comp_share.copy()
    self.massf = backend.mass_ewma / max(backend.mass_ewma.sum(), 1e-30)
    self.walls = backend.predictor.table() or {0: 5.0}
    self.M = backend.M
    self.cluster_size = backend.cfg.synopsis.cluster_size
    self.full_items = full_items
    self.n_components = backend.topo.n_components

  def step_ms_per_component(self, budget: int) -> np.ndarray:
    b = budget / max(self.full_items, 1) * self.M
    nearest = min(self.walls, key=lambda x: abs(x - b))
    u = self.share * self.M + b * self.massf * self.cluster_size
    return self.walls[nearest] * u / max(u.sum(), 1e-30)

  def step_ms(self, budget: int) -> float:
    return float(self.step_ms_per_component(budget).max())

"""Decode (serve) step: one new token against a KV cache (counterpart of
``repro.serve.serve_step``: GQA attention layers, mamba layers, MLP or
MoE FFNs, sequential or parallel blocks).

``mode="synopsis"``: per attention layer the AccuracyTrader decode
attention runs the fused two-stage pipeline of
``kernels.ops.synopsis_cache_attention``: stage-1 centroid scoring plus the
count-biased initial result, ``top_k`` over the scores, stage-2 exact
refinement over the selected clusters with the recent ring and the new
token's self-KV folded in, one merge.

``mode="exact"``: the paper's exact baseline.  The layer cache holds only
``k``/``v``; ``flash_decode`` runs over all of it and once more over the
new token's self-KV (S = 1), and the two partials merge.

A local (sliding-window) layer (gemma2) runs the exact decode in both
modes, over the last ``cfg.sliding_window`` rows of the layer's ``k``/``v``
as given, as the JAX step does: in synopsis mode that is the
cluster-sorted cache, so the window is the last clusters in sorted order
(after an absorb the absorbed ones), not the most recent tokens, and the
recent ring is not read.  The window is a strided view that
``flash_decode`` reads in place.  Every attention logit takes
``cfg.attn_softcap`` and the logits ``cfg.logit_softcap``.

A layer with a cross block (whisper) then runs it in both modes, after
the self-attention residual and before the MLP: exact decode over all of
the layer's ``cross_k``/``cross_v`` with a query that has ``bq`` and no
rope, as the JAX step does.  In the loop those are the decoder's own
prompt KV from the causal "cross" prefill; with frames, the encoder's.

``attention_fn`` replaces the synopsis decode attention (the engine's
contract telemetry, the scatter-gather tier of ``serve.cluster``): it
returns ``(ctx, aux)``, and each per-layer ``aux`` leaf comes out of the
step stacked over the layers that run it (nb, the global positions of the
pattern, ...): local layers do not call it.  Cache leaves whose names start
with ``fe_`` (frontend inputs: the tier's per-component gather modes) reach
every such layer whole, not sliced.  Without one the step is the plain
one, op for op.

A mamba layer (mamba2, jamba) runs ``models.ssm.ssm_forward``'s S = 1
decode from the cache's ``conv_state`` / ``ssd_state`` in both modes, and
an MoE layer its FFN over the step's B rows (capacity 1 at jamba's B <= 6
and arctic's B <= 102: the rows of the step change each other's output,
as in the reference), plus arctic's dense MLP or deepseek's shared
experts beside the experts.  An MLA layer (deepseek) decodes absorbed
(:func:`_mla_decode_layer`): an f32 query of all H heads over the latent
cache's one key/value head, in either mode.  A
parallel block (command-r) adds the FFN of the same ``ln1``-normed input
beside the attention output, in both modes.
The attention index ``ai`` and the mamba index ``si`` count separately:
the cache stacks k / v and the synopsis over the attention positions, the
SSM state over the mamba positions.

Under a mesh (``dist.sharding.use_mesh``) whose rule table shards the
cache's sequence axis (``SERVE_RULES``: over `model`; ``LONG_RULES``: over
``(data, model)``), each rank holds its shard of the cache
(:func:`shard_cache`) and a global layer's synopsis decode is
:func:`sharded_synopsis_attention`: the paper's scatter-gather over the
ranks, with every rank running the same step on its own shard.  Exact
decode on such a shard (``mode="exact"``, and a local layer's window in
either mode) is :func:`sharded_exact_decode_attention`: each rank's
partial over its rows (of the global window), one all-gather of the
partials, merged in shard order.  A sequence-cut shard with no mesh
installed raises: computed alone it would give the shard's answer, not
the global one.

A quantized arena's scale leaves (``kernels/quant.py``) ride in the layer
slice when the cache has them.  The cache is read-only inside the step;
the new token's per-layer KV comes back as ``k_delta``/``v_delta`` for the
loop to append, and the mamba layers' new state as ``conv_state`` /
``ssd_state`` (the whole state, not a difference), which the loop drops
and the engine writes back per slot, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import quant as qt
from repro_torch.kernels.ref import acc_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.serve import kv_cache as kvc

# Per-layer cache leaves each mode reads; a layer with a cross block
# (whisper) also reads CROSS_LEAVES, in both modes.
LAYER_LEAVES = {"synopsis": ("k", "v", "k_syn", "v_syn", "counts",
                             "recent_k", "recent_v"),
                "exact": ("k", "v")}
CROSS_LEAVES = ("cross_k", "cross_v")


def synopsis_decode_attention(
    q: torch.Tensor,                      # (B, H, D) rope'd queries
    cache: Dict[str, torch.Tensor],       # this layer's slice
    *,
    i_max: int,
    cluster_size: int,
    sm_scale: float,
    cap: Optional[float] = None,
    self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_scores: bool = False,
):
  """AccuracyTrader Algorithm 1 on a KV cache; returns (B, H, D) f32, and
  with ``return_scores`` also stage 1's scores (B, Hkv, M)."""
  self_k, self_v = self_kv if self_kv is not None else (None, None)
  return ops.synopsis_cache_attention(
      q, cache["k"], cache["v"], cache["k_syn"], cache["v_syn"],
      cache["counts"], cache.get("recent_k"), cache.get("recent_v"),
      cache.get("recent_len"), self_k, self_v, cache.get("k_syn_scale"),
      cache.get("v_syn_scale"), cache.get("k_scale"), cache.get("v_scale"),
      i_max=i_max, cluster_size=cluster_size, sm_scale=sm_scale, cap=cap,
      return_scores=return_scores)


def _seq_axes() -> Tuple[str, ...]:
  """Mesh axes the cache's sequence dim is sharded over (the active rule
  table's ``kv_seq``)."""
  t = shd.rules_dict().get("kv_seq")
  if t is None:
    return ()
  return (t,) if isinstance(t, str) else tuple(t)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
  """How a cache is cut over a mesh, decided once from its global shapes
  (the reference's dispatch): ``seq_axes`` () keeps it whole (no sequence
  axis in the rules, M not divisible by the shard count, or one shard);
  ``dp_axes`` () keeps the batch whole (B not divisible by the
  data-parallel size)."""
  seq_axes: Tuple[str, ...]
  nshards: int
  dp_axes: Tuple[str, ...]
  dp_n: int
  m_total: int
  batch: int


def shard_layout(mesh, seq_axes, M: int, B: int) -> ShardLayout:
  """The reference's dispatch: the cache's M clusters spread over
  ``seq_axes`` (those in the mesh) when they divide evenly over more than
  one shard, and its batch over the mesh's `pod` / `data` axes not taken
  by the sequence when B divides evenly."""
  axes = tuple(a for a in seq_axes if mesh is not None and a in mesh.shape)
  n = math.prod(mesh.shape[a] for a in axes) if axes else 1
  if not axes or M % n != 0 or n == 1:
    return ShardLayout((), 1, (), 1, M, B)
  dp = tuple(a for a in ("pod", "data") if a in mesh.shape and a not in axes)
  dp_n = math.prod(mesh.shape[a] for a in dp) if dp else 1
  if B % dp_n != 0:
    dp, dp_n = (), 1
  return ShardLayout(axes, n, dp, dp_n, M, B)


# Each cache leaf's (batch axis, sequence axis, the sequence axis's rows a
# cluster), from the end: the same for a layer's slice (B, Hkv, S, D) and
# the whole cache (nb, na, B, Hkv, S, D).  None: the leaf has no such axis.
# The cross leaves (whisper) are cut by batch only; the SSM state also by
# its ``ssm_heads`` axis (``_HEAD_AXES``), as a rank's mamba weights are.
_SHARD_AXES = {"k": (-4, -2, "C"), "v": (-4, -2, "C"),
               "k_syn": (-4, -2, 1), "v_syn": (-4, -2, 1),
               "counts": (-2, -1, 1),
               "k_syn_scale": (-3, -1, 1), "v_syn_scale": (-3, -1, 1),
               "k_scale": (-3, -1, 1), "v_scale": (-3, -1, 1),
               "recent_k": (-4, None, 0), "recent_v": (-4, None, 0),
               "recent_len": (-1, None, 0), "pos": (-1, None, 0),
               "cross_k": (-4, None, 0), "cross_v": (-4, None, 0),
               "conv_state": (-3, None, 0), "ssd_state": (-4, None, 0)}


# The SSM state's ``ssm_heads`` dim, from the end, and the leaf's logical
# axes (``kv_cache``): cut as the rule table cuts it, the rank's block at
# its combined index, as ``dist.sharding.shard_params`` cuts the mixer's
# conv channels and heads.
_HEAD_AXES = {"conv_state": (-1, kvc.SSM_CONV_AXES),
              "ssd_state": (-3, kvc.SSM_STATE_AXES)}


def _cache_units(cache: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
  """(units the sequence is cut in, batch, rows a unit) of a global cache:
  a synopsis cache's M clusters of C rows; an exact cache's S rows; a
  cache with no attention leaf (mamba2) one unit, so its sequence is never
  cut."""
  if "counts" in cache:
    M, B = cache["counts"].shape[-1], cache["counts"].shape[-2]
    return M, B, cache["k"].shape[-2] // M
  if "k" in cache:
    return cache["k"].shape[-2], cache["k"].shape[-4], 1
  return 1, cache["pos"].shape[-1], 1


def shard_cache(cache: Dict[str, torch.Tensor], mesh, rules
                ) -> Dict[str, torch.Tensor]:
  """This rank's shard of a global decode cache (one layer's slice or the
  whole cache) under ``rules`` on ``mesh``.  A synopsis cache: M/n clusters
  of the centroid tables, counts and scales, their S/n rows of the sorted k
  / v, and the rank's batch rows of every leaf (:func:`shard_layout`'s
  dispatch); the recent ring, ``recent_len`` and ``pos`` are cut by batch
  only.  An exact cache: S/n rows of k / v (the same dispatch over its S
  rows).  The cross leaves are cut by batch only, the SSM state by batch
  and by its ``ssm_heads`` dim where the rules cut that (conv channels
  and SSD heads: the rank's block, as its mamba weights); a cache with no
  attention leaf (mamba2) by batch over the mesh's `pod` / `data` axes
  where B divides.  The shard's leaves are contiguous copies,
  and its ``"layout"`` entry (a :class:`ShardLayout`) tells the decode
  attention how it was cut.  A leaf not listed in ``_SHARD_AXES`` is
  refused where the batch is cut."""
  mesh = shd.require_mesh(mesh)
  M, B, C = _cache_units(cache)
  with shd.use_mesh(mesh, rules):
    layout = shard_layout(mesh, _seq_axes(), M, B)
  if "k" not in cache:
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp_n = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if dp and B % dp_n == 0 and dp_n > 1:
      layout = ShardLayout((), 1, dp, dp_n, M, B)
  sid = mesh.index(layout.seq_axes) if layout.seq_axes else 0
  bid = mesh.index(layout.dp_axes) if layout.dp_axes else 0
  out = {}
  for name, x in cache.items():
    if name == "layout":
      raise ValueError("the cache is already a rank's shard")
    axes = _SHARD_AXES.get(name)
    if axes is None:
      if layout.dp_n > 1:
        raise ValueError(f"shard_cache: no batch axis known for {name!r}")
      out[name] = x
      continue
    b_ax, s_ax, unit = axes
    if layout.dp_n > 1:
      n = B // layout.dp_n
      x = x.narrow(b_ax, bid * n, n)
    if s_ax is not None and layout.nshards > 1:
      rows = (M // layout.nshards) * (C if unit == "C" else unit)
      x = x.narrow(s_ax, sid * rows, rows)
    if name in _HEAD_AXES:
      h_ax, logical = _HEAD_AXES[name]
      full = cache[name].shape
      spec = shd.mesh_axes_for(logical[-len(full):], mesh, rules, shape=full)
      axes = shd.axes_of(spec[h_ax])
      if axes:
        n = full[h_ax] // mesh.axis_size(axes)
        x = x.narrow(h_ax, mesh.index(axes) * n, n)
    # A copy even where nothing was cut: the shard never aliases the
    # global cache (the loop appends to its ring in place).
    out[name] = x.clone(memory_format=torch.contiguous_format)
  out["layout"] = layout
  return out


def sharded_synopsis_attention(
    q: torch.Tensor,                      # (B_local, H, D)
    cache: Dict[str, torch.Tensor],       # this rank's shard of a layer
    *,
    i_max: int,
    cluster_size: int,
    sm_scale: float,
    cap: Optional[float] = None,
    self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
  """AccuracyTrader decode attention with the cache and its synopsis
  sharded over the mesh: the paper's n-component scatter-gather, one rank
  a component.  Every rank scores its own M/n centroids (stage 1, the
  fused kernel), the *global* ranking comes from one all-gather of the
  (B, Hkv, M/n) scores, each rank refines only the selected clusters it
  owns (stage 2 over its S/n rows; the recent ring and the self token fold
  into shard 0's launch only), and one all-gather of the (o, m, l)
  partials, folded by ``merge_partials`` in shard order, composes the
  result.  Returns this rank's batch rows (B_local, H, D), the same on every
  rank of a batch group.

  ``cache`` is a rank's shard as :func:`shard_cache` cut it: its
  ``"layout"`` carries the reference's dispatch (the sequence axes it was
  cut over and the batch's), so a cache it kept whole
  (no sequence axes, M % n != 0, one shard), or with no layout, runs the
  single-device path, and a batch it kept whole is computed whole."""
  mesh = shd.current_mesh()
  layout = cache.get("layout")
  plain = {k: x for k, x in cache.items() if k != "layout"}
  _require_mesh_for(layout, mesh)
  if mesh is None or layout is None or not layout.seq_axes:
    return synopsis_decode_attention(
        q, plain, i_max=i_max, cluster_size=cluster_size, sm_scale=sm_scale,
        cap=cap, self_kv=self_kv)
  axes = layout.seq_axes
  sid = mesh.index(axes)
  k_syn, v_syn, counts = plain["k_syn"], plain["v_syn"], plain["counts"]
  B, Hkv, M_local = k_syn.shape[:3]
  M = layout.m_total
  syn_scales, kv_scales = ops._pairs(
      plain.get("k_syn_scale"), plain.get("v_syn_scale"),
      plain.get("k_scale"), plain.get("v_scale"))
  # Stage 1 (fused) over the local centroids; one small all-gather for the
  # global ranking.
  sc_local, p_syn = ops.synopsis_stage1(
      q, k_syn, v_syn, counts, sm_scale=sm_scale, cap=cap,
      syn_scales=syn_scales)
  sc = mesh.all_gather(sc_local, axes, dim=2)                 # (B, Hkv, M)
  if i_max > 0:
    selected = torch.topk(sc, min(i_max, M), dim=-1).indices
    # Stage 2 refines only the selected clusters this shard owns.
    rel = selected - sid * M_local
    sel = torch.where((rel >= 0) & (rel < M_local), rel, -1).to(torch.int32)
  else:
    sel = torch.full((B, Hkv, 1), -1, dtype=torch.int32, device=q.device)
  extras = ops.build_extras(plain.get("recent_k"), plain.get("recent_v"),
                            plain.get("recent_len"), self_kv)
  if extras is not None and sid != 0:
    ek, ev, eb = extras                   # counted once: on shard 0
    extras = (ek, ev, torch.full_like(eb, ops.NEG_INF))
  p_ref = ops.refine_stage2(
      q, plain["k"], plain["v"], sel, k_syn, v_syn, counts,
      cluster_size=cluster_size, sm_scale=sm_scale, cap=cap, extras=extras,
      syn_scales=syn_scales, kv_scales=kv_scales)
  # The result composer: one all-gather of the packed partials, folded in
  # shard order.
  parts = mesh.all_gather(ops.pack_partials(ops.merge_partials(p_syn, p_ref)),
                          axes, dim=0, tiled=False)           # (n,B,H,D+2)
  acc = ops.unpack_partials(parts[0])
  for p in parts[1:]:
    acc = ops.merge_partials(acc, ops.unpack_partials(p))
  return acc[0]


def _require_mesh_for(layout: Optional[ShardLayout], mesh) -> None:
  """A shard whose sequence was cut needs its mesh: alone it would give
  the shard's answer."""
  if layout is not None and layout.seq_axes and mesh is None:
    raise RuntimeError(
        f"a rank's shard of the cache (its sequence cut over "
        f"{layout.seq_axes}) decoded with no mesh installed (use_mesh): "
        "attention over the shard alone is not the global answer")


def _empty_partials(q: torch.Tensor):
  """The partials of no key: o 0, m NEG_INF, l 0 (the merge's identity)."""
  B, H, D = q.shape
  f32 = dict(dtype=torch.float32, device=q.device)
  return (torch.zeros((B, H, D), **f32),
          torch.full((B, H), ops.NEG_INF, **f32), torch.zeros((B, H), **f32))


def sharded_exact_decode_attention(
    q: torch.Tensor,                      # (B_local, H, D)
    k: torch.Tensor,                      # (B_local, Hkv, S/n, D) a shard
    v: torch.Tensor,
    layout: ShardLayout,
    *,
    sm_scale: float,
    cap: Optional[float] = None,
    self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
  """Exact decode attention over a cache whose sequence is cut over the
  mesh (``layout.seq_axes``, shard ``sid`` of n holding global rows [sid
  S/n, (sid + 1) S/n)): each rank's ``flash_decode`` partials over its
  rows, or with ``window`` (a local layer) over its rows among the global
  last ``window`` rows, the empty partial where it holds none; the new
  token's self partial folds into shard 0's only; one all-gather of the
  packed partials, merged in shard order, gives every rank the global
  answer (B_local, H, D) f32.  With no mesh installed it raises."""
  mesh = shd.current_mesh()
  _require_mesh_for(layout, mesh)
  axes = layout.seq_axes
  sid = mesh.index(axes)
  rows = k.shape[2]
  lo, S = sid * rows, rows * layout.nshards
  start = lo if window is None else max(lo, S - window)
  if start < lo + rows:
    part = ops.decode_partials(q, k[:, :, start - lo:], v[:, :, start - lo:],
                               sm_scale=sm_scale, cap=cap)
  else:
    part = _empty_partials(q)
  if self_kv is not None and sid == 0:
    part = ops.merge_partials(part, ops.decode_partials(
        q, self_kv[0], self_kv[1], sm_scale=sm_scale, cap=cap))
  parts = mesh.all_gather(ops.pack_partials(part), axes, dim=0,
                          tiled=False)                        # (n,B,H,D+2)
  acc = ops.unpack_partials(parts[0])
  for p in parts[1:]:
    acc = ops.merge_partials(acc, ops.unpack_partials(p))
  return acc[0]


def exact_decode_attention(
    q: torch.Tensor,                      # (B, H, D)
    k: torch.Tensor,                      # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    sm_scale: float,
    cap: Optional[float] = None,
    self_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
  """Exact attention over the cache (its last ``window`` rows, a view) and
  the new token; (B, H, D) f32.  The one-token self partial goes through
  the same kernel (S = 1)."""
  if window is not None and window < k.shape[2]:
    k = k[:, :, -window:]
    v = v[:, :, -window:]
  out = ops.decode_partials(q, k, v, sm_scale=sm_scale, cap=cap)
  if self_kv is not None:
    out = ops.merge_partials(
        out, ops.decode_partials(q, self_kv[0], self_kv[1],
                                 sm_scale=sm_scale, cap=cap))
  return out[0]


def _decode_attention(q, cache_sl, cfg: ModelConfig, local: bool, mode: str,
                      i_max: int, attention_fn, **kw):
  """One layer's decode attention of q (B, H, D) in the layer's mode:
  exact (a local layer: over its window) or synopsis (``attention_fn``
  where given).  Returns (ctx (B, H, D) f32, aux or None)."""
  if local or mode == "exact":
    window = cfg.sliding_window if local else None
    layout = cache_sl.get("layout")
    if layout is not None and layout.seq_axes:
      return sharded_exact_decode_attention(
          q, cache_sl["k"], cache_sl["v"], layout, window=window, **kw), None
    return exact_decode_attention(
        q, cache_sl["k"], cache_sl["v"], window=window, **kw), None
  kw.update(i_max=i_max, cluster_size=cfg.synopsis.cluster_size)
  if attention_fn is not None:
    return attention_fn(q, cache_sl, **kw)
  if shd.current_mesh() is not None:
    return sharded_synopsis_attention(q, cache_sl, **kw), None
  return synopsis_decode_attention(q, cache_sl, **kw), None


def _heads_decode(q, cache_sl, cfg: ModelConfig, local: bool, mode: str,
                  i_max: int, attention_fn, heads, group: int, **kw):
  """:func:`_decode_attention` for the rank's query heads q (B, Hl, D),
  ``heads`` = (the mesh axes they are cut over, the first one's index),
  G = ``group`` query heads a KV head.  Exact attention (exact mode, a
  local layer) on a cache whose sequence is not cut runs on the rank's
  own heads directly, against the KV heads of their groups (a view).
  Otherwise every rank needs every head's query: over a sequence-cut
  cache each rank's partials cover all heads for its rows, and stage 1's
  score for a KV head is the max over all of its group's heads.  So q,
  B x H x D and small, is all-gathered over the heads' axes, the decode
  attention runs on all heads, and the rank keeps its heads of the
  context."""
  axes, h0 = heads
  if not axes:
    return _decode_attention(q, cache_sl, cfg, local, mode, i_max,
                             attention_fn, **kw)
  Hl = q.shape[1]
  layout = cache_sl.get("layout")
  seq_cut = layout is not None and bool(layout.seq_axes)
  whole_groups = Hl % group == 0 and h0 % group == 0
  if (local or mode == "exact") and not seq_cut and (
      whole_groups or h0 // group == (h0 + Hl - 1) // group):
    own = dict(cache_sl)
    own["k"], own["v"] = attn_lib.kv_heads_for(cache_sl["k"], cache_sl["v"],
                                               h0, Hl, group, -3)
    kw["self_kv"] = attn_lib.kv_heads_for(*kw["self_kv"], h0, Hl, group, -3)
    return _decode_attention(q, own, cfg, local, mode, i_max, attention_fn,
                             **kw)
  q_all = shd.all_gather_over(q, axes, 1)
  ctx, aux = _decode_attention(q_all, cache_sl, cfg, local, mode, i_max,
                               attention_fn, **kw)
  return ctx[:, h0:h0 + Hl], aux


def _attn_decode_layer(x, lp, cfg: ModelConfig, local: bool, cache_sl, pos,
                       mode: str, i_max: int, attention_fn=None):
  """x (B, 1, d) -> (y (B, 1, d), (k, v) of the new token (B, Hkv, 1, D),
  aux: ``attention_fn``'s telemetry dict, or None).  On a rank's shard the
  rank's query heads go through :func:`_heads_decode` and the row-cut
  ``wo`` (``attention.out_proj``)."""
  if cfg.mla is not None:
    return _mla_decode_layer(x, lp, cfg, cache_sl, pos, mode, i_max,
                             attention_fn)
  q, k_new, v_new = attn_lib.qkv(x, lp, cfg, pos[:, None])
  kd = k_new.transpose(1, 2)                                  # (B,Hkv,1,D)
  vd = v_new.transpose(1, 2)
  ctx, aux = _heads_decode(
      q[:, 0], cache_sl, cfg, local, mode, i_max, attention_fn,
      attn_lib.heads_cut(lp), cfg.n_heads // cfg.n_kv_heads,
      sm_scale=cfg.hd ** -0.5, cap=cfg.attn_softcap, self_kv=(kd, vd))
  y = attn_lib.out_proj(ctx[:, None].to(x.dtype), lp, x.dtype)
  return y, (kd, vd), aux


def _mla_decode_layer(x, lp, cfg: ModelConfig, cache_sl, pos, mode: str,
                      i_max: int, attention_fn=None):
  """MLA's absorbed decode (the JAX step's MLA branch): q_lat = q_nope .
  wk_b in f32 (the reference's ``einsum`` prefers f32), q_eff = [q_lat,
  q_pe] (B, H, kv_lora + rope) in f32 over the latent cache (one key /
  value head: G = H), the new token's latent [c_kv, k_pe] as its self KV,
  the softmax scale (nope + rope)^-0.5, in the layer's mode; then the
  context's latent part through ``wv_b`` and ``wo`` in f32, cast to the
  activation dtype.  The delta is the latent, as both k and v.  On a
  rank's shard ``wq_b``, ``wk_b`` and ``wv_b`` hold the rank's heads: its
  q_eff goes through :func:`_heads_decode` (G = H over the one latent
  head) and the row-cut ``wo``'s f32 product through one all-reduce."""
  m = cfg.mla
  positions = pos[:, None]
  q_nope, q_pe = attn_lib.mla_queries(x, lp, cfg, positions)
  c_kv, k_pe = attn_lib.mla_latent(x, lp, cfg, positions)
  f = acc_dtype(x)
  q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(f), lp["wk_b"].to(f))
  q_eff = torch.cat([q_lat, q_pe[:, 0].to(f)], dim=-1)
  lat = torch.cat([c_kv, k_pe], dim=-1)[:, None]              # (B,1,1,Dk)
  ctx, aux = _heads_decode(
      q_eff, cache_sl, cfg, False, mode, i_max, attention_fn,
      attn_lib.heads_cut(lp, "wq_b"), cfg.n_heads,
      sm_scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5, cap=None,
      self_kv=(lat, lat))
  o = torch.einsum("bhr,rhk->bhk", ctx[..., :m.kv_lora_rank].to(f),
                   lp["wv_b"].to(f))
  y = shd.all_reduce_over(torch.einsum("bhk,hkd->bd", o, lp["wo"].to(f)),
                          shd.cut_axes(lp, "wo", 0))[:, None].to(x.dtype)
  return y, (lat, lat), aux


def _cross_decode_layer(x, lp, cfg: ModelConfig, cross_k, cross_v):
  """The cross block of one decode step (the JAX ``_cross_decode_layer``):
  q = x wq + bq with no rope, exact attention over all of the layer's
  ``cross_k``/``cross_v`` (B, Hkv, T, D) with no self KV (one
  ``flash_decode`` launch on the card), ``out_proj`` with ``bo``."""
  q = attn_lib.query(x, lp)[:, 0]                             # (B, H, D)
  axes, h0 = attn_lib.heads_cut(lp)
  if axes:                     # the KV heads of the rank's query heads
    cross_k, cross_v = attn_lib.kv_heads_for(
        cross_k, cross_v, h0, q.shape[1], cfg.n_heads // cfg.n_kv_heads, 1)
  ctx = exact_decode_attention(q, cross_k, cross_v, sm_scale=cfg.hd ** -0.5)
  return attn_lib.out_proj(ctx[:, None].to(x.dtype), lp, x.dtype)


def global_positions(cfg: ModelConfig) -> Tuple[int, ...]:
  """The global (synopsis) attention layers' indices among the pattern's
  attention positions (the cache's second axis); the local ones run exact
  windowed decode, the mamba positions no attention."""
  attn = [s for s in cfg.block_pattern if s.kind == "attn"]
  return tuple(i for i, s in enumerate(attn) if not s.local)


def check_quant_device(cfg: ModelConfig, device) -> None:
  """Refuse, on a CUDA device and before anything runs, a ``+kv`` quant
  spec for a config with local layers.  Under ``+kv`` the sorted cache
  holds int8 / fp8 codes, and a local layer hands its window of that
  cache to exact decode as given (the JAX step does the same, unscaled):
  the CPU's plain version mirrors that, but ``flash_decode`` does not
  attend over raw codes.  The table-only specs keep the sorted cache in
  ``cfg.dtype``.  Every other spec runs on the card, MLA's (deepseek)
  too: the latent core has its quantized stage 1 and stage 2.  On the CPU
  the plain versions run every spec."""
  qc = qt.parse_qconfig(cfg.synopsis.quant)
  on_card = device is None or torch.device(device).type == "cuda"
  if not qc.enabled or not on_card or not qc.sorted_kv:
    return
  n = len(cfg.block_pattern)
  local = [b * n + i for b in range(cfg.n_blocks)
           for i, s in enumerate(cfg.block_pattern) if s.local]
  if local:
    raise ValueError(
        f"{cfg.name}: quant={qc.spec} stores the sorted cache as {qc.kind} "
        f"codes, and the local (sliding-window) layers {local} decode over "
        f"their window of it with flash_decode, which does not attend over "
        f"raw codes; use quant={qc.kind} (tables only) on the card")


def make_serve_step(cfg: ModelConfig, *, mode: str = "synopsis",
                    i_max: Optional[int] = None, attention_fn=None):
  """Returns serve_step(params, cache, tokens (B, 1)) -> (logits (B, V)
  f32, {"k_delta", "v_delta" (nb, na, B, Hkv, 1, D) where the pattern has
  attention, "conv_state", "ssd_state" (nb, ns, B, ...) where it has
  mamba layers, "pos" (B,)}).  ``mode`` is "synopsis" (budget ``i_max``)
  or "exact".

  ``attention_fn(q, cache_sl, *, i_max, cluster_size, sm_scale, cap,
  self_kv) -> (ctx, aux)`` replaces the synopsis decode attention of the
  global layers; each leaf of ``aux`` joins the outputs stacked over them
  (nb, len(:func:`global_positions`), ...)."""
  if mode not in LAYER_LEAVES:
    raise ValueError(f"mode={mode!r}: expected one of {tuple(LAYER_LEAVES)}")
  tf.check_supported(cfg)
  leaves = LAYER_LEAVES[mode]
  i_max = cfg.synopsis.i_max if i_max is None else i_max
  n_glob = len(global_positions(cfg))

  @torch.no_grad()
  def serve_step(params, cache, tokens):
    x = tf.embed_tokens(params, cfg, tokens[:, :1])           # (B, 1, d)
    pos = cache["pos"]
    deltas: Dict[str, list] = {}            # per block
    auxs: Dict[str, list] = {}              # per layer, in layer order
    for b in range(cfg.n_blocks):
      per: Dict[str, list] = {}
      ai = si = 0                 # attention / mamba position in the cache
      for i, spec in enumerate(cfg.block_pattern):
        lp = tf.layer_params(params["blocks"][f"pos{i}"], b)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if spec.kind == "mamba":
          mix, (conv, ssd) = ssm_lib.ssm_forward(
              h, lp["ssm"], cfg, decode_state=(cache["conv_state"][b, si],
                                               cache["ssd_state"][b, si]))
          per.setdefault("conv_state", []).append(conv)
          per.setdefault("ssd_state", []).append(ssd)
          si += 1
        else:
          # A local layer reads only its k / v (in either mode).
          names = (("k", "v") if spec.local else leaves) + (
              CROSS_LEAVES if spec.cross_attn else ())
          layer_cache = {kk: cache[kk][b, ai] for kk in names}
          if mode == "synopsis" and not spec.local:
            layer_cache["recent_len"] = cache["recent_len"]
            layer_cache.update((kk, cache[kk][b, ai])
                               for kk in qt.SCALE_LEAVES if kk in cache)
            # Frontend inputs (the cluster tier's per-component gather
            # modes) go to every layer whole.
            layer_cache.update((kk, t) for kk, t in cache.items()
                               if kk.startswith("fe_"))
          if "layout" in cache:            # a rank's shard (shard_cache)
            layer_cache["layout"] = cache["layout"]
          mix, (kd, vd), aux = _attn_decode_layer(
              h, lp["attn"], cfg, spec.local, layer_cache, pos, mode, i_max,
              attention_fn)
          for name, t in (aux or {}).items():
            auxs.setdefault(name, []).append(t)
          per.setdefault("k_delta", []).append(kd)
          per.setdefault("v_delta", []).append(vd)
          ai += 1
        if cfg.parallel_block:
          x = tf.parallel_residual(x, mix, h, lp, cfg, spec)
          continue
        x = x + tf.post_norm(mix, lp, "ln1_post", cfg)
        if spec.cross_attn:
          hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
          x = x + _cross_decode_layer(hc, lp["cross"], cfg,
                                      layer_cache["cross_k"],
                                      layer_cache["cross_v"])
        x = tf.mlp_block(x, lp, cfg, spec)
      for name, ts in per.items():
        deltas.setdefault(name, []).append(torch.stack(ts))
    h = rms_norm(x, shd.leaf(params, "final_norm"), cfg.norm_eps)[:, 0]
    logits = tf.logits_fn(params, cfg, h)
    lead = (cfg.n_blocks, n_glob)
    return logits, {**{name: torch.stack(ts) for name, ts in deltas.items()},
                    "pos": pos + 1,
                    **{name: torch.stack(ts).view(*lead, *ts[0].shape)
                       for name, ts in auxs.items()}}

  return serve_step

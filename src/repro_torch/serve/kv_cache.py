"""Decode caches and the continuous-batching slot pool (counterpart of
``repro.serve.kv_cache`` for the families the port runs).

``cache_struct`` gives each leaf's shape, dtype and logical axes: the
exact cache (``k``/``v``, ``pos``) or the synopsis cache (cluster-ordered
``k``/``v``, the centroid tables, ``counts``, the quantized arena's scale
leaves under ``cfg.synopsis.quant``, the recent ring and ``pos``), both
stacked over the pattern's attention positions only (``na``: 1 for
jamba's eight-layer pattern), and the mamba layers' decode state
(``conv_state`` in ``cfg.dtype``, ``ssd_state`` in f32) stacked over its
mamba positions.  The batch axis doubles as the engine's *slot* axis:
:func:`zeros_cache` allocates the slot pool and :func:`write_slot` admits
one request's B=1 cache into a lane.  Cross-attention caches (whisper)
have no pool.

Unlike the JAX package, the pool is allocated once and written in place:
``write_slot`` copies into the lane and the engine's reset zeroes the
leaves.  A captured CUDA graph reads fixed addresses, so a pool that was
reallocated would leave the graphs reading the old one.  The FFN never
changes the cache (an MoE or parallel block has the leaves of any GQA
layer).  MLA (deepseek) caches its latent instead: one key/value head of
kv_lora + rope (576 at full width) for ``k``, ``v``, the centroid tables,
the ring and the slot pool, in both families, with ``k`` and ``v``
holding the same rows, as in JAX (``common.kv_dims``).  Cross attention
has no pool (:func:`cache_struct`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels import quant as qt
from repro_torch.models import transformer as tf
from repro_torch.models.common import (ModelConfig, kv_dims,
                                       n_attn_positions, n_ssm_positions,
                                       ssm_state_shapes)

# The shared-immutable and private-mutable halves of a synopsis slot.
# ARENA_LEAVES are a function of the corpus alone (the sorted KV, the
# centroid tables, the counts, a quantized arena's scales), so the corpus
# cache shares one arena among the slots serving the same corpus;
# PRIVATE_LEAVES are a request's own decode state (the ring, ``pos``,
# the SSM state), written fresh into each lane.
ARENA_LEAVES = ("k", "v", "k_syn", "v_syn", "counts", "k_syn_scale",
                "v_syn_scale", "k_scale", "v_scale")
PRIVATE_LEAVES = ("recent_k", "recent_v", "recent_len", "pos",
                  "conv_state", "ssd_state")

# Logical axes per cache leaf (leading 'layers' for the block stack).
KV_AXES = ("layers", None, "batch", "kv_heads", "kv_seq", None)
COUNT_AXES = ("layers", None, "batch", "kv_seq")
SCALE_AXES = ("layers", None, "batch", "kv_heads", "kv_seq")
RECENT_AXES = ("layers", None, "batch", "kv_heads", None, None)
SSM_CONV_AXES = ("layers", None, "batch", None, "ssm_heads")
SSM_STATE_AXES = ("layers", None, "batch", "ssm_heads", None, "ssm_state")
CROSS_AXES = ("layers", None, "batch", "kv_heads", None, None)


def cache_struct(cfg: ModelConfig, B: int, S: int, *,
                 synopsis: bool, cross: bool = False) -> Dict[str, Any]:
  """{leaf: (shape, dtype, logical axes)} of the decode cache for (cfg,
  batch, sequence length).  A config with cross blocks (whisper) is
  refused unless ``cross``: the JAX pool sizes its cross leaves by the
  encoder's ``source_len`` while the loop's prefill emits them at prompt
  length, so the JAX engine fails its first slot write (ROADMAP C).  With
  ``cross`` (the dry run, which lowers the reference's decode cells from
  this layout) the cache also holds ``cross_k`` / ``cross_v`` (nb, na, B,
  Hkv, source_len, hd) in ``cfg.dtype`` with the reference's
  ``CROSS_AXES``.  With no attention position (mamba2) the cache is the
  SSM state and ``pos``."""
  tf.check_supported(cfg)
  if tf.has_cross(cfg) and not cross:
    raise NotImplementedError(
        f"{cfg.name}: no slot pool for cross-attention caches (the JAX "
        "pool sizes cross_k / cross_v by the encoder's source_len, the "
        "prefill emits them at prompt length)")
  nb, na, ns = cfg.n_blocks, n_attn_positions(cfg), n_ssm_positions(cfg)
  Hkv, D = kv_dims(cfg)
  dt = cfg.dtype
  out: Dict[str, Any] = {}
  if na and synopsis:
    sc = cfg.synopsis
    C = sc.cluster_size
    if S % C:
      raise ValueError(f"sequence length {S} is not a multiple of C={C}")
    M = S // C
    qc = qt.parse_qconfig(sc.quant)
    syn_dt = qt.qdtype(qc.kind) if qc.enabled else dt
    kv_dt = qt.qdtype(qc.kind) if qc.sorted_kv else dt
    out["k"] = ((nb, na, B, Hkv, S, D), kv_dt, KV_AXES)
    out["v"] = ((nb, na, B, Hkv, S, D), kv_dt, KV_AXES)
    out["k_syn"] = ((nb, na, B, Hkv, M, D), syn_dt, KV_AXES)
    out["v_syn"] = ((nb, na, B, Hkv, M, D), syn_dt, KV_AXES)
    out["counts"] = ((nb, na, B, M), torch.float32, COUNT_AXES)
    if qc.enabled:
      names = qt.SCALE_LEAVES if qc.sorted_kv else qt.SYN_SCALE_LEAVES
      for name in names:
        out[name] = ((nb, na, B, Hkv, M), torch.float32, SCALE_AXES)
    out["recent_k"] = ((nb, na, B, Hkv, sc.recent, D), dt, RECENT_AXES)
    out["recent_v"] = ((nb, na, B, Hkv, sc.recent, D), dt, RECENT_AXES)
    out["recent_len"] = ((B,), torch.int32, ("batch",))
  elif na:
    out["k"] = ((nb, na, B, Hkv, S, D), dt, KV_AXES)
    out["v"] = ((nb, na, B, Hkv, S, D), dt, KV_AXES)
  if ns:
    shapes = ssm_state_shapes(cfg, B)
    out["conv_state"] = (shapes["conv_state"], dt, SSM_CONV_AXES)
    out["ssd_state"] = (shapes["ssd_state"], torch.float32, SSM_STATE_AXES)
  if tf.has_cross(cfg):
    T = cfg.encoder.source_len
    for name in ("cross_k", "cross_v"):
      out[name] = ((nb, na, B, cfg.n_kv_heads, T, cfg.hd), dt, CROSS_AXES)
  out["pos"] = ((B,), torch.int32, ("batch",))
  return out


def zeros_cache(cfg: ModelConfig, B: int, S: int, *, synopsis: bool,
                device) -> Dict[str, torch.Tensor]:
  """All-zeros cache: the engine's slot pool.  A zeroed lane attends over
  zeros, which is numerically safe (``count_bias`` clamps its zero counts
  to 1) and which the engine never reads back."""
  return {name: torch.zeros(sh, dtype=dt, device=device)
          for name, (sh, dt, _) in cache_struct(cfg, B, S,
                                                synopsis=synopsis).items()}


def slot_batch_axes(cfg: ModelConfig, B: int, S: int, *,
                    synopsis: bool) -> Dict[str, int]:
  """Per-leaf index of the batch ("slot") axis, from the logical axes of
  ``cache_struct``."""
  return {k: ax.index("batch")
          for k, (_, _, ax) in cache_struct(cfg, B, S,
                                            synopsis=synopsis).items()}


def write_slot(cache: Dict[str, torch.Tensor], sub: Dict[str, torch.Tensor],
               slot: int, batch_axes: Dict[str, int]
               ) -> Dict[str, torch.Tensor]:
  """Copy a B=1 per-request cache ``sub`` into lane ``slot`` of the slot
  pool, in place (cast to the pool's dtypes); leaves of ``cache`` with no
  counterpart in ``sub`` stay as they are.  A hybrid's ``conv_state`` /
  ``ssd_state`` are written like the others.  Returns ``cache``."""
  for name, dst in cache.items():
    if name in sub:
      dst.narrow(batch_axes[name], slot, 1).copy_(sub[name])
  return cache


def replicate_leaf(x: torch.Tensor, replicas: int, axis: int) -> torch.Tensor:
  """The fleet tier's replica rows of one component-stacked leaf: R
  ring-rotated copies stacked at a new axis ``axis`` (the component axis
  moves to ``axis + 1``).  Row r is row 0 rolled right by r along the
  component axis, so column j of row r holds shard ``(j - r) % N``,
  exactly ``ComponentTopology.shard_grid()``; every copy is bit-identical
  to its primary shard."""
  r = int(replicas)
  if r < 1:
    raise ValueError(f"replicas must be >= 1, got {r}")
  return torch.stack([torch.roll(x, shift, dims=axis) for shift in range(r)],
                     dim=axis)


def arena_nbytes(arena: Dict[str, torch.Tensor]) -> int:
  """Bytes of the shared-immutable half (``ARENA_LEAVES``): the corpus
  cache's capacity accounting (the private half lives in the slot
  pool)."""
  return sum(int(arena[name].nbytes) for name in ARENA_LEAVES
             if name in arena)

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

A quantized arena's scale leaves (``kernels/quant.py``) ride in the layer
slice when the cache has them.  The cache is read-only inside the step;
the new token's per-layer KV comes back as ``k_delta``/``v_delta`` for the
loop to append, and the mamba layers' new state as ``conv_state`` /
``ssd_state`` (the whole state, not a difference), which the loop drops
and the engine writes back per slot, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quant as qt
from repro_torch.kernels.ref import acc_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm

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
    return exact_decode_attention(
        q, cache_sl["k"], cache_sl["v"],
        window=cfg.sliding_window if local else None, **kw), None
  kw.update(i_max=i_max, cluster_size=cfg.synopsis.cluster_size)
  if attention_fn is None:
    return synopsis_decode_attention(q, cache_sl, **kw), None
  return attention_fn(q, cache_sl, **kw)


def _attn_decode_layer(x, lp, cfg: ModelConfig, local: bool, cache_sl, pos,
                       mode: str, i_max: int, attention_fn=None):
  """x (B, 1, d) -> (y (B, 1, d), (k, v) of the new token (B, Hkv, 1, D),
  aux: ``attention_fn``'s telemetry dict, or None)."""
  if cfg.mla is not None:
    return _mla_decode_layer(x, lp, cfg, cache_sl, pos, mode, i_max,
                             attention_fn)
  q, k_new, v_new = attn_lib.qkv(x, lp, cfg, pos[:, None])
  kd = k_new.transpose(1, 2)                                  # (B,Hkv,1,D)
  vd = v_new.transpose(1, 2)
  ctx, aux = _decode_attention(
      q[:, 0], cache_sl, cfg, local, mode, i_max, attention_fn,
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
  activation dtype.  The delta is the latent, as both k and v."""
  m = cfg.mla
  positions = pos[:, None]
  q_nope, q_pe = attn_lib.mla_queries(x, lp, cfg, positions)
  c_kv, k_pe = attn_lib.mla_latent(x, lp, cfg, positions)
  f = acc_dtype(x)
  q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(f), lp["wk_b"].to(f))
  q_eff = torch.cat([q_lat, q_pe[:, 0].to(f)], dim=-1)
  lat = torch.cat([c_kv, k_pe], dim=-1)[:, None]              # (B,1,1,Dk)
  ctx, aux = _decode_attention(
      q_eff, cache_sl, cfg, False, mode, i_max, attention_fn,
      sm_scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5, cap=None,
      self_kv=(lat, lat))
  o = torch.einsum("bhr,rhk->bhk", ctx[..., :m.kv_lora_rank].to(f),
                   lp["wv_b"].to(f))
  y = torch.einsum("bhk,hkd->bd", o, lp["wo"].to(f))[:, None].to(x.dtype)
  return y, (lat, lat), aux


def _cross_decode_layer(x, lp, cfg: ModelConfig, cross_k, cross_v):
  """The cross block of one decode step (the JAX ``_cross_decode_layer``):
  q = x wq + bq with no rope, exact attention over all of the layer's
  ``cross_k``/``cross_v`` (B, Hkv, T, D) with no self KV (one
  ``flash_decode`` launch on the card), ``out_proj`` with ``bo``."""
  q = attn_lib.query(x, lp)[:, 0]                             # (B, H, D)
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
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, 0]
    logits = tf.logits_fn(params, cfg, h)
    lead = (cfg.n_blocks, n_glob)
    return logits, {**{name: torch.stack(ts) for name, ts in deltas.items()},
                    "pos": pos + 1,
                    **{name: torch.stack(ts).view(*lead, *ts[0].shape)
                       for name, ts in auxs.items()}}

  return serve_step

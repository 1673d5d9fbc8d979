"""Analytic FLOPs and bytes per (arch x shape x mode) cell (counterpart of
``repro.analysis.costmodel``).

Every matmul of the model is an einsum or matmul written out in
``models/*``, so the counts follow in closed form.  Conventions, the
reference's: flops = 2*M*N*K per matmul; a train step is 4x its forward
(backward 2x, the remat's forward re-run 1x); bytes = weight traffic +
optimizer state + activation / cache traffic (leading terms only).

The FLOPs are the reference's, term for term, in every cell.  The bytes
differ from the reference's in two ways, both on purpose:

  * they read the port's ``ModelConfig.param_count``, which counts every
    leaf of ``param_shapes`` (norm gains, biases, the SSM's small leaves
    and dt columns; a GELU MLP as 2 d d_ff), where the reference's is an
    approximation (``repro.models.common.ModelConfig.param_count``);
  * a decode step reads its weights once: the reference adds
    ``n_params * 2`` twice to a decode cell's bytes, which no decode step
    does (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import common as cm


def _attn_layer_flops(cfg: cm.ModelConfig, s_q: int, s_kv: float,
                      cross: bool = False) -> float:
  """Per-sequence forward flops of one attention layer (GQA or MLA)."""
  d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
  if cfg.mla and not cross:
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    proj = (d * m.q_lora_rank + m.q_lora_rank * H * qk) * s_q
    proj += d * (m.kv_lora_rank + m.qk_rope_dim) * s_q
    proj += m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim) * s_q
    proj += H * m.v_head_dim * d * s_q
    quad = s_q * s_kv * H * 2 * qk          # scores + (padded) values
  else:
    proj = d * hd * (2 * H + 2 * Hkv) * s_q
    quad = s_q * s_kv * H * 2 * hd
  return 2.0 * (proj + quad)


def _mlp_flops(cfg: cm.ModelConfig, s_q) -> float:
  return 2.0 * 3 * cfg.d_model * cfg.d_ff * s_q if cfg.d_ff else 0.0


def _moe_flops(cfg: cm.ModelConfig, s_q) -> float:
  e = cfg.moe
  per_tok = 2.0 * cfg.d_model * e.num_experts                 # router
  per_tok += 2.0 * 3 * cfg.d_model * e.d_ff_expert * (
      e.top_k * e.capacity_factor + e.num_shared)
  if e.dense_parallel:
    per_tok += 2.0 * 3 * cfg.d_model * cfg.d_ff
  return per_tok * s_q


def _ssm_flops(cfg: cm.ModelConfig, s_q) -> float:
  s = cfg.ssm
  d = cfg.d_model
  d_in = s.expand * d
  h = d_in // s.head_dim
  n, p, L = s.d_state, s.head_dim, min(s.chunk, max(s_q, 1))
  proj = 2.0 * d * (2 * d_in + 2 * n + h) + 2.0 * d_in * d
  if s_q == 1:                               # decode recurrence
    ssd = 2.0 * 2 * h * p * n
  else:
    ssd = 2.0 * (L * n + L * h * p + 2 * n * h * p)
  return (proj + ssd) * s_q


def _layer_flops(cfg: cm.ModelConfig, spec: cm.LayerSpec, s_q, s_kv
                 ) -> float:
  f = 0.0
  if spec.kind == "attn":
    f += _attn_layer_flops(cfg, s_q, s_kv)
    if spec.cross_attn:
      f += _attn_layer_flops(cfg, s_q, cfg.encoder.source_len, cross=True)
  else:
    f += _ssm_flops(cfg, s_q)
  if spec.use_moe and cfg.moe:
    f += _moe_flops(cfg, s_q)
  else:
    f += _mlp_flops(cfg, s_q)
  return f


@dataclasses.dataclass
class CellCost:
  flops_global: float          # the whole step, all ranks
  bytes_global: float


def cell_cost(cfg: cm.ModelConfig, shape: ShapeSpec, mode: str,
              i_max: Optional[int] = None,
              causal_skip: bool = False) -> CellCost:
  """The cell's FLOPs and bytes over all ranks (see the module doc)."""
  B, S = shape.global_batch, shape.seq_len
  kind = shape.kind
  sc = cfg.synopsis
  i_max = sc.i_max if i_max is None else i_max
  text = S - (cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0)

  if kind in ("train", "prefill"):
    s_q = S
    # The mean causal kv length: ~S/2 with causal_skip (each query chunk
    # reads only keys up to its position), else the full S (masked).
    s_kv = S / 2 + 256 if causal_skip else S
  else:
    s_q = 1
    if mode == "synopsis":
      s_kv = S // sc.cluster_size + i_max * sc.cluster_size + sc.recent
    else:
      s_kv = S

  per_seq = 0.0
  for spec in cfg.block_pattern:
    # gemma2's local layers read at most their window at decode.
    kv = (min(cfg.sliding_window, S) if spec.local and kind == "decode"
          else s_kv)
    per_seq += _layer_flops(cfg, spec, s_q, kv) * cfg.n_blocks

  if cfg.encoder is not None and kind in ("train", "prefill"):
    T = cfg.encoder.source_len
    per_seq += cfg.encoder.n_layers * (
        _attn_layer_flops(cfg, T, T)
        + 2.0 * 3 * cfg.d_model * cfg.encoder.d_ff * T)

  # The unembedding (every text position to train, the last one else),
  # and the frontend's projection.
  per_seq += 2.0 * cfg.d_model * cfg.vocab * (text if kind == "train" else 1)
  if cfg.frontend:
    per_seq += 2.0 * cfg.frontend_dim * cfg.d_model * (
        cfg.frontend_tokens or (cfg.encoder.source_len if cfg.encoder else 0))

  mult = 4.0 if kind == "train" else 1.0       # bwd 2x + remat re-fwd 1x
  flops = per_seq * B * mult

  # ---- bytes (leading terms) --------------------------------------------
  n_params = cfg.param_count()
  act_bytes = 2.0 * B * max(s_q, 1) * cfg.d_model * cfg.n_layers * 4
  if kind == "train":
    # bf16 weights read fwd + bwd + remat, f32 grads written, the f32
    # master, m and v read and written.
    byts = n_params * (2 * 3 + 4 + 3 * 4 * 2) + act_bytes * 3
  elif kind == "prefill":
    byts = n_params * 2 + act_bytes + 2.0 * B * S * cfg.n_layers * (
        _cache_row_bytes(cfg))
  else:
    byts = n_params * 2 + _decode_cache_bytes(cfg, B, S, mode, i_max)
  return CellCost(flops_global=flops, bytes_global=byts)


def _cache_row_bytes(cfg: cm.ModelConfig) -> float:
  Hkv, D = cm.kv_dims(cfg)
  return Hkv * 2 * D * 2.0


def _decode_cache_bytes(cfg: cm.ModelConfig, B, S, mode, i_max) -> float:
  layers_attn = cm.n_attn_positions(cfg) * cfg.n_blocks
  row = _cache_row_bytes(cfg)
  sc = cfg.synopsis
  if mode == "synopsis":
    rows = S // sc.cluster_size + i_max * sc.cluster_size + sc.recent
  else:
    rows = S
  rd = B * layers_attn * rows * row
  ns = cm.n_ssm_positions(cfg)
  if ns and cfg.ssm:                            # SSM state read and written
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    rd += 2.0 * B * ns * cfg.n_blocks * h * s.head_dim * s.d_state * 4
  return rd

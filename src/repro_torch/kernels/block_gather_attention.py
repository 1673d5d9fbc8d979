"""Stage-2 wrapper: exact attention over the selected clusters with the
fused decrement and extras epilogues (CUDA kernel ``csrc/block_gather.cu``;
replaces ``repro/kernels/block_gather_attention.py``).

The cache is cluster-contiguous (cluster c = rows [c*C, (c+1)*C)), so the
kernel streams each selected cluster as C consecutive rows.  ``selected``
may hold ``-1`` padding (masked with the -1e30 sentinel).  With
``k_sel/v_sel/sel_bias`` each selected centroid's stage-1 term is
accumulated with weight -1; with ``extras_*`` the recent ring and the new
token's self-KV fold in after the clusters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

NAME = "block_gather_attention"


def block_gather_attention(
    q: torch.Tensor,            # (B, H, D)
    k: torch.Tensor,            # (B, Hkv, S, D) cluster-contiguous
    v: torch.Tensor,            # (B, Hkv, S, D)
    selected: torch.Tensor,     # (B, Hkv, I) cluster ids, -1 padded
    *,
    cluster_size: int,
    sm_scale: float = 1.0,
    cap: Optional[float] = None,
    k_sel: Optional[torch.Tensor] = None,        # (B, Hkv, I, D)
    v_sel: Optional[torch.Tensor] = None,        # (B, Hkv, I, D)
    sel_bias: Optional[torch.Tensor] = None,     # (B, Hkv, I)
    extras_k: Optional[torch.Tensor] = None,     # (B, Hkv, E, D)
    extras_v: Optional[torch.Tensor] = None,     # (B, Hkv, E, D)
    extras_bias: Optional[torch.Tensor] = None,  # (B, E)
):
  """Returns partials (o (B,H,D) f32, m (B,H), l (B,H)).

  CPU tensors run the plain version; CUDA tensors launch the kernel."""
  if q.device.type == "cpu":
    return ref.fused_gather_attention_ref(
        q, k, v, selected, cluster_size=cluster_size, sm_scale=sm_scale,
        cap=cap, k_sel=k_sel, v_sel=v_sel, sel_bias=sel_bias,
        extras_k=extras_k, extras_v=extras_v, extras_bias=extras_bias)
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  C = cluster_size
  I = selected.shape[-1]
  has_dec = k_sel is not None
  has_ext = extras_k is not None
  E = extras_k.shape[2] if has_ext else 0
  bad = (H != Hkv * G or S % C or v.shape != k.shape
         or selected.shape != (B, Hkv, I)
         or (has_dec and (k_sel.shape != (B, Hkv, I, D)
                          or v_sel.shape != k_sel.shape
                          or sel_bias.shape != (B, Hkv, I)))
         or (has_ext and (extras_k.shape != (B, Hkv, E, D)
                          or extras_v.shape != extras_k.shape
                          or extras_bias.shape != (B, E))))
  if bad:
    raise ValueError(f"{NAME}: bad shapes q{tuple(q.shape)} "
                     f"k{tuple(k.shape)} selected{tuple(selected.shape)} "
                     f"C={C}")
  data = [q, k, v]
  if has_dec:
    data += [k_sel, v_sel]
  if has_ext:
    data += [extras_k, extras_v]
  code = _build.dtype_code(NAME, *data)
  sel = selected.to(device=q.device, dtype=torch.int32).contiguous()
  f32 = dict(dtype=torch.float32, device=q.device)
  sb = sel_bias.to(**f32).contiguous() if has_dec else None
  eb = extras_bias.to(**f32).contiguous() if has_ext else None
  o = torch.empty((B, H, D), **f32)
  m = torch.empty((B, H), **f32)
  l = torch.empty((B, H), **f32)
  P = _build.ptr
  err = _build.library().block_gather_launch(
      P(q), P(k), P(v), P(sel), P(k_sel), P(v_sel), P(sb), P(extras_k),
      P(extras_v), P(eb), P(o), P(m), P(l), B, Hkv, G, S, D, C, I, E,
      float(sm_scale), float(cap or 0.0), code, _build.stream_ptr(q))
  _build.check(err, NAME)
  _build.LAUNCHES[NAME] += 1
  return o, m, l

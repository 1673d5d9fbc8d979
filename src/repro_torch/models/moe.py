"""Mixture-of-Experts FFN with token-choice routing and per-expert capacity
(counterpart of ``repro.models.moe`` on one device, its ``_dp_size`` 1).

Every token picks its top-k experts (gates renormalised over the k);
every expert then keeps its top-``capacity`` routed tokens and drops the
rest, ``capacity = max(1, int(T k / E * capacity_factor))`` over the T
tokens of the call.  At decode T is the batch (B = 2 in the loop, the
slots in the engine), so with jamba's k = 2 of E = 16 the capacity is 1:
each expert keeps only its highest-gated token of the batch, the rows of
a batch change each other's output, and every expert computes its one
slot (a decode step reads all E experts' weights), as in the reference;
arctic's k = 2 of E = 128 gives capacity 1 up to T = 102.

Both selections break ties as ``lax.top_k`` does, the lower index first:
a stable descending sort (``torch.topk`` does not promise an order).
Router logits and softmax in f32 (float64 for float64 activations); the
expert products in the activation dtype with the SwiGLU gate in f32, as
``layers.swiglu``.

The combine adds each token's kept expert outputs in the activation
dtype, one rounding an add, in ascending expert order: the order of the
reference's scatter-add over the flattened (E, capacity) slots, in which
a token holds at most one slot an expert (:func:`combine`).  With k = 2
(jamba, arctic) the order could not matter (two terms commute), but with
deepseek's k = 6 it does; an ``index_add_`` on a CUDA tensor adds with
atomics in no fixed order, so two runs of a step (a replayed CUDA graph
and its eager call) could differ in the last bit.  Shared experts
(deepseek) add ``swiglu`` of the same input to the routed output, as the
reference does.  Plain PyTorch on every device: the reference is plain
JAX.

On a rank's shard (``dist.sharding.shard_params``) the MoE is
expert-parallel over ``expert``: the router's columns are cut, so one
all-gather gives every rank the logits of all E experts and every rank
routes every token globally (the same top-k, capacity and drops as one
rank's); each rank then runs only its own experts, combines their outputs
(:func:`combine` over its block) and one all-reduce sums the ranks'
partial combines.  Where E does not divide over the mesh (the
divisibility fallback) the experts stay whole and ``ff`` takes the cut:
every rank runs every expert on its columns, and the same all-reduce sums
the partial products.  Shared experts follow ``transformer.mlp``'s cut.
In the training backward the tokens and the gates enter the rank's
experts through ``dist.sharding.enter`` (the ranks' partial cotangents
summed), and the router's logits through the all-gather's (the rank's
columns of the cotangent).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cluster import top_k
from repro_torch.dist import sharding as shd
from repro_torch.kernels.ref import acc_dtype
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import swiglu


def capacity(cfg: ModelConfig, tokens: int) -> int:
  """Tokens each expert keeps of a call over ``tokens`` tokens."""
  m = cfg.moe
  return max(1, int(tokens * m.top_k / m.num_experts * m.capacity_factor))


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          axes=()):
  """The routing of x (T, d): (per expert the kept tokens ``tok`` (E,
  cap) and their gates ``gate`` (E, cap), 0 where the slot holds no
  routed token; the token side's choice ``topi`` (T, k); the aux
  load-balance loss).  ``axes``: the mesh axes the router's columns are
  cut over; the logits of every expert are all-gathered first."""
  m = cfg.moe
  T = x.shape[0]
  E, K = m.num_experts, m.top_k
  f = acc_dtype(x)
  probs = torch.softmax(shd.all_gather_over(
      torch.matmul(shd.enter(x, axes).to(f), router.to(f)), axes, -1),
      dim=-1)
  topv, topi = top_k(probs, K)                                # (T, K)
  topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
  in_topk = torch.zeros((T, E), dtype=f, device=x.device).scatter_(
      1, topi, topv)                                          # gate or 0
  # Switch-style load-balance loss: E * sum_e f_e p_e.
  frac_routed = (in_topk > 0).to(f).mean(0)
  aux = E * (frac_routed * probs.mean(0)).sum()
  masked = torch.where(in_topk > 0, in_topk, -1.0).t()        # (E, T)
  gate, tok = top_k(masked, capacity(cfg, T))                 # (E, cap)
  return tok, gate.clamp_min(0.0), topi, aux


def combine(y: torch.Tensor, tok: torch.Tensor, topi: torch.Tensor,
            e0: int = 0, n_experts: Optional[int] = None) -> torch.Tensor:
  """The experts' outputs y (E, cap, d), slot (e, c) belonging to token
  ``tok[e, c]``, summed per token into (T, d) in y's dtype, in ascending
  expert order (the reference scatter-adds the flattened (E, cap) slots
  in order): k rounds of one gathered add, round j adding each token's
  j-th smallest chosen expert ``topi`` (T, k), or 0 where that expert
  dropped it.  A slot that holds no routed token (gate 0) points at a
  token that did not choose its expert, so it is never read; the
  reference adds it as 0.  Tensor ops only, so that a CUDA graph can
  capture it.  With ``n_experts`` > E, y holds experts [e0, e0 + E) of
  the ``n_experts`` (a rank's block): a token's expert outside the block
  adds nothing."""
  E, cap, d = y.shape
  T = topi.shape[0]
  # slot[e, t]: the slot of expert e holding token t (each expert holds a
  # token once), or -1.
  slot = torch.full((E, T), -1, dtype=torch.long, device=y.device)
  slot.scatter_(1, tok, torch.arange(cap, device=y.device).expand(E, cap))
  experts = torch.sort(topi, dim=1).values                    # (T, k)
  flat = y.reshape(E * cap, d)
  tokens = torch.arange(T, device=y.device)
  out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
  for j in range(experts.shape[1]):
    e = experts[:, j]
    if n_experts is not None and n_experts != E:
      own = (e >= e0) & (e < e0 + E)
      e = (e - e0).clamp(0, E - 1)
      c = torch.where(own, slot[e, tokens], -1)
    else:
      c = slot[e, tokens]                                     # (T,)
    term = flat[e * cap + c.clamp_min(0)]
    out = out + torch.where((c >= 0)[:, None], term, torch.zeros_like(term))
  return out


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig):
  """x (B, S, d) -> (y (B, S, d) in x's dtype, aux load-balance loss; no
  caller on the serve path reads it): the routed experts' outputs,
  combined in ascending expert order (:func:`combine`), plus the shared
  experts' ``swiglu`` where the config has them (deepseek).  arctic's
  dense MLP beside the experts is added at the call site
  (``transformer.ffn``), as in the reference."""
  B, S, d = x.shape
  xf = x.reshape(B * S, d)
  tok, gate, topi, aux = route(xf, p["router"], cfg,
                               shd.cut_axes(p, "router", 1))
  dt, f = x.dtype, acc_dtype(x)
  e_axes = shd.cut_axes(p, "w1", 0)
  x_axes = e_axes + shd.cut_axes(p, "w1", 2)  # the rank's experts or ff
  e0 = shd.block_start(e_axes, p["w1"].shape[0])
  gate = shd.enter(gate, x_axes)
  if e_axes:                              # this rank's experts only
    tok = tok[e0:e0 + p["w1"].shape[0]]
    gate = gate[e0:e0 + p["w1"].shape[0]]
  xg = shd.enter(xf, x_axes)[tok]                             # (E, cap, d)
  h = torch.matmul(xg, p["w1"].to(dt)).to(f)
  g = torch.matmul(xg, p["w3"].to(dt)).to(f)
  h = (F.silu(h) * g).to(dt)
  y = torch.matmul(h, p["w2"].to(dt)) * gate[..., None].to(dt)
  out = combine(y, tok, topi, e0, cfg.moe.num_experts).reshape(B, S, d)
  out = shd.all_reduce_over(out, x_axes)
  if cfg.moe.num_shared:
    s = p["shared"]
    s_axes = shd.cut_axes(s, "w2", 0)
    out = out + shd.all_reduce_over(
        swiglu(shd.enter(x, s_axes), s["w1"], s["w3"], s["w2"]), s_axes)
  return out, aux

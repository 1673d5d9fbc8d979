"""Online accuracy-aware approximate processing over generic data
(counterpart of ``repro.core.engine``; paper §2.3, Algorithm 1).

  stage 1  process the synopsis -> initial result and per-cluster
           correlations c_i (line 1);
  rank     descending correlation (lines 2-3), ties to the lower cluster
           id as ``jax.lax.top_k``;
  stage 2  refine the result with the original members of the top-ranked
           clusters (lines 4-10), bounded by the static budget ``i_max``.

The paper's in-loop deadline check becomes the budget ``i_max`` that the
control plane's latency model picks (``core.deadline``).  Two refinement
modes: ``iterative`` refines cluster by cluster, most correlated first (a
Python loop where the reference runs ``fori_loop``: the literal
Algorithm 1); ``vectorized`` gathers every selected cluster's members and
refines once (the same result for an order-insensitive ``refine_fn``).

The CF recommender and the search engine (``serving.apps``) instantiate it
with their own ``score_fn`` / ``refine_fn``; plain PyTorch on any device,
as the reference is plain JAX.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core.cluster import top_k
from repro_torch.core.synopsis import Synopsis, _members

# score_fn(query, centroids, weight) -> (initial result carry, scores (m,))
ScoreFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]
# refine_fn(carry, member_rows (cap, v), member_mask (cap, v)) -> carry
RefineFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class ProcessResult(NamedTuple):
  result: torch.Tensor     # final carry (service-specific)
  scores: torch.Tensor     # (m,) correlations c_i
  selected: torch.Tensor   # (i_max,) int32 cluster ids refined, in rank order
  initial: torch.Tensor    # stage-1 carry, before refinement


def approximate_process(query: torch.Tensor, syn: Synopsis,
                        data: torch.Tensor, mask: torch.Tensor, *,
                        score_fn: ScoreFn, refine_fn: RefineFn, i_max: int,
                        mode: str = "iterative") -> ProcessResult:
  """Run Algorithm 1 for one request against one component's subset."""
  initial, scores = score_fn(query, syn.centroids, syn.centroid_weight)
  if i_max == 0:
    return ProcessResult(initial, scores,
                         torch.zeros((0,), dtype=torch.int32,
                                     device=scores.device), initial)
  selected = top_k(scores, i_max)[1].to(torch.int32)
  if mode == "iterative":
    result = initial
    for c in selected.long():
      result = refine_fn(result, *_members(data, mask, syn.member_idx[c]))
  elif mode == "vectorized":
    rows, msk = _members(data, mask, syn.member_idx[selected.long()])
    v = rows.shape[-1]
    result = refine_fn(initial, rows.reshape(-1, v), msk.reshape(-1, v))
  else:
    raise ValueError(f"unknown mode {mode!r}")
  return ProcessResult(result, scores, selected, initial)


def exact_process(query: torch.Tensor, data: torch.Tensor,
                  mask: torch.Tensor, *, init: torch.Tensor,
                  refine_fn: RefineFn) -> torch.Tensor:
  """The exact baseline ("Basic" in paper §4): one refinement over all of
  the data, to measure the accuracy loss against."""
  del query
  return refine_fn(init, data, mask)

"""Paper service 2 on the PyTorch port: web search with AccuracyTrader
(paper §3.2, §4.2-4.3).

A synthetic Sogou-shaped page collection: where the true top-10 pages lie
among the ranked aggregated pages (Fig 4(b)), then the top-10 accuracy
against the share of clusters refined (the accuracy half of Fig 6).  The
same flags, seeds and tables as ``examples/search_engine.py``; a query is
a page plus 0.05 of a standard normal vector drawn from its own seed.

  PYTHONPATH=src python examples/torch_search_engine.py --device cpu \\
      [--docs 8192]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.apps import SearchEngine, webpages_like

FRACTIONS = (0.0, 0.05, 0.1, 0.2, 0.4, 1.0)


def normal_noise(seed: int, vocab: int) -> torch.Tensor:
  """The query noise of query ``seed``: (vocab,) standard normal f32."""
  return torch.randn(vocab, generator=torch.Generator().manual_seed(seed))


def main(argv=None, basis=None, noise=normal_noise):
  """Prints both tables and returns (deciles %, {fraction: accuracy}).
  ``basis`` is the synopsis' PCA start, ``noise(seed, vocab)`` draws a
  query's noise (the reference draws ``jax.random.normal(PRNGKey(seed))``,
  which torch cannot replay; parity tests pass it in)."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--docs", type=int, default=8192)
  ap.add_argument("--vocab", type=int, default=1024)
  ap.add_argument("--clusters", type=int, default=128)
  ap.add_argument("--queries", type=int, default=50)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)

  docs = webpages_like(args.docs, args.vocab, seed=2).to(dev)
  se = SearchEngine(docs, num_clusters=args.clusters, basis=basis)
  print(f"{args.docs} pages -> {args.clusters} aggregated pages "
        f"({args.docs // args.clusters}x compression)")

  rng = np.random.default_rng(0)
  query = lambda seed: docs[int(rng.integers(0, args.docs))] \
      + 0.05 * noise(seed, args.vocab).to(dev)
  row_cluster = se.syn.row_cluster.cpu().numpy()

  # -- Fig 4(b): where do the true top-10 pages live in the ranking? ------
  sections = np.zeros(10)
  for qi in range(args.queries):
    qv = query(qi)
    scores_syn = (se.syn.centroids @ qv).cpu().numpy()
    order = np.argsort(-scores_syn)                      # ranked clusters
    rank_of_cluster = np.empty_like(order)
    rank_of_cluster[order] = np.arange(len(order))
    true_top = se.search_exact(qv).cpu().numpy()
    sec = rank_of_cluster[row_cluster[true_top]] * 10 // args.clusters
    for s in sec:
      sections[s] += 1
  sections = 100.0 * sections / sections.sum()
  print("\nFig4(b) — % of true top-10 pages per ranked-cluster decile:")
  print("  " + "  ".join(f"{s:5.1f}%" for s in sections))

  # -- Fig 6-style: accuracy against the refinement budget ----------------
  print(f"\n{'budget':>8s} {'% clusters':>10s} {'top-10 accuracy':>16s}")
  accuracy = {}
  for frac in FRACTIONS:
    budget = int(frac * args.clusters)
    acc = np.mean([se.accuracy(query(1000 + i), budget)
                   for i in range(args.queries)])
    accuracy[frac] = float(acc)
    print(f"{budget:8d} {100*frac:9.0f}% {100*acc:15.1f}%")
  print(f"\n{args.queries} queries on {dev.type}: refining 40% of the "
        f"ranked clusters retrieved {100 * accuracy[0.4]:.1f}% of the true "
        "top-10")
  return sections, accuracy


if __name__ == "__main__":
  main()

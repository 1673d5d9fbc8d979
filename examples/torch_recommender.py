"""Paper service 1 on the PyTorch port: a CF recommender with
AccuracyTrader (paper §3.2, §4.3).

Builds a MovieLens-shaped user-item matrix, creates the per-component
synopsis (aggregated users), and prints the accuracy side of Table 2: RMSE
against the refinement budget, beside the exact prediction and a partial
execution that processes an unranked 25% of the users.  The same flags,
seeds and table as ``examples/recommender.py``.

  PYTHONPATH=src python examples/torch_recommender.py --device cpu \\
      [--users 2048 --items 400]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.apps import CFRecommender, movielens_like


class CFRecommenderView:
  """Exact CF restricted to a random subset of users (partial
  execution)."""

  def __init__(self, rec: CFRecommender, keep: np.ndarray):
    k = torch.from_numpy(keep.astype(np.float32)).to(rec.ratings.device)
    self.rec = CFRecommender.__new__(CFRecommender)
    self.rec.ratings = rec.ratings * k[:, None]
    self.rec.mask = rec.mask * k[:, None]
    self.rec.num_clusters = rec.num_clusters
    self.rec.syn = rec.syn

  def predict_exact(self, q, qm, items):
    return CFRecommender.predict_exact(self.rec, q, qm, items)


def main(argv=None, basis=None):
  """Prints the table and returns {variant: RMSE}.  ``basis`` is the
  synopsis' PCA start (default ``core.cluster.initial_basis``)."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--users", type=int, default=2048)
  ap.add_argument("--items", type=int, default=400)
  ap.add_argument("--density", type=float, default=0.15)
  ap.add_argument("--clusters", type=int, default=32)
  ap.add_argument("--active-users", type=int, default=40)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)

  ratings, mask = movielens_like(args.users, args.items,
                                 density=args.density, seed=1)
  ratings, mask = ratings.to(dev), mask.to(dev)
  rec = CFRecommender(ratings, mask, num_clusters=args.clusters, basis=basis)
  print(f"matrix {args.users}x{args.items}, "
        f"{int(mask.sum())} ratings, {args.clusters} aggregated users "
        f"({args.users // args.clusters}x compression)")

  rng = np.random.default_rng(0)
  budgets = [0, 1, 2, 4, 8, 16, args.clusters]
  sq_err = {b: [] for b in budgets}
  sq_err["exact"] = []
  sq_err["partial_25"] = []
  host = lambda t: t.cpu().numpy()
  mask_np = host(mask)

  for _ in range(args.active_users):
    uid = int(rng.integers(0, args.users))
    q_full, qm_full = ratings[uid], mask[uid]
    rated = np.where(mask_np[uid] > 0)[0]
    if len(rated) < 10:
      continue
    test = rng.choice(rated, size=min(10, len(rated) // 2), replace=False)
    items = torch.from_numpy(test).to(dev)
    qm = qm_full.clone()
    qm[items] = 0.0                              # 80/20 split (paper §4.2)
    q = q_full * qm
    truth = host(q_full)[test]

    sq_err["exact"].append((host(rec.predict_exact(q, qm, items)) - truth)
                           ** 2)
    for b in budgets:
      sq_err[b].append((host(rec.predict(q, qm, items, b)) - truth) ** 2)
    # partial execution: an unranked 25% of the users (no synopsis)
    keep = rng.random(args.users) < 0.25
    sub = CFRecommenderView(rec, keep)
    sq_err["partial_25"].append(
        (host(sub.predict_exact(q, qm, items)) - truth) ** 2)

  rmse = {k: float(np.sqrt(np.mean(np.concatenate(v))))
          for k, v in sq_err.items()}
  base = rmse["exact"]
  print(f"\n{'variant':>14s}  {'RMSE':>7s}  {'accuracy loss':>13s}")
  for k in ["exact", "partial_25"] + budgets:
    name = f"budget={k}" if isinstance(k, int) else k
    loss = 100.0 * (rmse[k] - base) / base
    print(f"{name:>14s}  {rmse[k]:7.4f}  {loss:+12.2f}%")
  print(f"\n{len(sq_err['exact'])} active users on {dev.type}")
  return rmse


if __name__ == "__main__":
  main()

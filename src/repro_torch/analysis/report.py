"""The dry run's tables from its artifacts (counterpart of
``repro.analysis.report``): a summary, the single-pod roofline and every
cell's memory and collectives, against one NVIDIA H100 80GB HBM3, 700.00 W
a rank.  The roofline terms are the cost model's on the card's peaks
(modelled, not measured); the memory is the meta-device trace's.

Every cell's trace is the rank's cut program (``weights: "cut"``: the
rule tables' tensor-parallel and FSDP cuts, of the serving weights and of
the train state alike), so its traced peak is what decides whether it
fits; :func:`over_card` names the cells that do not.

  PYTHONPATH=src python -m repro_torch.analysis.report artifacts/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys


def fmt_b(x):
  for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
    if abs(x) >= div:
      return f"{x / div:.2f}{unit}"
  return f"{x:.0f}B"


def fmt_s(x):
  if x >= 1.0:
    return f"{x:.2f}s"
  if x >= 1e-3:
    return f"{x * 1e3:.2f}ms"
  return f"{x * 1e6:.1f}us"


def load(art_dir):
  cells = {}
  for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
    with open(f) as fh:
      d = json.load(fh)
    cells[(d["arch"], d["shape"], d["mesh"], d["mode"])] = d
  return cells


def dryrun_table(cells) -> str:
  rows = ["| arch | shape | mesh | mode | trace | args/rank | peak/rank "
          "| fits | args under rules | coll bytes/rank |",
          "|---|---|---|---|---|---|---|---|---|---|"]
  for (arch, shape, mesh, mode), d in sorted(cells.items()):
    m = d["memory"]
    rows.append(
        f"| {arch} | {shape} | {mesh} | {mode} | {d['compile_s']:.0f}s "
        f"| {fmt_b(m['argument_size_in_bytes'])} "
        f"| {fmt_b(m['peak_bytes_per_device'])} "
        f"| {'Y' if d['fits_hbm'] else 'N'} "
        f"| {fmt_b(d['argument_bytes_under_rules'])} "
        f"| {fmt_b(d['collectives']['total'])} |")
  return "\n".join(rows)


def roofline_table(cells) -> str:
  rows = ["| arch | shape | mode | compute | memory | collective | "
          "dominant | bound | useful FLOPs |",
          "|---|---|---|---|---|---|---|---|---|"]
  for (arch, shape, mesh, mode), d in sorted(cells.items()):
    if mesh != "single":
      continue
    r = d["roofline"]
    uf = r.get("useful_flops_ratio")
    rows.append(
        f"| {arch} | {shape} | {mode} | {fmt_s(r['compute_s'])} "
        f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
        f"| **{r['dominant']}** | {fmt_s(r['bound_s'])} "
        f"| {uf:.2f} |" if uf else
        f"| {arch} | {shape} | {mode} | - | - | - | - | - | - |")
  return "\n".join(rows)


def over_card(cells):
  """The cells whose traced peak does not fit the card, sorted."""
  return sorted(k for k, d in cells.items() if not d["fits_hbm"])


def summary(cells) -> str:
  total = len(cells)
  fits = sum(1 for d in cells.values() if d["fits_hbm"])
  train = [d for d in cells.values() if d["shape"].startswith("train")]
  serve = [d for d in cells.values() if not d["shape"].startswith("train")]
  single = sum(1 for k in cells if k[2] == "single")
  multi = sum(1 for k in cells if k[2] == "multi")
  card = next(iter(cells.values()))["card"] if cells else "-"
  cut = sum(1 for d in cells.values() if d.get("weights") == "cut")
  lines = [f"- cells traced: {total} (single-pod {single}, multi-pod "
           f"{multi}), {cut} on the rank's cut program; fit in 80 GB "
           f"({card}) as traced: {fits}/{total} (serving cells "
           f"{sum(1 for d in serve if d['fits_hbm'])}/{len(serve)}, train "
           f"cells {sum(1 for d in train if d['fits_hbm'])}/{len(train)})"]
  census = {}
  for k, d in cells.items():
    if k[2] != "single":
      continue
    dom = d["roofline"]["dominant"]
    census[dom] = census.get(dom, 0) + 1
  lines.append(f"- dominant terms (single-pod, modelled): {census}")
  over = ", ".join(" ".join(k) for k in over_card(cells)) or "none"
  lines.append(f"- do not fit 80 GB as traced: {over}")
  return "\n".join(lines)


def main(argv=None):
  argv = sys.argv[1:] if argv is None else argv
  art = argv[0] if argv else "artifacts/dryrun"
  cells = load(art)
  print("## Summary\n")
  print(summary(cells))
  print("\n## Roofline (single-pod, 256 ranks; the cost model on the "
        "card's peaks)\n")
  print(roofline_table(cells))
  print("\n## Dry run (all cells; the meta-device trace of rank 0)\n")
  print(dryrun_table(cells))


if __name__ == "__main__":
  main()

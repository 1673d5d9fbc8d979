"""The port's dry run: every (arch x shape x mesh) cell, one rank's program
traced on the ``meta`` device (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for 512 placeholder
devices and reads XLA's memory analysis and the collectives of the HLO.
The port compiles nothing and its programs are SPMD by hand: every rank
runs the same step on its own shard.  So the dry run builds one rank's
arguments (rank 0's by default: parameters, optimizer state, its batch
rows, its ``shard_cache`` of the global decode cache) as ``meta`` tensors,
runs the rank's real step on them under ``use_mesh`` on an
``AbstractMesh`` of the production shape, and reads:

  * the live storage of every tensor the step allocates
    (``analysis.tracker.MemoryTracker``; the kernel wrappers allocate on
    ``meta`` what their launches allocate, and launch nothing);
  * the operand bytes of the mesh's collectives (the abstract mesh's
    tally; it communicates nothing);
  * the analytic FLOPs and bytes of ``analysis.costmodel.cell_cost``;

against one NVIDIA H100 80GB HBM3, 700.00 W a rank (``analysis.roofline``).

Every cell traces the rank's cut program (``weights: "cut"``).  A
serving cell (prefill_32k, decode_32k, long_500k) takes its
``dist.sharding.shard_params`` shard under the cell's rule table (the
tensor-parallel cuts over `model`, and the FSDP cut of ``embed`` over
`data` for a big model), a train cell (train_4k) its
``train_step.shard_train_state`` shard of the f32 master, the AdamW
moments and the error feedback under ``TRAIN_RULES`` (FSDP dropped for a
small model), and the rank's rows of the batch; the step gathers and
reduces what the cuts need, forward and backward.  The traced argument
bytes equal ``argument_bytes_under_rules``: the rule tables' bytes a
rank, with the port's f32 unembedding to serve (ROADMAP C).
The memory policies keep the reference's
structure, each threshold the same share of the card's memory as the
reference's of its 16 GB chip: FSDP weights to serve above 10/16 of it a
rank, replicated training state below 2/16, microbatches sized to 6/16.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape decode_32k --mesh single --mode synopsis --out artifacts/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.analysis.report artifacts/dryrun

``--all`` runs each cell in a subprocess of its own (a time limit a cell;
as many at once as the process may use cores).  Artifacts: one JSON a cell with the memory summary,
the collectives, the roofline terms and the rules' bytes.  No card is
needed: nothing is allocated and no kernel launches.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from repro_torch.analysis import costmodel as cmod
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.tracker import MemoryTracker
from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_abstract_production_mesh
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step, shard_cache
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import (make_train_step,
                                          shard_train_state)

META = torch.device("meta")
# torch.cuda.get_device_properties(0).total_memory of one NVIDIA H100 80GB
# HBM3, 700.00 W (chip_smoke.py's phase 24 prints it).
CARD_MEMORY = 85_017_493_504
# The reference's thresholds as shares of its chip's 16 GB, taken of the
# card's memory: FSDP weights to serve (10 GB), replicated training state
# (2 GB), the microbatch budget (6 GB).
FSDP_SERVE_SHARE = 10 / 16
REPLICATE_TRAIN_SHARE = 2 / 16
MICROBATCH_SHARE = 6 / 16

CELLS_MODES = {          # decode cells run the baseline AND synopsis
    "decode_32k": ["exact", "synopsis"],
    "long_500k": ["auto"],
    "train_4k": ["auto"],
    "prefill_32k": ["auto"],
}


def model_flops(cfg: cm.ModelConfig, shape: shp.ShapeSpec, mode: str
                ) -> float:
  """MODEL_FLOPS = 6 N(active) D to train, 2 N D to infer (the roofline's
  useful FLOPs), N the port's count less the embeddings."""
  del mode
  n = cfg.param_count(active=True)
  n -= cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
  if shape.kind == "train":
    return 6.0 * n * shape.global_batch * shape.seq_len
  if shape.kind == "prefill":
    return 2.0 * n * shape.global_batch * shape.seq_len
  return 2.0 * n * shape.global_batch           # decode: one token a row


def resolve_mode(cfg: cm.ModelConfig, shape_name: str, mode: str) -> str:
  """The reference's resolution: ``auto`` is synopsis on a decode cell
  with attention (exact on decode_32k, its baseline cell) and ``n/a``
  elsewhere; synopsis without attention is exact."""
  shape = shp.SHAPES[shape_name]
  has_attn = cm.n_attn_positions(cfg) > 0
  if mode == "auto":
    if shape.kind == "decode":
      mode = "synopsis" if has_attn else "exact"
      if shape_name == "decode_32k":
        mode = "exact"
    else:
      mode = "n/a"
  if mode == "synopsis" and not has_attn:
    mode = "exact"
  return mode


def cell_rules(cfg: cm.ModelConfig, shape_name: str, mesh) -> Dict:
  """The rule table of a cell: the reference's policy, its thresholds
  scaled to the card (module doc)."""
  shape = shp.SHAPES[shape_name]
  big = (cfg.param_count() * 2 / shd.tp_size(mesh)
         > FSDP_SERVE_SHARE * CARD_MEMORY)
  if shape.kind == "train":
    rules = dict(shd.TRAIN_RULES)
    if cfg.param_count() * 12 < REPLICATE_TRAIN_SHARE * CARD_MEMORY:
      rules["embed"] = None
  elif shape_name == "long_500k":
    rules = dict(shd.LONG_RULES)
    if big:
      rules["embed"] = ("data",)
  else:
    rules = dict(shd.SERVE_RULES)
    if big:
      rules["embed"] = ("data",)
  return rules


def microbatches(cfg: cm.ModelConfig, shape: shp.ShapeSpec, mesh) -> int:
  """The reference's adaptive microbatching: the fewest (a power of two,
  at most 16) whose activation residuals, B_local S d 2 B L, fit the
  budget, and that divide the rank's batch."""
  dp = shd.dp_size(mesh)
  est = shape.global_batch // max(dp, 1) * shape.seq_len * cfg.d_model \
      * 2 * cfg.n_layers
  mb = 1
  while mb < 16 and est / mb > MICROBATCH_SHARE * CARD_MEMORY:
    mb *= 2
  while shape.global_batch % (mb * dp) != 0 and mb > 1:
    mb //= 2
  return mb


def _empty_tree(shapes, dtype, device=META):
  if isinstance(shapes, dict):
    return {k: _empty_tree(v, dtype, device) for k, v in shapes.items()}
  return torch.empty(shapes, dtype=dtype, device=device)


def serve_params(cfg: cm.ModelConfig, device=META) -> Dict:
  """The serving path's parameters as ``transformer.init_model`` leaves
  them, empty: ``param_shapes`` in ``cfg.dtype`` with the f32
  unembedding of ``finish_params``."""
  return tf.finish_params(_empty_tree(cm.param_shapes(cfg), cfg.dtype,
                                      device), cfg)


def train_state(cfg: cm.ModelConfig, *, compress: bool,
                device=META) -> Dict:
  """``train_step.init_train_state``'s tree, empty: f32 master weights,
  the AdamW moments and step, and the error feedback to compress."""
  params = _empty_tree(cm.param_shapes(cfg), torch.float32, device)
  state = {"params": params, "opt": opt_lib.init_opt_state(params)}
  if compress:
    state["err"] = comp.init_error_feedback(params)
  return state


def cut_train_state(cfg: cm.ModelConfig, mesh, rules, *, compress: bool,
                    device=META) -> Dict:
  """The rank's shard of :func:`train_state` under ``rules``
  (``shard_train_state``; on ``meta`` nothing is allocated)."""
  return shard_train_state(train_state(cfg, compress=compress,
                                       device=device), cfg, mesh, rules)


def cut_serve_params(cfg: cm.ModelConfig, mesh, rules,
                     device=META) -> Dict:
  """The rank's shard of :func:`serve_params` under ``rules``
  (``shard_params``; on ``meta`` nothing is allocated)."""
  return shd.shard_params(serve_params(cfg, device), cfg, mesh, rules)[0]


def _rows(spec_tree, mesh) -> Dict:
  """A rank's share of a global batch (its contiguous rows over the mesh's
  `pod` / `data` axes), as tensors of its own."""
  axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
  n = mesh.axis_size(axes) if axes else 1
  out = {}
  for k, t in spec_tree.items():
    B = t.shape[0]
    rows = B // n if B % n == 0 else B
    out[k] = torch.empty((rows, *t.shape[1:]), dtype=t.dtype,
                         device=t.device)
  return out


def _leaf_bytes(shape, dtype, axes, mesh, rules) -> int:
  spec = shd.mesh_axes_for(axes, mesh, rules, shape=shape)
  return math.prod(shd.shard_shape(shape, spec, mesh)) * \
      torch.empty((), dtype=dtype).element_size()


def bytes_under_rules(cfg: cm.ModelConfig, shape_name: str, mode: str,
                      mesh, rules) -> int:
  """The per-rank argument bytes the rule tables assign: the weights in
  ``cfg.dtype`` (to train: the f32 master, m and v, and the error feedback
  on the multi-pod mesh), the batch, the decode cache; every leaf cut by
  its logical axes.  To serve, the port holds the unembedding in f32
  (``transformer.finish_params``), cut as an (embed, vocab) leaf: in place
  of the bf16 ``unembed`` where untied, beside ``embed`` where tied; the
  reference holds it in ``cfg.dtype`` (ROADMAP C)."""
  shape = shp.SHAPES[shape_name]
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  total = 0
  if shape.kind == "train":
    copies = 4 if "pod" in mesh.shape else 3
    total += copies * sum(_leaf_bytes(shapes[p], torch.float32, axes[p],
                                      mesh, rules) for p in shapes)
    total += 4                                             # the step
  else:
    total += sum(_leaf_bytes(shapes[p], cfg.dtype, axes[p], mesh, rules)
                 for p in shapes if p != "unembed")
    total += _leaf_bytes((cfg.d_model, cfg.vocab), torch.float32,
                         ("embed", "vocab"), mesh, rules)
  if shape.kind in ("train", "prefill"):
    for t in shp.input_specs(cfg, shape).values():
      total += _leaf_bytes(tuple(t.shape), t.dtype,
                           ("batch",) + (None,) * (t.dim() - 1), mesh, rules)
  else:
    struct = kvc.cache_struct(cfg, shape.global_batch, shape.seq_len,
                              synopsis=mode == "synopsis", cross=True)
    total += sum(_leaf_bytes(sh, dt, ax, mesh, rules)
                 for sh, dt, ax in struct.values())
    total += _leaf_bytes((shape.global_batch, 1), torch.long,
                         ("batch", None), mesh, rules)
  return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: str,
             out_dir: str = "", causal_skip: bool = False,
             rank: int = 0) -> dict:
  """Trace rank ``rank``'s program of one cell on ``meta`` (module doc);
  returns the artifact, written to ``out_dir`` when given."""
  cfg = get_config(arch)
  shape = shp.SHAPES[shape_name]
  mesh = make_abstract_production_mesh(multi_pod=multi_pod, rank=rank)
  chips = mesh.size
  rules = cell_rules(cfg, shape_name, mesh)
  mode = resolve_mode(cfg, shape_name, mode)
  mb = None

  t0 = time.time()
  if shape.kind == "train":
    mb = microbatches(cfg, shape, mesh)
    state = cut_train_state(cfg, mesh, rules, compress=multi_pod)
    batch = _rows(shp.input_specs(cfg, shape), mesh)
    step = make_train_step(
        cfg, opt_lib.OptConfig(), microbatches=mb, compress_pods=multi_pod,
        mesh=mesh, causal_skip=causal_skip)
    args = (state, batch)
  elif shape.kind == "prefill":
    batch = _rows(shp.input_specs(cfg, shape), mesh)
    prefill = make_prefill_step(cfg)
    args = (cut_serve_params(cfg, mesh, rules), batch["tokens"],
            batch.get("frontend_embeds"))
    step = prefill
  else:
    syn = mode == "synopsis"
    struct = kvc.cache_struct(cfg, shape.global_batch, shape.seq_len,
                              synopsis=syn, cross=True)
    cache = shard_cache({k: torch.empty(sh, dtype=dt, device=META)
                         for k, (sh, dt, _) in struct.items()}, mesh, rules)
    lay = cache["layout"]
    tokens = torch.empty((shape.global_batch // lay.dp_n, 1),
                         dtype=torch.long, device=META)
    step = make_serve_step(cfg, mode="synopsis" if syn else "exact")
    args = (cut_serve_params(cfg, mesh, rules), cache, tokens)
  t_setup = time.time() - t0

  mesh.reset_stats()
  with shd.use_mesh(mesh, rules), MemoryTracker(args) as trk:
    out = step(*args)
    trk.finish(out)
  del out
  t_trace = time.time() - t0 - t_setup

  mem = rl.memory_summary(trk)
  coll = rl.collective_bytes(mesh.stats)
  cost = cmod.cell_cost(cfg, shape, mode, causal_skip=causal_skip)
  roof = rl.Roofline(
      flops_per_device=cost.flops_global / chips,
      bytes_per_device=cost.bytes_global / chips,
      coll_bytes_per_device=float(coll["total"]),
      chips=chips,
      model_flops=model_flops(cfg, shape, mode),
  )
  result = {
      "arch": arch, "shape": shape_name,
      "mesh": "multi" if multi_pod else "single", "chips": chips,
      "mode": mode, "rank": rank,
      "microbatches": mb,
      # Building the rank's meta arguments, and tracing its step: the
      # port compiles nothing (the reference's lower and compile).
      "lower_s": round(t_setup, 1), "compile_s": round(t_trace, 1),
      "memory": mem,
      "fits_hbm": mem["peak_bytes_per_device"] < CARD_MEMORY,
      "collectives": coll,
      "collective_calls": mesh.stats["calls"],
      "roofline": roof.to_dict(),
      "card": rl.CARD, "card_memory_bytes": CARD_MEMORY,
      "weights": "cut",
      "argument_bytes_under_rules": bytes_under_rules(
          cfg, shape_name, mode, mesh, rules),
  }
  if out_dir:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_file(arch, shape_name,
                                              result["mesh"], mode)),
              "w") as f:
      json.dump(result, f, indent=1)
  return result


def cell_file(arch: str, shape: str, mesh: str, mode: str) -> str:
  return f"{arch}__{shape}__{mesh}__{mode.replace('/', '_')}.json"


def all_cells(meshes):
  """(arch, shape, mode as asked, mesh) of the sweep, in the reference's
  order."""
  for arch in list_archs():
    for shape, modes in CELLS_MODES.items():
      for mode in modes:
        for m in meshes:
          yield arch, shape, mode, m


def _run_one(cell, args):
  arch, shape, mode, m = cell
  cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", m, "--mode", mode, "--out", args.out]
  if args.causal_skip:
    cmd.append("--causal-skip")
  t0 = time.time()
  try:
    p = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=args.timeout)
    ok, err = p.returncode == 0, p.stderr
  except subprocess.TimeoutExpired as e:
    ok, err = False, f"timed out after {args.timeout} s\n{e.stderr or ''}"
  return ok, err, time.time() - t0


def run_all(args) -> int:
  """Each cell in a subprocess of its own, one for each core the process
  may use, reported in the sweep's order."""
  meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
  cells = list(all_cells(meshes))
  failures = []
  with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
    results = pool.map(lambda c: _run_one(c, args), cells)
    for (arch, shape, mode, m), (ok, err, dt) in zip(cells, results):
      tag = f"{arch} {shape} {m} {mode}"
      print(f"[{'OK' if ok else 'FAIL'}] {tag} ({dt:.0f}s)", flush=True)
      if not ok:
        failures.append(tag)
        print((err or "")[-2000:])
  print(f"\n{'ALL CELLS PASS' if not failures else failures}")
  return 1 if failures else 0


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None)
  ap.add_argument("--mesh", default="single",
                  choices=["single", "multi", "both"])
  ap.add_argument("--mode", default="auto")
  ap.add_argument("--out", default="artifacts/dryrun")
  ap.add_argument("--all", action="store_true")
  ap.add_argument("--timeout", type=int, default=1800,
                  help="seconds a cell may take under --all")
  ap.add_argument("--causal-skip", action="store_true",
                  help="restrict each query chunk's KV range to train")
  args = ap.parse_args(argv)
  if args.all:
    return run_all(args)
  if args.mesh == "both":
    ap.error("--mesh both needs --all")
  if not args.arch or not args.shape:
    ap.error("--arch and --shape (or --all)")
  torch.set_num_threads(1)
  res = run_cell(args.arch, args.shape, args.mesh == "multi", args.mode,
                 args.out, causal_skip=args.causal_skip)
  r = res["roofline"]
  print(json.dumps({k: v for k, v in res.items() if k != "memory"},
                   indent=1))
  print(f"DOMINANT={r['dominant']} bound={r['bound_s']:.4e}s "
        f"fits={res['fits_hbm']}")
  return 0


if __name__ == "__main__":
  sys.exit(main())

"""The port's dry run (``repro_torch.launch.dryrun``): the kernel wrappers'
meta branches, the abstract mesh's tallies and ``run_cell`` on the meta
device.  No card: nothing is allocated and no kernel launches.

* Each kernel wrapper, every branch (unquantized, int8 / fp8 tables, the
  ``+kv`` caches, the latent core, bf16 prefill), called on ``meta`` with
  the arguments the ops layer gives it on the CPU: the outputs have the
  plain version's shapes and dtypes, nothing is launched and the library
  is never loaded; the split-and-merge scratch is allocated as on the
  card (hand-counted).
* ``run_cell`` on decode_32k (exact and synopsis) for every arch on the
  single-pod mesh, and one train, one prefill and one long_500k cell on
  each mesh: the artifact's keys (the reference's, without
  ``raw_cost_analysis``, and the port's), the roofline terms against the
  cost model on the H100's constants, the collectives against an analytic
  count (per sharded attention layer one all-gather of the (B_local, Hkv,
  M/n) f32 scores, synopsis only, and one of the (B_local, H, D+2)
  partials; on the serving cells' cut weights, ``_weight_collectives``:
  the query heads' all-gather, each row-cut product's all-reduce, the
  vocab's, the router's, the SSM's and the FSDP gathers; a train step
  on its cut state: the forward's and the backward's all-reduces, the
  vocab-parallel loss's, the flat gradients' over `data`, the global
  norm's, and an FSDP leaf's reduce-scatter of its gradient), rank 0 and
  the last rank alike; every cell's traced argument bytes equal to the
  rule tables' (its weights, or its train state, cut); the CLI's line and
  the report.
"""
import json
import math

import pytest
import torch

from repro_torch.analysis import costmodel as cost
from repro_torch.analysis import report
from repro_torch.analysis import roofline as roof
from repro_torch.analysis.tracker import MemoryTracker, storage_bytes
from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.dist import sharding as shd
from repro_torch.kernels import _build, ops
from repro_torch.kernels import quant as qt
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build
from repro_torch.kernels.synopsis_score import synopsis_score
from repro_torch.launch import dryrun as dr
from repro_torch.models import common as cm

torch.set_num_threads(1)

WRAPPERS = {f.__name__: f for f in (
    flash_prefill, segment_build, fused_synopsis_score_attention,
    block_gather_attention, flash_decode, synopsis_score)}
QSPECS = ("none", "int8", "fp8", "int8+kv", "fp8+kv")


def _meta(x):
  if isinstance(x, torch.Tensor):
    return x.to("meta")
  if isinstance(x, (tuple, list)):
    return type(x)(_meta(t) for t in x)
  if isinstance(x, dict):
    return {k: _meta(v) for k, v in x.items()}
  return x


def _layout(x):
  if isinstance(x, torch.Tensor):
    return (tuple(x.shape), x.dtype)
  if isinstance(x, (tuple, list)):
    return tuple(_layout(t) for t in x)
  if isinstance(x, dict):
    return {k: _layout(v) for k, v in x.items()}
  return x


def _recorded_calls(case):
  """The wrappers' calls (name, args, kwargs) that the ops layer makes on
  the CPU for one case: prefill, build, the fused decode, the unfused op
  and exact decode with a strided window."""
  calls = []

  def rec(name):
    fn = WRAPPERS[name]

    def wrapped(*a, **kw):
      calls.append((name, a, kw))
      return fn(*a, **kw)
    return wrapped

  mp = pytest.MonkeyPatch()
  for name in WRAPPERS:
    mp.setattr(ops, name, rec(name))
  try:
    _drive_ops(**case)
  finally:
    mp.undo()
  return calls


def _drive_ops(spec, D, Hkv, G, dtype, q_dtype):
  g = torch.Generator().manual_seed(0)
  B, C, M, R = 2, 16, 8, 5
  S, H = M * C, Hkv * G

  def rnd(*shape, dt=dtype):
    return torch.randn(shape, generator=g).to(dt)

  latent = _build.is_latent(D)
  if not latent and spec == "none":
    qp = rnd(B, S, H, D)
    ops.prefill_attention(qp, rnd(B, S, Hkv, D), rnd(B, S, Hkv, D),
                          sm_scale=0.3, window=7)
  k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
  perm = torch.stack([torch.randperm(S, generator=g) for _ in range(B)])
  built = ops.synopsis_build(k, v, perm, cluster_size=C,
                             qconfig=None if spec == "none" else spec)
  if spec == "none":
    built = dict(zip(("k", "v", "k_syn", "v_syn", "counts"), built))
  q = rnd(B, H, D, dt=q_dtype)
  ring = rnd(B, Hkv, R, D), rnd(B, Hkv, R, D)
  self_kv = rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D)
  ops.synopsis_cache_attention(
      q, built["k"], built["v"], built["k_syn"], built["v_syn"],
      built["counts"], *ring, torch.tensor([3, 5]), *self_kv,
      *(built.get(n) for n in qt.SCALE_LEAVES), i_max=3, cluster_size=C,
      sm_scale=0.25)
  if spec == "none":
    ops.synopsis_attention(q, built["k"], built["v"], built["k_syn"],
                           built["v_syn"], built["counts"], i_max=3,
                           sm_scale=0.25)
    ops.decode_partials(q, k[:, :, -40:], v[:, :, -40:], sm_scale=0.25,
                        cap=30.0)


WRAPPER_CASES = {
    **{f"f32-{s}": dict(spec=s, D=16, Hkv=2, G=2, dtype=torch.float32,
                        q_dtype=torch.float32) for s in QSPECS},
    "bf16": dict(spec="none", D=64, Hkv=2, G=4, dtype=torch.bfloat16,
                 q_dtype=torch.bfloat16),
    **{f"latent-{s}": dict(spec=s, D=48, Hkv=1, G=8, dtype=torch.float32,
                           q_dtype=torch.float32)
       for s in ("none", "int8+kv", "fp8")},
}


@pytest.mark.parametrize("name", list(WRAPPER_CASES))
def test_wrappers_meta_outputs_match_the_plain_versions(name, monkeypatch):
  """On ``meta`` each wrapper returns what its plain version returns on
  the CPU, shape for shape and dtype for dtype, and launches nothing: the
  library is never asked for and no launch is counted."""
  calls = _recorded_calls(WRAPPER_CASES[name])
  seen = {c[0] for c in calls}
  assert {"segment_build", "fused_synopsis_score_attention",
          "block_gather_attention"} <= seen, seen

  def no_library():
    raise AssertionError("a meta tensor reached a kernel launch")
  monkeypatch.setattr(_build, "library", no_library)
  before = dict(_build.LAUNCHES)
  for wname, args, kw in calls:
    want = WRAPPERS[wname](*args, **kw)
    got = WRAPPERS[wname](*_meta(args), **_meta(kw))
    assert _layout(got) == _layout(want), wname
    for t in (got if isinstance(got, (tuple, list)) else [got]):
      for x in (t if isinstance(t, (tuple, list)) else [t]):
        assert not isinstance(x, torch.Tensor) or x.device.type == "meta"
  assert _build.LAUNCHES == before


def test_meta_branch_allocates_the_split_scratch():
  """flash_decode over 4096 rows on ``meta`` chunks S by the H100's 132
  SMs (32 chunks of 128 rows at B Hkv = 2) and allocates the outputs and
  one scratch buffer of the chunks' partials, as its CUDA launch does."""
  B, Hkv, G, D, S = 1, 2, 4, 128, 4096
  H = Hkv * G
  q = torch.empty((B, H, D), device="meta")
  k = torch.empty((B, Hkv, S, D), device="meta")
  flash_decode(q, k, k)                    # the merge tickets, made once
  with MemoryTracker({"q": q, "k": k}) as trk:
    out = flash_decode(q, k, k)
    trk.finish(out)
  nsplit = 32
  unit = lambda n: -(-n // 512) * 512  # noqa: E731
  assert trk.output_bytes == unit(B * H * D * 4) + 2 * unit(B * H * 4)
  assert trk.temp_bytes == unit(B * H * nsplit * (D + 2) * 4)


def test_cpu_and_other_devices_never_take_the_meta_branch():
  """A CPU tensor runs the plain version (values, on the CPU); past the
  plain version's branch, a tensor on neither CUDA nor ``meta`` is
  refused by the wrappers' first check."""
  q = torch.randn(1, 4, 16)
  k = torch.randn(1, 2, 32, 16)
  o, m, l = flash_decode(q, k, k)
  assert o.device.type == "cpu" and torch.isfinite(o).all()
  with pytest.raises(ValueError, match="CUDA"):
    _build.dtype_code("x", torch.empty(1))


# -- run_cell on the meta device -----------------------------------------------

JAX_KEYS = {"arch", "shape", "mesh", "chips", "mode", "microbatches",
            "lower_s", "compile_s", "memory", "fits_hbm", "collectives",
            "roofline"}
PORT_KEYS = {"rank", "collective_calls", "card", "card_memory_bytes",
             "weights", "argument_bytes_under_rules"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes", "peak_bytes_per_device"}


def _check_artifact(res, arch, shape_name, mode, multi):
  cfg, shape = get_config(arch), shp.SHAPES[shape_name]
  assert set(res) == JAX_KEYS | PORT_KEYS
  assert set(res["memory"]) == MEM_KEYS
  assert res["mesh"] == ("multi" if multi else "single")
  assert res["chips"] == (512 if multi else 256)
  assert res["weights"] == "cut"
  assert res["card"] == roof.CARD
  c = cost.cell_cost(cfg, shape, res["mode"])
  r = res["roofline"]
  chips = res["chips"]
  assert r["flops_per_device"] == c.flops_global / chips
  assert r["bytes_per_device"] == c.bytes_global / chips
  assert r["compute_s"] == r["flops_per_device"] / roof.PEAK_FLOPS
  assert r["memory_s"] == r["bytes_per_device"] / roof.HBM_BW
  assert r["collective_s"] == res["collectives"]["total"] / roof.COLL_BW
  assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                             r["collective_s"])
  assert r["model_flops"] == dr.model_flops(cfg, shape, mode)
  m = res["memory"]                 # the rank's cut program
  assert m["argument_size_in_bytes"] == res["argument_bytes_under_rules"]
  assert m["peak_bytes_per_device"] == (
      m["argument_size_in_bytes"] + m["output_size_in_bytes"]
      + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])
  assert res["fits_hbm"] == (m["peak_bytes_per_device"]
                             < dr.CARD_MEMORY)
  assert res["collectives"]["total"] == sum(
      res["collectives"][k] for k in shd.COLLECTIVES)


def _attn_gathers(cfg, res, mode, B, S, rules):
  """Operand bytes of the sharded attention's all-gathers a step."""
  mesh = dr.make_abstract_production_mesh(multi_pod=res["mesh"] == "multi")
  seq = rules["kv_seq"]
  seq = (seq,) if isinstance(seq, str) else tuple(seq)
  n = math.prod(mesh.shape[a] for a in seq)
  dp = tuple(a for a in ("pod", "data") if a in mesh.shape and a not in seq)
  dp_n = math.prod(mesh.shape[a] for a in dp) if dp else 1
  b = B // dp_n if B % dp_n == 0 else B
  Hkv, D = cm.kv_dims(cfg)
  H = cfg.n_heads
  n_attn = cm.n_attn_positions(cfg) * cfg.n_blocks
  n_glob = sum(not s.local for s in cfg.block_pattern
               if s.kind == "attn") * cfg.n_blocks
  M = S // cfg.synopsis.cluster_size
  parts = b * H * (D + 2) * 4 * n_attn
  scores = b * Hkv * (M // n) * 4 * n_glob if mode == "synopsis" else 0
  return parts + scores


def _weight_collectives(cfg, rules, mesh, b):
  """The operand bytes, by kind, of the collectives a decode step on the
  rank's cut weights makes for one token of each of its b rows (the
  attention's own gathers aside): the FSDP gathers of every cut ``embed``
  dim (a layer's leaves as ``layer_params`` slices them, the embedding,
  final norm and f32 unembedding where used); the embedding's all-reduce
  over a cut vocab and the logits' all-gather; per attention layer the
  query heads' all-gather (MLA: the f32 q_eff) over a sequence-cut cache
  and ``wo``'s all-reduce (MLA's in f32); a cross block's ``wo``; an
  MLP's ``w2``; an MoE's router logits (f32), its partial combine and
  its shared experts; a mamba layer's ``in_proj`` output and conv output
  (f32) all-gathered, the gated norm's squares (f32) and ``out_proj``
  all-reduced.  ``Mesh.all_reduce`` tallies its operand, padded to a
  multiple of the line's ranks, as all-to-all and one piece of it as
  all-gather."""
  tally = {k: 0 for k in shd.COLLECTIVES}
  dt = 2                                      # bf16
  d = cfg.d_model
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  shapes["unembed"], axes["unembed"] = (d, cfg.vocab), ("embed", "vocab")

  def spec(path):
    return shd.mesh_axes_for(axes[path], mesh, rules, shape=shapes[path])

  def n_of(entry):
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else entry)
    return math.prod(mesh.shape[a] for a in names)

  def gather(nbytes):
    tally["all-gather"] += nbytes

  def reduce(numel, es, n):
    if n > 1:
      padded = -(-numel // n) * n
      tally["all-to-all"] += padded * es
      tally["all-gather"] += padded // n * es

  def fsdp(path, stacked):
    sp = spec(path)
    if any(a == "embed" and e is not None for a, e in zip(axes[path], sp)):
      shape = shd.shard_shape(shapes[path], sp, mesh)
      es = 4 if path == "unembed" else dt
      gather(math.prod(shape[1:] if stacked else shape) * es)

  def cut(path, dim):
    return n_of(spec(path)[dim])

  # The embedding, the final norm, the logits.
  for path in ("embed", "final_norm", "unembed"):
    fsdp(path, False)
  reduce(b * d, dt, cut("embed", 0))
  if cut("unembed", 1) > 1:
    gather(b * cfg.vocab // cut("unembed", 1) * 4)
  for b_ in range(cfg.n_blocks):
    del b_
    for i, ls in enumerate(cfg.block_pattern):
      pre = f"blocks/pos{i}/"
      for path in shapes:
        if path.startswith(pre):
          fsdp(path, True)
      if ls.kind == "attn" and cfg.mla is not None:
        n = cut(pre + "attn/wq_b", 2)
        if n > 1:
          m = cfg.mla
          gather(b * cfg.n_heads // n * (m.kv_lora_rank + m.qk_rope_dim)
                 * 4)
        reduce(b * d, 4, cut(pre + "attn/wo", 1))
      elif ls.kind == "attn":
        n = cut(pre + "attn/wq", 2)
        if n > 1:
          gather(b * cfg.n_heads // n * cfg.hd * dt)
        reduce(b * d, dt, cut(pre + "attn/wo", 1))
        if ls.cross_attn:
          reduce(b * d, dt, cut(pre + "cross/wo", 1))
      else:
        _, _, conv = cm.ssm_dims(cfg)
        n = cut(pre + "ssm/in_proj", 2)
        if n > 1:
          gather(b * shapes[pre + "ssm/in_proj"][2] // n * dt)
        n = cut(pre + "ssm/conv_w", 2)
        if n > 1:
          gather(b * conv // n * 4)
        reduce(b, 4, cut(pre + "ssm/A_log", 1))
        reduce(b * d, dt, cut(pre + "ssm/out_proj", 1))
      if ls.use_moe and cfg.moe is not None:
        n = cut(pre + "moe/router", 2)
        if n > 1:
          gather(b * cfg.moe.num_experts // n * 4)
        reduce(b * d, dt, cut(pre + "moe/w1", 1) * cut(pre + "moe/w1", 3))
        if cfg.moe.num_shared:
          reduce(b * d, dt, cut(pre + "moe/shared/w2", 1))
        if cfg.moe.dense_parallel:
          reduce(b * d, dt, cut(pre + "mlp/w2", 1))
      elif pre + "mlp/w2" in shapes:
        reduce(b * d, dt, cut(pre + "mlp/w2", 1))
  return tally


@pytest.mark.parametrize("mode", ["exact", "synopsis"])
@pytest.mark.parametrize("arch", list_archs())
def test_decode_32k_cell(arch, mode):
  res = dr.run_cell(arch, "decode_32k", False, mode)
  cfg = get_config(arch)
  want_mode = "exact" if cm.n_attn_positions(cfg) == 0 else mode
  assert res["mode"] == want_mode
  _check_artifact(res, arch, "decode_32k", want_mode, False)
  assert res["microbatches"] is None
  mesh = dr.make_abstract_production_mesh()
  rules = dr.cell_rules(cfg, "decode_32k", mesh)
  want = _weight_collectives(cfg, rules, mesh, 128 // 16)
  want["all-gather"] += _attn_gathers(cfg, res, want_mode, 128, 32768,
                                      shd.SERVE_RULES)
  assert {k: res["collectives"][k] for k in shd.COLLECTIVES} == want
  assert res["collectives"]["total"] == sum(want.values())


@pytest.mark.parametrize("arch,rules", [
    ("llama3-8b", dict(shd.SERVE_RULES)),
    ("deepseek-v2-236b", dict(shd.SERVE_RULES, embed=("data",)))])
def test_decode_32k_weights_cut_by_the_rules(arch, rules, monkeypatch):
  """A serving cell traces the rank's cut program: its traced argument
  bytes equal ``argument_bytes_under_rules`` (the weights, the cache and
  the tokens at the rule tables' bytes a rank, the f32 unembedding
  included), with deepseek-v2's weights FSDP-cut over `data` too (a
  table ``cell_rules`` gives it only past the card's threshold, put in
  its place here)."""
  monkeypatch.setattr(dr, "cell_rules", lambda *a: dict(rules))
  res = dr.run_cell(arch, "decode_32k", False, "synopsis")
  assert res["weights"] == "cut"
  mesh = dr.make_abstract_production_mesh()
  assert res["memory"]["argument_size_in_bytes"] == \
      res["argument_bytes_under_rules"] == dr.bytes_under_rules(
          get_config(arch), "decode_32k", "synopsis", mesh, rules)
  want = _weight_collectives(get_config(arch), rules, mesh, 128 // 16)
  assert res["collectives"]["all-to-all"] == want["all-to-all"]


def test_ranks_tally_alike():
  """Rank 0 of gemma2's exact decode holds no row of any local layer's
  window (the last 4096 of 32768 rows lie on model shards 14 and 15), the
  last rank all of its shard: both make the same collectives."""
  first = dr.run_cell("gemma2-2b", "decode_32k", False, "exact", rank=0)
  last = dr.run_cell("gemma2-2b", "decode_32k", False, "exact", rank=255)
  assert first["collectives"] == last["collectives"]
  assert first["collective_calls"] == last["collective_calls"]
  assert first["memory"]["argument_size_in_bytes"] == \
      last["memory"]["argument_size_in_bytes"]


def _padded(numel, n):
  return -(-numel // n) * n


@pytest.mark.parametrize("multi", [False, True])
def test_train_cell(multi):
  """smollm-135m's train step on its rank's rows and its cut state (no
  FSDP for a model this small: ``embed -> None``; its 9 heads whole over
  16, its ff and vocab cut).  The all-reduces, each tallied as an
  all-to-all of its padded operand and an all-gather of one piece: the
  embedding lookup's, each layer's MLP partials' (the checkpoint's
  recompute stops before it), and the backward's sums of each MLP
  input's partial cotangent (bf16 (b, S, d)); per loss chunk the gold
  logit's (f32 (b, 1024), again in the recompute) and the chunk input's
  partial cotangent (bf16 (b, 1024, d)); the flat f32 gradients of the
  rank's shards, with the loss and two metrics, over the data-parallel
  ranks; the global norm's one scalar over `model`.  The all-gathers
  besides: each chunk's logsumexp over the vocab's ranks (f32 (b, 1024),
  again in the recompute); on the multi-pod mesh the compressed cross-pod
  reduction's."""
  res = dr.run_cell("smollm-135m", "train_4k", multi, "auto")
  cfg = get_config("smollm-135m")
  assert res["mode"] == "n/a" and res["microbatches"] == 1
  _check_artifact(res, "smollm-135m", "train_4k", "n/a", multi)
  mesh = dr.make_abstract_production_mesh(multi_pod=multi)
  rules = dr.cell_rules(cfg, "train_4k", mesh)
  assert rules["embed"] is None
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  n = sum(math.prod(shd.shard_shape(s, shd.mesh_axes_for(
      axes[p], mesh, rules, shape=s), mesh)) for p, s in shapes.items())
  dp, tp = (32 if multi else 16), 16
  shape = shp.SHAPES["train_4k"]
  b, S, d, L = shape.global_batch // dp, shape.seq_len, cfg.d_model, \
      cfg.n_layers
  chunks = S // 1024
  reduces = ([(b * S * d, 2)] * (1 + 2 * L) + [(b * 1024, 4)] * (2 * chunks)
             + [(b * 1024 * d, 2)] * chunks + [(1, 4)])
  a2a = sum(_padded(m, tp) * es for m, es in reduces)
  a2a += _padded(n + 3, dp) * 4
  assert res["collectives"]["all-to-all"] == a2a
  assert res["collectives"]["reduce-scatter"] == 0
  gathers = sum(_padded(m, tp) // tp * es for m, es in reduces) \
      + _padded(n + 3, dp) // dp * 4 + 2 * chunks * b * 1024 * 4
  if not multi:
    assert res["collectives"]["all-gather"] == gathers
  else:
    assert res["collectives"]["all-gather"] > gathers


def test_train_cell_fsdp():
  """llama3-8b's train step (``TRAIN_RULES``: FSDP over `data`, its
  heads, ff and vocab over `model`): its traced argument bytes are the
  rules' (the cut master, m and v), and each FSDP leaf's gathered
  gradient is reduce-scattered once a step (the checkpoint's recompute
  gathers again, but the backward runs through the first gather): the
  bf16 bytes of every FSDP-cut leaf with its `data` cut undone, a layer's
  slice of a stacked leaf once a layer."""
  res = dr.run_cell("llama3-8b", "train_4k", False, "auto")
  cfg = get_config("llama3-8b")
  _check_artifact(res, "llama3-8b", "train_4k", "n/a", False)
  mesh = dr.make_abstract_production_mesh()
  rules = dr.cell_rules(cfg, "train_4k", mesh)
  assert rules["embed"] == "data" and res["microbatches"] == 1
  shapes = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  want = 0
  for p, s in shapes.items():
    spec = shd.mesh_axes_for(axes[p], mesh, rules, shape=s)
    if not any(a == "embed" and e for a, e in zip(axes[p], spec)):
      continue
    local = shd.shard_shape(s, spec, mesh)
    want += math.prod(local) * mesh.shape["data"] * 2      # bf16, whole
  assert res["collectives"]["reduce-scatter"] == want > 0


@pytest.mark.parametrize("multi", [False, True])
def test_prefill_cell(multi):
  """A prefill takes its rank's batch rows and its cut weights: smollm's
  9 heads stay whole over 16 (no attention collective), its ff and vocab
  are cut (the MLP's all-reduces, the embedding's, the logits'
  all-gather); the prompt's KV needs none."""
  cfg = get_config("smollm-135m")
  res = dr.run_cell("smollm-135m", "prefill_32k", multi, "auto")
  _check_artifact(res, "smollm-135m", "prefill_32k", "n/a", multi)
  rows = 32 // (32 if multi else 16)
  mesh = dr.make_abstract_production_mesh(multi_pod=multi)
  rules = dr.cell_rules(cfg, "prefill_32k", mesh)
  assert res["memory"]["argument_size_in_bytes"] == (
      storage_bytes(dr.cut_serve_params(cfg, mesh, rules))
      + rows * 32768 * 4)
  d, n = cfg.d_model, 16
  tokens = rows * 32768
  reduce = lambda numel: -(-numel // n) * n * 2  # noqa: E731
  assert res["collectives"]["all-to-all"] == reduce(tokens * d) * (
      1 + cfg.n_layers)
  assert res["collectives"]["all-gather"] == (
      reduce(tokens * d) // n * (1 + cfg.n_layers)
      + rows * cfg.vocab // n * 4)


@pytest.mark.parametrize("multi", [False, True])
def test_long_500k_cell(multi):
  """jamba's long_500k synopsis step under LONG_RULES: the sequence over
  (data, model), 256 shards, the batch of one whole."""
  res = dr.run_cell("jamba-v0.1-52b", "long_500k", multi, "auto")
  cfg = get_config("jamba-v0.1-52b")
  assert res["mode"] == "synopsis"
  _check_artifact(res, "jamba-v0.1-52b", "long_500k", "synopsis", multi)
  mesh = dr.make_abstract_production_mesh(multi_pod=multi)
  rules = dr.cell_rules(cfg, "long_500k", mesh)
  want = _weight_collectives(cfg, rules, mesh, 1)
  want["all-gather"] += _attn_gathers(cfg, res, "synopsis", 1, 524288,
                                      rules)
  assert {k: res["collectives"][k] for k in shd.COLLECTIVES} == want


def test_cli_and_report(tmp_path, capsys):
  """The CLI writes one artifact and prints the reference's last line;
  the report reads the artifacts."""
  assert dr.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                  "--mesh", "single", "--mode", "synopsis",
                  "--out", str(tmp_path)]) == 0
  last = capsys.readouterr().out.strip().splitlines()[-1]
  assert last.startswith("DOMINANT=") and " bound=" in last and \
      last.endswith("fits=True")
  files = list(tmp_path.glob("*.json"))
  assert [f.name for f in files] == [
      "mamba2-370m__decode_32k__single__exact.json"]
  d = json.loads(files[0].read_text())
  assert d["mode"] == "exact"
  cells = report.load(str(tmp_path))
  text = report.summary(cells)
  assert "cells traced: 1" in text and "fit in 80 GB" in text
  assert "mamba2-370m" in report.dryrun_table(cells)
  assert "mamba2-370m" in report.roofline_table(cells)
  assert d["weights"] == "cut"
  # Every cell traces its cut program: the report names the cells whose
  # traced peak does not fit, train and serving cells alike.
  a, b, c = (("a", "train_4k", "single", "n/a"),
             ("b", "train_4k", "single", "n/a"),
             ("c", "decode_32k", "single", "exact"))
  over = {a: dict(d, shape="train_4k", fits_hbm=False),
          b: dict(d, shape="train_4k"),
          c: dict(d, fits_hbm=False)}
  assert report.over_card({**cells, **over}) == [a, c]
  text = report.summary({**cells, **over})
  assert "(serving cells 1/2, train cells 1/2)" in text
  assert text.endswith("do not fit 80 GB as traced: a train_4k single "
                       "n/a, c decode_32k single exact")


def test_memory_policies_scale_the_references_to_the_card():
  """The reference's thresholds are 10, 2 and 6 GB of a 16 GB chip: the
  port's are the same shares of the card's memory."""
  assert (dr.FSDP_SERVE_SHARE, dr.REPLICATE_TRAIN_SHARE,
          dr.MICROBATCH_SHARE) == (10 / 16, 2 / 16, 6 / 16)
  mesh = dr.make_abstract_production_mesh()
  small = dr.cell_rules(get_config("smollm-135m"), "train_4k", mesh)
  assert small["embed"] is None
  big = dr.cell_rules(get_config("arctic-480b"), "decode_32k", mesh)
  assert big["embed"] == ("data",)
  shape = shp.SHAPES["train_4k"]
  budget = dr.MICROBATCH_SHARE * dr.CARD_MEMORY

  def residuals(cfg):
    return (shape.global_batch // shd.dp_size(mesh) * shape.seq_len
            * cfg.d_model * 2 * cfg.n_layers)
  # llama3-8b's residuals exceed the reference's 6 GB but fit the card's
  # share in one; command-r-plus-104b's take 4 microbatches on the card.
  llama, cmdr = get_config("llama3-8b"), get_config("command-r-plus-104b")
  assert 6e9 < residuals(llama) <= budget
  assert dr.microbatches(llama, shape, mesh) == 1
  assert residuals(cmdr) / 4 <= budget < residuals(cmdr) / 2
  assert dr.microbatches(cmdr, shape, mesh) == 4

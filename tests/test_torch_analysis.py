"""The port's dry-run analysis (``repro_torch.configs.shapes``,
``models.common.param_axes``, the spec helpers of ``dist.sharding``,
``analysis.{costmodel,roofline,tracker}``) against the JAX package.

* ``SHAPES`` and ``input_specs`` against ``repro.configs.shapes`` for every
  arch x shape.
* ``param_axes`` against the JAX tree's ``Box`` axes (``jax.eval_shape`` of
  ``init_model``) for every leaf of every arch at full size, and every
  leaf's spec and per-rank shape under ``DEFAULT``, ``TRAIN``, ``SERVE``
  and ``LONG_RULES`` on the (16, 16) and (2, 16, 16) meshes against
  ``repro.dist.sharding.mesh_axes_for`` and ``NamedSharding.shard_shape``
  on an abstract mesh; the decode cache's leaves (whisper's cross leaves
  too) the same way.
* ``cell_cost``: FLOPs equal to the reference's (rel 1e-12) for every arch
  x shape x mode, budget and ``causal_skip``; bytes equal to the
  reference's plus the two stated differences, computed here.
* ``synopsis_traffic`` and ``traffic_reduction`` equal for every quant
  spec; the ``Roofline`` terms on the H100's constants.
* The memory tracker on a hand-counted meta program.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.analysis import costmodel as jcost
from repro.analysis import roofline as jroof
from repro.configs import shapes as jshapes
from repro.configs.registry import get_config as j_get_config
from repro.dist import sharding as jshd
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import kv_cache as jkvc
from repro_torch.analysis import costmodel as cost
from repro_torch.analysis import roofline as roof
from repro_torch.analysis.tracker import MemoryTracker, storage_bytes
from repro_torch.configs import shapes
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.dist import sharding as shd
from repro_torch.models import common as cm
from repro_torch.serve import kv_cache as kvc

torch.set_num_threads(1)

ARCHS = list_archs()
RULES = ("DEFAULT_RULES", "TRAIN_RULES", "SERVE_RULES", "LONG_RULES")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
QSPECS = ("none", "int8", "fp8", "int8+kv", "fp8+kv")
_JDT = {"bfloat16": torch.bfloat16, "int32": torch.int32}


class FakeMesh:

  def __init__(self, dims, names):
    self.shape = dict(zip(names, dims))


def test_shapes_equal_jax():
  assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
      {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
  """The same inputs at the same shapes, on ``meta``; the dtypes the
  port's steps take (a decode token is the previous argmax: int64)."""
  cfg, jcfg = get_config(arch), j_get_config(arch)
  for name, spec in shapes.SHAPES.items():
    got = shapes.input_specs(cfg, spec)
    want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
    assert set(got) == set(want), (arch, name)
    for k, t in got.items():
      assert t.device.type == "meta"
      assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
      assert t.dtype == (torch.long if spec.kind == "decode"
                         else _JDT[str(want[k].dtype)]), (arch, name, k)


def _jax_axes(arch):
  jcfg = j_get_config(arch)
  cap = {}

  def init(key):
    params, axes = jcm.split(jtf.init_model(key, jcfg))
    cap["axes"] = axes
    return params

  sds = jax.eval_shape(init, jax.random.PRNGKey(0))
  flat = {"/".join(str(getattr(p, "key", p)) for p in path): ax
          for path, ax in jax.tree_util.tree_flatten_with_path(
              cap["axes"], is_leaf=lambda x: isinstance(x, tuple))[0]}
  shapes_ = {"/".join(str(getattr(p, "key", p)) for p in path): x.shape
             for path, x in jax.tree_util.tree_flatten_with_path(sds)[0]}
  return flat, shapes_


@pytest.fixture(scope="module")
def jax_axes():
  return {arch: _jax_axes(arch) for arch in ARCHS}


def _resolve(axes, shape, mesh_name, rules_name):
  dims, names = MESHES[mesh_name]
  fake = FakeMesh(dims, names)
  spec = shd.mesh_axes_for(axes, fake, getattr(shd, rules_name),
                           shape=shape)
  want = tuple(jshd.mesh_axes_for(axes, fake, getattr(jshd, rules_name),
                                  shape=shape))
  want += (None,) * (len(shape) - len(want))
  shard = shd.shard_shape(shape, spec, fake)
  want_shard = NamedSharding(AbstractMesh(dims, names),
                             PartitionSpec(*want)).shard_shape(shape)
  return spec, want, shard, tuple(want_shard)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_jax_boxes(arch, jax_axes):
  """Every leaf of ``param_shapes`` has the JAX tree's shape and ``Box``
  axes, and no leaf is missing on either side; each resolves to the
  reference's spec and per-rank shape under every rule table and mesh."""
  jaxes, jshapes_ = jax_axes[arch]
  cfg = get_config(arch)
  got = dict(cm.leaves(cm.param_axes(cfg)))
  sh = dict(cm.leaves(cm.param_shapes(cfg)))
  assert set(got) == set(jaxes) == set(sh), set(got) ^ set(jaxes)
  for path, axes in got.items():
    assert tuple(axes) == tuple(jaxes[path]), path
    assert tuple(sh[path]) == tuple(jshapes_[path]), path
    for rules in RULES:
      for m in MESHES:
        spec, want, shard, want_shard = _resolve(axes, sh[path], m, rules)
        assert spec == want, (path, rules, m)
        assert shard == want_shard, (path, rules, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_resolve_as_jax(arch):
  """The decode caches' leaves (exact and synopsis; whisper's cross leaves
  under ``cross=True``) have the JAX layout's shapes and axes and resolve
  to its specs and per-rank shapes."""
  cfg, jcfg = get_config(arch), j_get_config(arch)
  for syn in (False, True):
    for B, S in ((128, 32768), (1, 524288)):
      got = kvc.cache_struct(cfg, B, S, synopsis=syn, cross=True)
      want = jkvc.cache_struct(jcfg, B, S, synopsis=syn)
      assert set(got) == set(want), (arch, syn)
      for k, (sh, _, ax) in got.items():
        assert tuple(sh) == tuple(want[k][0]) and ax == want[k][2], k
        for rules in RULES:
          for m in MESHES:
            spec, jspec, shard, jshard = _resolve(ax, sh, m, rules)
            assert (spec, shard) == (jspec, jshard), (k, rules, m)


def test_cross_cache_is_refused_without_cross():
  with pytest.raises(NotImplementedError):
    kvc.cache_struct(get_config("whisper-medium"), 2, 256, synopsis=True)


def _modes(spec):
  return ("exact", "synopsis") if spec.kind == "decode" else ("n/a",)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_jax(arch):
  """FLOPs equal to the reference's; bytes the reference's with the port's
  parameter count in place of its count, and a decode step's weights read
  once (the reference reads them twice)."""
  cfg, jcfg = get_config(arch), j_get_config(arch)
  n, nj = cfg.param_count(), jcfg.param_count()
  for name, spec in shapes.SHAPES.items():
    jspec = jshapes.SHAPES[name]
    for mode in _modes(spec):
      for i_max in (None, 8, 64):
        for skip in (False, True):
          got = cost.cell_cost(cfg, spec, mode, i_max=i_max,
                               causal_skip=skip)
          want = jcost.cell_cost(jcfg, jspec, mode, i_max=i_max,
                                 causal_skip=skip)
          key = (name, mode, i_max, skip)
          assert got.flops_global == pytest.approx(want.flops_global,
                                                   rel=1e-12), key
          per = {"train": 2 * 3 + 4 + 3 * 4 * 2}.get(spec.kind, 2)
          exp = want.bytes_global + (n - nj) * per
          if spec.kind == "decode":
            exp -= 2 * nj
          assert got.bytes_global == pytest.approx(exp, rel=1e-12), key


@pytest.mark.parametrize("quant", QSPECS)
def test_synopsis_traffic_equals_jax(quant):
  for kw in (dict(batch=2, kv_heads=8, m=64, d=128, cluster_size=128,
                  i_max=32),
             dict(batch=4, kv_heads=1, m=1024, d=576, cluster_size=64,
                  i_max=8, native_bytes=2)):
    assert roof.synopsis_traffic(quant=quant, **kw) == \
        jroof.synopsis_traffic(quant=quant, **kw)
    assert roof.traffic_reduction(quant, **kw) == \
        jroof.traffic_reduction(quant, **kw)
  with pytest.raises(ValueError):
    roof.synopsis_traffic(quant="int4", batch=1, kv_heads=1, m=1, d=16,
                          cluster_size=1, i_max=1)


def test_roofline_terms_on_the_h100():
  """Each term is its numerator over the card's constant: 989e12 bf16
  FLOP/s, 3.35e12 B/s HBM, 50e9 B/s a collective link."""
  assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.COLL_BW) == (989e12, 3.35e12,
                                                         50e9)
  assert roof.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
  r = roof.Roofline(flops_per_device=989e12, bytes_per_device=6.7e12,
                    coll_bytes_per_device=25e9, chips=4, model_flops=2e15)
  assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 0.5)
  assert r.dominant == "memory" and r.bound_s == 2.0
  assert r.useful_flops_ratio == pytest.approx(2e15 / (4 * 989e12))
  d = r.to_dict()
  assert d["dominant"] == "memory" and d["chips"] == 4
  coll = roof.collective_bytes({"calls": 3, "all-gather": 10,
                                "all-to-all": 5})
  assert coll == {"all-gather": 10, "all-reduce": 0, "reduce-scatter": 0,
                  "all-to-all": 5, "collective-permute": 0, "total": 15}
  assert set(coll) == {*shd.COLLECTIVES, "total"}


def test_tracker_on_a_hand_counted_program():
  """A view counts once (its base's storage), an in-place op adds
  nothing, a temporary freed inside the program leaves the peak but not
  the end; outputs that are arguments are aliases; each storage is charged
  in units of 512 bytes, as the caching allocator charges it."""
  x = torch.empty(1000, 250, device="meta")            # 1e6 bytes
  w = torch.empty(250, device="meta")
  args = {"x": x, "xv": x[:10], "w": w}
  assert storage_bytes(args) == 1_000_000 + 1000

  def program(a):
    y = a["x"] * 2                       # new: 1e6 -> 1_000_448 charged
    z = y[:, :3]                         # a view: nothing
    y.add_(1)                            # in place: nothing
    t = (y + a["w"]).sum()               # temporary 1e6, then 4 bytes
    u = torch.empty(0, device="meta")    # nothing
    return {"z": z, "t": t, "w": a["w"], "u": u}

  with MemoryTracker(args) as trk:
    out = program(args)
    trk.finish(out)
  big = math.ceil(1_000_000 / 512) * 512
  assert trk.argument_bytes == 1_001_000
  assert trk.alias_bytes == 1000
  assert trk.output_bytes == big + 512 + 1000
  assert trk.peak_bytes == 2 * big + 512
  assert trk.temp_bytes == trk.peak_bytes - (big + 512)
  mem = roof.memory_summary(trk)
  assert mem["peak_bytes_per_device"] == (
      trk.argument_bytes + trk.output_bytes + trk.temp_bytes
      - trk.alias_bytes)
  assert mem["generated_code_size_in_bytes"] == 0
  del out
  assert trk.live_bytes == 0


def test_tracker_sees_the_backward():
  """Autograd's backward ops pass through the mode: the saved relu output
  lives until its backward node ran, then the two gradients are made, so
  the peak is three (256, 256) f32 storages and two scalars (the loss and
  its seed gradient, 512 bytes each)."""
  x = torch.empty(256, 256, device="meta", requires_grad=True)
  w = torch.empty(256, 256, device="meta", requires_grad=True)
  with MemoryTracker({"x": x, "w": w}) as trk:
    g = torch.autograd.grad((x @ w).relu().sum(), [x, w])
    trk.finish(g)
  assert trk.output_bytes == 2 * 256 * 256 * 4
  assert trk.peak_bytes == 3 * 256 * 256 * 4 + 2 * 512
  np.testing.assert_equal(trk.alias_bytes, 0)


def test_tree_shardings_resolve_every_leaf():
  """``tree_shardings`` gives each leaf of a nested tree the spec of
  ``mesh_axes_for``; a None leaf of axes is replicated."""
  cfg = get_config("jamba-v0.1-52b")
  fake = FakeMesh(*MESHES["multi"])
  specs = shd.tree_shardings(cm.param_axes(cfg), fake, shd.TRAIN_RULES,
                             cm.param_shapes(cfg))
  shapes_ = dict(cm.leaves(cm.param_shapes(cfg)))
  axes = dict(cm.leaves(cm.param_axes(cfg)))
  for path, spec in cm.leaves(specs):
    assert spec == shd.mesh_axes_for(axes[path], fake, shd.TRAIN_RULES,
                                     shape=shapes_[path]), path
  assert shd.tree_shardings({"x": None}, fake, shd.TRAIN_RULES,
                            {"x": torch.empty(4, 6)}) == {"x": (None, None)}


def test_abstract_mesh_alone():
  """Any rank of any shape, with no world: its coordinates and indices
  are the row-major ones; ``all_gather`` and ``all_reduce`` give the real
  mesh's shapes on the operand's device and tally their operand bytes
  (all-reduce: an all-to-all of the operand padded to the line, and an
  all-gather of one piece); ``broadcast_object`` returns the object."""
  mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"), rank=300)
  assert mesh.coords == {"pod": 1, "data": 2, "model": 12}
  assert mesh.index(("pod", "data")) == 18 and mesh.index("model") == 12
  assert mesh.axis_size(("data", "model")) == 256
  assert mesh.broadcast_object({"a": 1}) == {"a": 1}
  x = torch.empty((3, 5, 7), device="meta")
  assert mesh.all_gather(x, "model", dim=1).shape == (3, 80, 7)
  assert mesh.all_gather(x, ("pod", "data"), dim=0,
                         tiled=False).shape == (32, 3, 5, 7)
  y = mesh.all_reduce(x, ("data", "model"), op="mean")
  assert y.shape == x.shape and y.device.type == "meta"
  padded = -(-105 // 256) * 256
  assert mesh.stats["all-gather"] == 2 * 105 * 4 + padded // 256 * 4
  assert mesh.stats["all-to-all"] == padded * 4
  assert mesh.stats["calls"] == 1 + 1 + 2 + 1
  with pytest.raises(ValueError):
    shd.AbstractMesh((2, 2), ("data", "model"), rank=4)
  assert shd.require_mesh(mesh) is mesh

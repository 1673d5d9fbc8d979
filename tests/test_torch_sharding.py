"""The port's rule tables and meshes (``repro_torch.dist.sharding``,
``launch.mesh``, ``dist.topology``'s meshes) and its sharded synopsis
attention (``serve.serve_step.sharded_synopsis_attention``, with
``shard_cache`` and the per-layer dispatch), against the JAX package.

* The rule tables, ``mesh_axes_for``'s two safety rails and the
  ``tp_size`` / ``dp_size`` helpers on fake meshes, as in
  ``tests/test_dist.py`` (no world needed).
* One spawned world of 8 gloo ranks (``dist.world.run_world``) on a (data
  2, model 4) mesh: ``sharded_synopsis_attention`` under ``SERVE_RULES``
  (the sequence over `model`, the batch over `data`) and ``LONG_RULES``
  (the sequence over `(data, model)`), on an f32 and an int8+kv arena, with
  the recent ring and the self KV, held to JAX's single-device
  ``synopsis_decode_attention`` on the global inputs within 4e-5 of
  max|ref|.  JAX's own sharded path equals that function (its
  ``tests/test_sharded_synopsis.py``).  The reference's dispatch: M not
  divisible by the shard count runs the single-device path on every rank,
  B not divisible by the data-parallel size keeps the batch whole.  Every
  rank of a batch group returns the same bits.
* The same world runs the SMOKE llama3-8b serve step (f32) through the
  per-layer dispatch on each rank's shard of a whole cache, under both
  tables: its logits and new KV against JAX's serve step on the global
  cache, within the single-device serve test's bound (rtol = atol =
  1e-4), and ``Mesh.all_reduce`` over one axis and both (sum and mean),
  equal bit for bit to the left fold of the line's operands in the order
  of the combined index.
* A second world of 8 ranks on the same mesh: exact decode on a cache
  whose sequence is cut (``sharded_exact_decode_attention``), under both
  tables, at llama3's SMOKE shapes and on a gemma2 local layer whose window
  crosses a shard boundary and leaves shards empty, against JAX's
  single-device ``exact_decode_attention`` within 4e-5 of max|ref|; the
  whole exact serve step (llama3 and gemma2 SMOKE, f32) on the shards
  against JAX's step and the port's one-rank step; and the same step on an
  ``AbstractMesh`` of the rank, whose collectives' shapes and tallies equal
  the real mesh's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs.registry import get_config as j_get_config
from repro.dist import sharding as jshd
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import synopsis_kv as jskv
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro.serve.serve_step import exact_decode_attention as j_exact
from repro.serve.serve_step import synopsis_decode_attention as j_synopsis
from repro_torch.dist import sharding as shd
from repro_torch.dist import topology, world
from repro_torch.launch import mesh as lmesh
from repro_torch.serve import serve_step as ss

TOL = 4e-5          # of max|ref|: the f32 floor of the port's parity tests
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 120.0


class FakeMesh:

  def __init__(self, **shape):
    self.shape = shape


# -- rule tables (no world) ------------------------------------------------------

def test_rule_tables_equal_jax():
  for name in ("DEFAULT_RULES", "TRAIN_RULES", "SERVE_RULES", "LONG_RULES"):
    assert getattr(shd, name) == getattr(jshd, name), name


def test_rules_divisibility_fallback():
  mesh = FakeMesh(data=16, model=16)
  spec = shd.mesh_axes_for(("embed", "heads", None), mesh, shd.rules_dict(),
                           shape=(576, 9, 64))
  assert spec == (None, None, None)       # 9 heads can't split 16 ways
  spec = shd.mesh_axes_for(("embed", "heads", None), mesh, shd.rules_dict(),
                           shape=(576, 32, 64))
  assert spec == (None, "model", None)


def test_rules_no_double_use():
  mesh = FakeMesh(data=4, model=4)
  # both dims want 'model': only the first gets it
  spec = shd.mesh_axes_for(("heads", "ff"), mesh, shd.rules_dict(),
                           shape=(16, 16))
  assert spec == ("model", None)


def test_long_rules_spread_kv_over_two_axes():
  mesh = FakeMesh(data=16, model=16)
  spec = shd.mesh_axes_for(
      ("layers", None, "batch", "kv_heads", "kv_seq", None), mesh,
      shd.LONG_RULES, shape=(32, 1, 1, 8, 524288, 128))
  assert spec[4] == ("data", "model")


@pytest.mark.parametrize("axes,shape", [
    (("batch", "kv_heads", "kv_seq", None), (4, 8, 4096, 128)),
    (("batch", "kv_heads", "kv_seq", None), (3, 8, 4100, 128)),
    (("embed", "ff"), (576, 1536)),
    (("batch", None, "vocab"), (6, 1, 32000)),
])
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "TRAIN_RULES",
                                   "SERVE_RULES", "LONG_RULES"])
@pytest.mark.parametrize("mesh", [dict(data=2, model=4),
                                  dict(pod=2, data=16, model=16)])
def test_mesh_axes_for_equals_jax(axes, shape, rules, mesh):
  got = shd.mesh_axes_for(axes, FakeMesh(**mesh), getattr(shd, rules),
                          shape=shape)
  want = jshd.mesh_axes_for(axes, FakeMesh(**mesh), getattr(jshd, rules),
                            shape=shape)
  assert got == tuple(want)


def test_context_and_sizes():
  mesh = FakeMesh(pod=2, data=4, model=8)
  assert shd.current_mesh() is None and shd.current_rules() is None
  assert shd.rules_dict() == shd.DEFAULT_RULES
  with shd.use_mesh(mesh, shd.SERVE_RULES):
    assert shd.current_mesh() is mesh
    assert shd.rules_dict() == shd.SERVE_RULES
    assert ss._seq_axes() == ("model",)
    with shd.manual_axes({"model"}):
      with shd.use_mesh(mesh, shd.LONG_RULES):
        assert ss._seq_axes() == ("data", "model")
  assert shd.current_mesh() is None
  assert (shd.tp_size(mesh), shd.dp_size(mesh)) == (8, 8)
  assert (shd.tp_size(None), shd.dp_size(None)) == (1, 1)
  x = torch.ones(3)
  assert shd.constrain(x, ("batch",)) is x


def test_meshes_need_a_world():
  """Without a world: no Mesh, the tiers' meshes are None (their stacked
  path), the production mesh raises with the reference's message, and a
  mesh that is not the port's is a TypeError."""
  assert world.world_size() == 1 and world.rank() == 0
  with pytest.raises(RuntimeError, match="torch.distributed"):
    shd.Mesh((2,), ("component",))
  assert topology.make_component_mesh(2) is None
  assert topology.make_fleet_mesh(2, 2) is None
  for multi, n in ((False, 256), (True, 512)):
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
      lmesh.make_production_mesh(multi_pod=multi)
  with pytest.raises(TypeError, match="Mesh"):
    shd.require_mesh(FakeMesh(model=2))
  assert world.backend_for("cpu", 8) == "gloo"


def test_absorb_on_a_shard_is_refused():
  """A rank's shard (its ``layout``) cannot absorb: the ring's new clusters
  would land on one shard and move the others' ranges (ROADMAP A.7d)."""
  from repro_torch.serve import synopsis_kv as skv
  cfg = ranks._f32("llama3-8b")
  lay = ss.shard_layout(FakeMesh(model=4), ("model",), 16, 2)
  with pytest.raises(NotImplementedError, match="A.7d"):
    skv.absorb_recent({"layout": lay}, cfg)


@pytest.mark.parametrize("seq,M,B,want", [
    (("model",), 16, 4, (("model",), 4, ("data",), 2)),
    (("model",), 10, 4, ((), 1, (), 1)),          # M % n != 0
    (("model",), 16, 3, (("model",), 4, (), 1)),  # B % dp != 0
    (("data", "model"), 16, 4, (("data", "model"), 8, (), 1)),
    (("data", "model"), 12, 4, ((), 1, (), 1)),
    ((), 16, 4, ((), 1, (), 1)),
    (("nope",), 16, 4, ((), 1, (), 1)),
])
def test_shard_layout_is_the_reference_dispatch(seq, M, B, want):
  lay = ss.shard_layout(FakeMesh(data=2, model=4), seq, M, B)
  assert (lay.seq_axes, lay.nshards, lay.dp_axes, lay.dp_n) == want
  assert (lay.m_total, lay.batch) == (M, B)


# -- the sharded attention on 8 ranks -------------------------------------------------

D, Hkv, G, C = 32, 2, 2, 32
H = Hkv * G
SM = float(1.0 / np.sqrt(D))

CASES = {
    # name: (rules, B, M, quant, cap, expected layout)
    "serve-f32": ("SERVE_RULES", 4, 16, None, None,
                  (("model",), ("data",))),
    "long-f32": ("LONG_RULES", 4, 16, None, None, (("data", "model"), ())),
    "serve-int8kv": ("SERVE_RULES", 4, 16, "int8+kv", None,
                     (("model",), ("data",))),
    "long-int8kv": ("LONG_RULES", 4, 16, "int8+kv", None,
                    (("data", "model"), ())),
    "serve-M10-whole": ("SERVE_RULES", 4, 10, None, None, ((), ())),
    "long-M12-whole": ("LONG_RULES", 4, 12, None, None, ((), ())),
    "serve-B3-batch-whole": ("SERVE_RULES", 3, 16, None, 30.0,
                             (("model",), ())),
}


def _case_inputs(seed, B, M, quant):
  S = M * C
  ks = jax.random.split(jax.random.PRNGKey(seed), 8)
  k = jax.random.normal(ks[1], (B, Hkv, S, D), jnp.float32)
  v = jax.random.normal(ks[2], (B, Hkv, S, D), jnp.float32)
  cache = {
      "recent_k": jax.random.normal(ks[3], (B, Hkv, 16, D), jnp.float32),
      "recent_v": jax.random.normal(ks[4], (B, Hkv, 16, D), jnp.float32),
      "recent_len": jnp.asarray([7, 3, 16, 0][:B], jnp.int32),
  }
  if quant is None:
    cache.update(k=k, v=v, counts=jnp.full((B, M), float(C)),
                 k_syn=k.reshape(B, Hkv, M, C, D).mean(3),
                 v_syn=v.reshape(B, Hkv, M, C, D).mean(3))
  else:
    perm = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cache.update(jref.synopsis_build_quant_ref(
        k, v, perm, cluster_size=C, qc=jquant.parse_qconfig(quant)))
  q = jax.random.normal(ks[0], (B, H, D), jnp.float32)
  kd = jax.random.normal(ks[5], (B, Hkv, 1, D), jnp.float32)
  vd = jax.random.normal(ks[6], (B, Hkv, 1, D), jnp.float32)
  return q, cache, (kd, vd)


def _step_inputs():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 128))
  _, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt, jnp.int32))
  jc = jskv.build(cache, jcfg, impl="xla")
  jc["recent_len"] = jc["recent_len"] + 3      # a partly filled ring
  tok = np.array([[5], [77]], np.int32)
  logits, st = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=2,
                                         impl="xla"))(jparams, jc,
                                                      jnp.asarray(tok))
  to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
  return ({"params": to_np(jparams), "cache": to_np(jc), "tok": tok,
           "i_max": 2},
          {"logits": np.asarray(logits), "k_delta": np.asarray(
              st["k_delta"])})


@pytest.fixture(scope="module")
def synopsis_run():
  cases, refs = [], {}
  for i, (name, (rules, B, M, quant, cap, _)) in enumerate(CASES.items()):
    q, cache, (kd, vd) = _case_inputs(i, B, M, quant)
    refs[name] = np.asarray(j_synopsis(
        q, cache, i_max=4, cluster_size=C, sm_scale=SM, cap=cap,
        self_kv=(kd, vd), impl="xla"))
    cases.append({"rules": rules, "q": np.asarray(q),
                  "cache": jax.tree.map(np.asarray, cache),
                  "self_kv": (np.asarray(kd), np.asarray(vd)), "i_max": 4,
                  "C": C, "sm": SM, "cap": cap})
  step, step_ref = _step_inputs()
  got = world.run_world(ranks.synopsis_world, 8, (cases, step),
                        timeout_s=JOIN_S)
  return got, refs, step_ref


def _assemble(per_rank, pick):
  """The global output from the ranks' rows; every rank that computed a
  row range returns the same bits."""
  by_rows = {}
  for r in per_rank:
    rows, out = pick(r)
    if rows in by_rows:
      assert torch.equal(by_rows[rows], out), rows
    by_rows[rows] = out
  parts = [by_rows[k] for k in sorted(by_rows, key=lambda k: k[0] or 0)]
  return torch.cat(parts, 0)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_attention_equals_jax(synopsis_run, name):
  got, refs, _ = synopsis_run
  i = list(CASES).index(name)
  rules, B, M, quant, _, (seq, dp) = CASES[name]
  for r in got:
    lay = r["cases"][i]["layout"]
    assert (lay["seq_axes"], lay["dp_axes"]) == (seq, dp), lay
    shapes = r["cases"][i]["shapes"]
    n = lay["nshards"]
    assert shapes["k_syn"][2] == M // n and shapes["counts"][1] == M // n
    assert shapes["k"][2] == M * C // n
    assert shapes["k"][0] == B // lay["dp_n"]
    if quant is not None:
      assert shapes["k_scale"] == shapes["k_syn_scale"] == \
          (B // lay["dp_n"], Hkv, M // n)
  out = _assemble(got, lambda r: (tuple(r["cases"][i]["rows"]),
                                  r["cases"][i]["out"])).numpy()
  want = refs[name]
  assert out.shape == want.shape
  err = np.abs(out - want).max()
  assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("rules", ["SERVE_RULES", "LONG_RULES"])
def test_serve_step_dispatch_equals_jax(synopsis_run, rules):
  got, _, ref = synopsis_run
  lay = got[0]["step"][rules]["layout"]
  assert lay["nshards"] == (4 if rules == "SERVE_RULES" else 8)
  for key in ("logits", "k_delta"):
    axis = 0 if key == "logits" else 2
    by_rows = {}
    for r in got:
      s = r["step"][rules]
      rows, x = tuple(s["rows"]), s[key]
      if rows in by_rows:
        assert torch.equal(by_rows[rows], x)
      by_rows[rows] = x
    out = torch.cat([by_rows[k] for k in sorted(by_rows,
                                                key=lambda k: k[0] or 0)],
                    axis).numpy()
    np.testing.assert_allclose(out, ref[key], **STEP_TOL)


def test_mesh_coordinates_and_collectives(synopsis_run):
  """Rank i sits at the row-major coordinates of i; each rank gathered the
  two small tables a layer and step (scores and packed partials)."""
  got = synopsis_run[0]
  for i, r in enumerate(got):
    assert r["coords"] == {"data": i // 4, "model": i % 4}
    assert r["stats"]["calls"] > 0 and r["stats"]["bytes"] > 0


@pytest.mark.parametrize("axes", ranks.ALL_REDUCE_AXES)
def test_mesh_all_reduce_sums_in_the_combined_index_order(synopsis_run,
                                                         axes):
  """``Mesh.all_reduce`` (all-to-all, a sum in the combined index's order,
  all-gather) gives each rank the left fold of its line's operands in that
  order, bit for bit, and the mean as that sum over the line's size."""
  got = synopsis_run[0]
  shape = {"data": 2, "model": 4}
  names = (axes,) if isinstance(axes, str) else axes
  for i, r in enumerate(got):
    coords = r["coords"]
    line = []
    for idx in np.ndindex(*(shape[a] for a in names)):
      c = dict(coords, **dict(zip(names, idx)))
      line.append(c["data"] * 4 + c["model"])
    want = ranks.all_reduce_operand(line[0])
    for j in line[1:]:
      want = want + ranks.all_reduce_operand(j)
    assert torch.equal(r["all_reduce"][(axes, "sum")], want), (i, axes)
    assert torch.equal(r["all_reduce"][(axes, "mean")], want / len(line))


# -- exact decode on a cache whose sequence is cut ----------------------------

EXACT_B = 4
EXACT_CASES = {
    # name: (rules, SMOKE arch, S, window): gemma2's window of 16 over 48
    # rows crosses from shard 2 into shard 3 of 4 (12 rows each, shards 0
    # and 1 empty), and spans shards 5-7 of 8 (6 rows each).
    "serve-llama3": ("SERVE_RULES", "llama3-8b", 128, None),
    "long-llama3": ("LONG_RULES", "llama3-8b", 128, None),
    "serve-gemma2-local": ("SERVE_RULES", "gemma2-2b", 48, 16),
    "long-gemma2-local": ("LONG_RULES", "gemma2-2b", 48, 16),
}
EXACT_STEP_ARCHS = ("llama3-8b", "gemma2-2b")


def _exact_inputs(seed, arch, S):
  cfg = j_get_config(arch, smoke=True)
  Hkv_, H_, D_ = cfg.n_kv_heads, cfg.n_heads, cfg.hd
  ks = jax.random.split(jax.random.PRNGKey(100 + seed), 5)
  k = jax.random.normal(ks[0], (EXACT_B, Hkv_, S, D_), jnp.float32)
  v = jax.random.normal(ks[1], (EXACT_B, Hkv_, S, D_), jnp.float32)
  q = jax.random.normal(ks[2], (EXACT_B, H_, D_), jnp.float32)
  kd = jax.random.normal(ks[3], (EXACT_B, Hkv_, 1, D_), jnp.float32)
  vd = jax.random.normal(ks[4], (EXACT_B, Hkv_, 1, D_), jnp.float32)
  return cfg, q, k, v, (kd, vd)


def _exact_step_inputs(arch):
  jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype=jnp.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 128))
  _, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt, jnp.int32))
  tok = np.array([[5], [77]], np.int32)
  logits, _ = jax.jit(j_make_serve_step(jcfg, mode="exact", impl="xla"))(
      jparams, cache, jnp.asarray(tok))
  to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
  return ({"params": to_np(jparams), "cache": to_np(cache), "tok": tok},
          np.asarray(logits))


@pytest.fixture(scope="module")
def exact_run():
  cases, refs = [], {}
  for i, (name, (rules, arch, S, window)) in enumerate(EXACT_CASES.items()):
    cfg, q, k, v, (kd, vd) = _exact_inputs(i, arch, S)
    sm = float(cfg.hd ** -0.5)
    refs[name] = np.asarray(j_exact(
        q, k, v, sm_scale=sm, cap=cfg.attn_softcap, self_kv=(kd, vd),
        window=window, impl="xla"))
    cases.append({"rules": rules, "q": np.asarray(q),
                  "cache": {"k": np.asarray(k), "v": np.asarray(v)},
                  "self_kv": (np.asarray(kd), np.asarray(vd)), "sm": sm,
                  "cap": cfg.attn_softcap, "window": window})
  steps, step_refs = {}, {}
  for arch in EXACT_STEP_ARCHS:
    steps[arch], step_refs[arch] = _exact_step_inputs(arch)
  got = world.run_world(ranks.exact_world, 8, (cases, steps),
                        timeout_s=JOIN_S)
  return got, refs, step_refs


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_sharded_exact_attention_equals_jax(exact_run, name):
  """Each rank's partial over its rows (of the global window), the self
  token on shard 0 only, merged in shard order: the global answer on every
  rank of a batch group, within 4e-5 of max|ref| of JAX's single-device
  exact attention; a local window leaves some shards with no row."""
  got, refs, _ = exact_run
  i = list(EXACT_CASES).index(name)
  rules, _, S, window = EXACT_CASES[name]
  n = 4 if rules == "SERVE_RULES" else 8
  empty = 0
  for r in got:
    c = r["cases"][i]
    assert c["layout"]["nshards"] == n and c["k_rows"] == S // n
    sid = (r["coords"]["model"] if n == 4
           else r["coords"]["data"] * 4 + r["coords"]["model"])
    empty += window is not None and (sid + 1) * S // n <= S - window
  if window is not None:
    assert empty > 0
    assert (S - window) % (S // n) != 0          # crosses a boundary
  out = _assemble(got, lambda r: (tuple(r["cases"][i]["rows"]),
                                  r["cases"][i]["out"])).numpy()
  want = refs[name]
  assert out.shape == want.shape
  err = np.abs(out - want).max()
  assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("rules", ["SERVE_RULES", "LONG_RULES"])
@pytest.mark.parametrize("arch", EXACT_STEP_ARCHS)
def test_sharded_exact_step_equals_one_rank(exact_run, arch, rules):
  """The exact serve step on each rank's shard of a whole exact cache: its
  logits against JAX's exact step on the global cache (the serve tests'
  bound) and the port's one-rank step (4e-5 of max|ref|)."""
  got, _, step_refs = exact_run
  assert got[0]["steps"][(arch, rules)]["layout"]["nshards"] == (
      4 if rules == "SERVE_RULES" else 8)
  out = _assemble(got, lambda r: (tuple(r["steps"][(arch, rules)]["rows"]),
                                  r["steps"][(arch, rules)]["logits"]))
  one = _assemble(got, lambda r: (tuple(r["steps"][(arch, rules)]["rows"]),
                                  r["steps"][(arch, rules)]["one"]))
  np.testing.assert_allclose(out.numpy(), step_refs[arch], **STEP_TOL)
  err = (out - one).abs().max().item()
  assert err <= TOL * one.abs().max().item(), err


def test_abstract_mesh_matches_the_mesh(exact_run):
  """An ``AbstractMesh`` of the same shape and rank gives the collectives'
  results the real mesh's shapes and tallies the same calls and operand
  bytes of each kind, through the sharded exact step and alone; every rank
  tallies the same."""
  got = exact_run[0]
  for r in got:
    for key, s in r["steps"].items():
      assert s["abstract_stats"] == s["stats"], key
      assert s["abstract_shapes"] == (tuple(s["logits"].shape),
                                      tuple(s["k_delta"].shape))
      assert s["stats"]["all-gather"] > 0
      assert s["stats"] == got[0]["steps"][key]["stats"]
    for axes in ranks.ALL_REDUCE_AXES:
      real, abstract = (r["collectives"][(axes, a)] for a in (False, True))
      assert real == abstract, axes
      assert real[3]["all-to-all"] > 0 and real[3]["all-gather"] > 0

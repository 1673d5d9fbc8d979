"""The port's quantized synopsis arena against the JAX package, on the CPU.

* ``kernels/quant.py`` against ``repro.kernels.quant``: int8 and fp8 codes
  bit-equal (ties of the int8 rounding included) and scales equal, per
  row and per C-row block; an all-zero block gives scale 0 and codes 0.
* The quantized build's plain version against the JAX reference
  (``impl="xla"``) and the Pallas kernel in interpret mode, for every
  spec: sorted-KV codes bit-equal; centroid codes bit-equal, or one step
  apart where the two f32 means (or the row's scale) differ in their last
  bits, which the test counts; scales within 1e-6.
* Quantized stage 1 and stage 2 against the same two, with ``-1`` padded
  and all-padded selections and the ragged M = 65: within 2e-5 (the bound
  the JAX suite holds its own quantized kernels to).
* The control arm: all-None scales are the unquantized path, bit for bit;
  and the int8+kv arm at full budget deviates from the unquantized one by
  rounding noise only (< 7% relative L2, the JAX package's bound).

The serve step, the loop and the launcher are in
``test_torch_quant_serve.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jqt
from repro.kernels.block_gather_attention import (
    block_gather_attention as j_block_gather)
from repro.kernels.fused_synopsis import (
    fused_synopsis_score_attention as j_fused_synopsis)
from repro_torch import bridge
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import quant as qt
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build

TOL = dict(rtol=1e-5, atol=2e-5)
SPECS = ("int8", "fp8", "int8+kv", "fp8+kv")
KINDS = ("int8", "fp8")


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return bridge.arena_from_numpy({"x": a}, "cpu")["x"]


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _normal(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


def _steps(x):
  """Codes as ordered integers: int8 as they are; fp8-e4m3 by its sign and
  magnitude bits, so that neighbouring values differ by 1."""
  if isinstance(x, torch.Tensor):
    if x.dtype == torch.int8:
      return x.numpy().astype(np.int64)
    bits = x.view(torch.uint8).numpy().astype(np.int64)
  else:
    x = np.asarray(x)
    if x.dtype == np.int8:
      return x.astype(np.int64)
    bits = x.view(np.uint8).astype(np.int64)
  mag = bits & 0x7F
  return np.where(bits >> 7, -mag, mag)


# ---------------------------------------------------------------------------
# quant.py
# ---------------------------------------------------------------------------

def _rows_with_ties(rng, kind):
  """Random rows, plus rows whose scale is exactly 1 (amax = qmax) and
  whose values are halves, so that int8's round-half-to-even is tested
  on ties, and rows past fp8's range after scaling."""
  x = _normal(rng, 2, 3, 32, 16) * 5.0
  qm = jqt.qmax(kind)
  halves = rng.integers(-254, 255, (2, 3, 32, 16)) / 2.0
  x[:, :, :8] = halves[:, :, :8].astype(np.float32)
  x[:, :, :8, 0] = qm
  return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [1, 16])
def test_quantize_rows_matches_jax(kind, block):
  x = _rows_with_ties(np.random.default_rng(0), kind)
  q, s = qt.quantize_rows(torch.from_numpy(x), kind, block=block)
  jq, js = jqt.quantize_rows(jnp.asarray(x), kind, block=block)
  assert q.dtype == qt.qdtype(kind) and tuple(q.shape) == x.shape
  assert tuple(s.shape) == x.shape[:-2] + (x.shape[-2] // block,)
  np.testing.assert_array_equal(_steps(q), _steps(jq))
  np.testing.assert_array_equal(s.numpy(), np.asarray(js))
  np.testing.assert_array_equal(
      qt.dequantize_rows(q, s, block=block).numpy(),
      np.asarray(jqt.dequantize_rows(jq, js, block=block)))


@pytest.mark.parametrize("kind", KINDS)
def test_all_zero_block_gives_zero_scale_and_codes(kind):
  x = torch.zeros((2, 4, 16))
  x[1, 2:] = 3.0
  q, s = qt.quantize_rows(x, kind, block=2)
  assert not s[0].any() and not s[1, 0].any() and s[1, 1] > 0
  assert not q[0].float().any() and not q[1, :2].float().any()
  assert not qt.dequantize_rows(q, s, block=2)[0].any()


def test_parse_qconfig_specs():
  assert qt.parse_qconfig(None) == qt.parse_qconfig("none")
  assert not qt.parse_qconfig("none").enabled
  for spec in SPECS:
    qc = qt.parse_qconfig(spec)
    want = jqt.parse_qconfig(spec)
    assert (qc.kind, qc.sorted_kv, qc.spec) == (want.kind, want.sorted_kv,
                                                spec)
    assert qt.parse_qconfig(qc) is qc
  assert set(qt.QSPECS) == set(jqt.QSPECS)
  assert qt.SCALE_LEAVES == jqt.SCALE_LEAVES
  with pytest.raises(ValueError, match="quant"):
    qt.parse_qconfig("int4")


def test_bridge_carries_fp8_codes():
  codes = np.asarray(jnp.asarray([[1.5, -2.25, 0.1, 448.0]],
                                 jnp.float8_e4m3fn))
  got = _t(codes)
  assert got.dtype == torch.float8_e4m3fn
  np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                codes.view(np.uint8))


# ---------------------------------------------------------------------------
# segment_build, quantized
# ---------------------------------------------------------------------------

def _build_inputs(perm_kind, N=2, Hkv=2, S=64, D=16, seed=1):
  rng = np.random.default_rng(seed)
  k, v = _normal(rng, N, Hkv, S, D) * 3.0, _normal(rng, N, Hkv, S, D)
  if perm_kind == "identity":            # absorb of the recent ring
    perm = np.broadcast_to(np.arange(S, dtype=np.int32), (N, S)).copy()
  else:
    perm = np.stack([rng.permutation(S) for _ in range(N)]).astype(np.int32)
  return k, v, perm


def _means(x, perm, C, order):
  """The f32 centroid means each side takes: torch's reduction or the
  Pallas kernel's sequential sum times 1/C."""
  N, Hkv, S, D = x.shape
  srt = np.take_along_axis(x, perm[:, None, :, None], axis=2)
  blocks = srt.reshape(N, Hkv, S // C, C, D)
  if order == "torch":
    return torch.from_numpy(blocks).mean(3).numpy()
  if order == "xla":
    return np.asarray(jnp.asarray(blocks).mean(3))
  acc = np.zeros(blocks[:, :, :, 0].shape, np.float32)
  for c in range(C):
    acc = acc + blocks[:, :, :, c]
  return acc * np.float32(1.0 / C)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("perm_kind", ["clustered", "identity"])
def test_quant_build_matches_jax(spec, impl, perm_kind):
  C = 16
  k, v, perm = _build_inputs(perm_kind)
  want = jops.synopsis_build(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(perm), cluster_size=C, impl=impl,
                             qconfig=spec)
  got = segment_build(_t(k), _t(v), _t(perm), cluster_size=C, quant=spec)
  assert set(got) == set(want)
  qc = qt.parse_qconfig(spec)
  for name in want:
    assert tuple(got[name].shape) == want[name].shape, name
  # The sorted cache: codes (or the permuted rows) bit-equal.
  for name in ("k", "v"):
    assert got[name].dtype == (qt.qdtype(qc.kind) if qc.sorted_kv
                               else torch.float32)
    np.testing.assert_array_equal(_steps(got[name]) if qc.sorted_kv
                                  else got[name].numpy(),
                                  _steps(want[name]) if qc.sorted_kv
                                  else np.asarray(want[name]))
  for name in qt.SCALE_LEAVES:
    if name in want:
      _close(got[name], want[name], dict(rtol=0, atol=1e-6))
  np.testing.assert_array_equal(got["counts"].numpy(),
                                np.asarray(want["counts"]))
  # Centroids: equal codes, or one step apart where the f32 means (or the
  # row's scale, which the row's largest mean sets) differ.
  moved = 0
  for name, x in (("k_syn", k), ("v_syn", v)):
    a, b = _steps(got[name]), _steps(want[name])
    differ = a != b
    assert np.abs(a - b).max() <= 1, name
    mean_a = _means(x, perm, C, "torch")
    mean_b = _means(x, perm, C, "xla" if impl == "xla" else "sequential")
    scale_moved = np.asarray(got[name + "_scale"]) != np.asarray(
        want[name + "_scale"])
    explained = (mean_a != mean_b) | scale_moved[..., None]
    assert not (differ & ~explained).any(), name
    moved += int(differ.sum())
  print(f"{spec} {impl} {perm_kind}: {moved} centroid codes one step apart "
        "(f32 means summed in another order)")


def test_cpu_tensors_run_the_plain_quantized_versions_without_launching():
  before = _build.launch_counts()
  k, v, perm = _build_inputs("clustered")
  arena = segment_build(_t(k), _t(v), _t(perm), cluster_size=16,
                        quant="fp8+kv")
  want = ref.synopsis_build_quant_ref(_t(k), _t(v), _t(perm),
                                      cluster_size=16,
                                      qc=qt.parse_qconfig("fp8+kv"))
  for name in want:
    np.testing.assert_array_equal(_steps(arena[name]) if arena[name].dtype
                                  in qt.QDTYPES else arena[name].numpy(),
                                  _steps(want[name]) if want[name].dtype
                                  in qt.QDTYPES else want[name].numpy())
  assert _build.launch_counts() == before


# ---------------------------------------------------------------------------
# Stage 1 and stage 2, quantized
# ---------------------------------------------------------------------------

def _arena(spec, M, B=2, Hkv=2, G=2, D=16, C=16, seed=3):
  """A quantized arena from the JAX reference build (numpy leaves), with
  non-uniform counts, and a query."""
  rng = np.random.default_rng(seed)
  S = M * C
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  perm = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
  arena = jops.synopsis_build(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(perm), cluster_size=C, impl="xla",
                              qconfig=spec)
  arena = {n: np.asarray(a) for n, a in arena.items()}
  arena["counts"] = arena["counts"] + np.arange(M, dtype=np.float32)[None]
  q = _normal(rng, B, Hkv * G, D) * 2.0
  return q, arena, C


def _scales(arena, names):
  return tuple(arena[n] for n in names) if names[0] in arena else None


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("M", [8, 65])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_quant_stage1_matches_pallas(spec, M, cap):
  q, arena, _ = _arena(spec, M)
  cbias = np.log(arena["counts"])
  D = q.shape[-1]
  kw = dict(sm_scale=D ** -0.5, cap=cap)
  ks, vs = arena["k_syn_scale"], arena["v_syn_scale"]
  scores_w, part_w = j_fused_synopsis(
      jnp.asarray(q), jnp.asarray(arena["k_syn"]),
      jnp.asarray(arena["v_syn"]), jnp.asarray(cbias), block_m=4,
      k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True, **kw)
  scores_g, part_g = fused_synopsis_score_attention(
      _t(q), _t(arena["k_syn"]), _t(arena["v_syn"]), _t(cbias),
      k_scale=_t(ks), v_scale=_t(vs), **kw)
  _close(scores_g, scores_w)
  for g, w in zip(part_g, part_w):
    _close(g, w)


def _selection(case, B, Hkv, M, rng):
  if case == "all_padded":                 # budget 0
    return np.full((B, Hkv, 1), -1, np.int32)
  sel = np.stack([[rng.permutation(M)[:5] for _ in range(Hkv)]
                  for _ in range(B)]).astype(np.int32)
  sel[0, 0, 1] = -1
  sel[1, :, 3:] = -1
  return sel


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("M", [8, 65])
@pytest.mark.parametrize("case", ["padded", "all_padded"])
def test_quant_stage2_matches_pallas(spec, M, case):
  """The kernel call as ``refine_stage2`` makes it: decrement rows
  dequantized in f32, extras, and the per-block scales under ``+kv``."""
  q, arena, C = _arena(spec, M)
  B, Hkv, _, D = arena["k"].shape
  rng = np.random.default_rng(5)
  sel = _selection(case, B, Hkv, M, rng)
  safe = np.maximum(sel, 0)
  deq = {n: np.take_along_axis(jqt.dequantize_rows(
      jnp.asarray(arena[n]), jnp.asarray(arena[n + "_scale"])), safe[..., None],
      axis=2) for n in ("k_syn", "v_syn")}
  ek, ev = _normal(rng, B, Hkv, 17, D), _normal(rng, B, Hkv, 17, D)
  eb = np.zeros((B, 17), np.float32)
  eb[:, 9:16] = -1e30
  kw = dict(k_sel=np.asarray(deq["k_syn"]), v_sel=np.asarray(deq["v_syn"]),
            sel_bias=np.take_along_axis(
                np.broadcast_to(np.log(arena["counts"])[:, None],
                                (B, Hkv, M)), safe, axis=2),
            extras_k=ek, extras_v=ev, extras_bias=eb)
  if "k_scale" in arena:
    kw.update(kv_k_scale=arena["k_scale"], kv_v_scale=arena["v_scale"])
  opts = dict(cluster_size=C, sm_scale=D ** -0.5, cap=30.0)
  want = j_block_gather(jnp.asarray(q), jnp.asarray(arena["k"]),
                        jnp.asarray(arena["v"]), jnp.asarray(sel),
                        interpret=True, **opts,
                        **{n: jnp.asarray(a) for n, a in kw.items()})
  got = block_gather_attention(_t(q), _t(arena["k"]), _t(arena["v"]),
                               _t(sel), **opts,
                               **{n: _t(np.asarray(a)) for n, a in kw.items()})
  for g, w in zip(got, want):
    assert np.isfinite(g.numpy()).all()
    _close(g, w)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("i_max", [0, 3, 65])
def test_quant_synopsis_cache_attention_matches_jax(spec, impl, i_max):
  """Stage 1 -> top-k -> stage 2 (dequantized decrement, ring, self, the
  per-block scales) -> merge, at M = 65 with a partly filled ring."""
  q, arena, C = _arena(spec, 65, seed=4)
  B, Hkv, _, D = arena["k"].shape
  rng = np.random.default_rng(6)
  rk, rv = _normal(rng, B, Hkv, 16, D), _normal(rng, B, Hkv, 16, D)
  rlen = np.full((B,), 5, np.int32)
  sk, sv = _normal(rng, B, Hkv, 1, D), _normal(rng, B, Hkv, 1, D)
  args = (q, arena["k"], arena["v"], arena["k_syn"], arena["v_syn"],
          arena["counts"], rk, rv, rlen, sk, sv,
          *(arena.get(n) for n in qt.SCALE_LEAVES))
  kw = dict(i_max=i_max, cluster_size=C, sm_scale=D ** -0.5)
  want = jops.synopsis_cache_attention(
      *(None if a is None else jnp.asarray(a) for a in args), **kw,
      impl=impl)
  got = ops.synopsis_cache_attention(
      *(None if a is None else _t(a) for a in args), **kw)
  _close(got, want)


# ---------------------------------------------------------------------------
# The control arm and the full-budget deviation
# ---------------------------------------------------------------------------

def _toy(S=512, B=2, Hkv=2, G=2, D=64, seed=7):
  """The toy of the JAX package's own bound (tests/test_quant.py), drawn
  with numpy."""
  rng = np.random.default_rng(seed)
  q = torch.from_numpy(_normal(rng, B, Hkv * G, D))
  k = torch.from_numpy(_normal(rng, B, Hkv, S, D))
  v = torch.from_numpy(_normal(rng, B, Hkv, S, D))
  perm = torch.arange(S, dtype=torch.int32).expand(B, S)
  return q, k, v, perm


def test_all_none_scales_are_the_unquantized_path():
  q, k, v, perm = _toy(S=256)
  C, M = 32, 8
  sm = 64 ** -0.5
  k_s, v_s, k_syn, v_syn, counts = ops.synopsis_build(k, v, perm,
                                                      cluster_size=C)
  for i_max in (0, 3, M):
    plain = ops.synopsis_attention_fused(q, k_s, v_s, k_syn, v_syn, counts,
                                         i_max=max(i_max, 1), sm_scale=sm)
    none = ops.synopsis_attention_fused(q, k_s, v_s, k_syn, v_syn, counts,
                                        None, None, None, None,
                                        i_max=max(i_max, 1), sm_scale=sm)
    assert torch.equal(plain, none)
    kw = dict(i_max=i_max, cluster_size=C, sm_scale=sm)
    plain = ops.synopsis_cache_attention(q, k_s, v_s, k_syn, v_syn, counts,
                                         **kw)
    none = ops.synopsis_cache_attention(
        q, k_s, v_s, k_syn, v_syn, counts, None, None, None, None, None,
        None, None, None, None, **kw)
    assert torch.equal(plain, none)
  assert ops.synopsis_build(k, v, perm, cluster_size=C,
                            qconfig="none")[2].equal(k_syn)


@pytest.mark.parametrize("spec", SPECS)
def test_full_budget_quant_deviation_is_rounding_noise(spec):
  q, k, v, perm = _toy()
  C, M = 32, 512 // 32
  sm = 64 ** -0.5
  k_s, v_s, k_syn, v_syn, counts = ops.synopsis_build(k, v, perm,
                                                      cluster_size=C)
  arena = ops.synopsis_build(k, v, perm, cluster_size=C, qconfig=spec)
  o_f = ops.synopsis_attention_fused(q, k_s, v_s, k_syn, v_syn, counts,
                                     i_max=M, sm_scale=sm)
  o_q = ops.synopsis_attention_fused(
      q, arena["k"], arena["v"], arena["k_syn"], arena["v_syn"],
      arena["counts"], *(arena.get(n) for n in qt.SCALE_LEAVES), i_max=M,
      sm_scale=sm)
  dev = float((o_q - o_f).norm() / o_f.norm())
  assert dev < 0.07, dev
  if not qt.parse_qconfig(spec).sorted_kv:
    # Only the cancelled stage-1 terms are quantized: at i_max = M the
    # output is exact attention up to f32 rounding.
    assert dev < 1e-4, dev

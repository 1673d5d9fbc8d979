"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` need the card and skip where there is none; run them
there with ``python -m pytest -q tests/test_torch_card.py`` (this file
imports no JAX, so it runs where only PyTorch is installed).  The kernels
are built from ``src/repro_torch/kernels/csrc`` at their first launch.

Tolerances: in f32 the kernel and the plain version differ only in the
order of their sums (1e-4).  With bf16 inputs and f32 outputs the same
holds (1e-3).  Where the output is bf16, both round an f32 result that
differs in its last bits: one bf16 ulp, at most 2^-7 of the value, plus
1e-4 for outputs near zero.  A whole absolute ulp at |x| ~ 1 would let a
small late-row output lose part of a KV tile unseen.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import quant as qt
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build
from repro_torch.kernels.synopsis_score import synopsis_score
from repro_torch.launch import parity

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-3, atol=1e-3)}
BF16_OUT_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
DTYPES = [torch.float32, torch.bfloat16]
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel runs only on the card")
  return torch.device("cuda")


def _rand(g, *shape):
  return torch.randn(shape, generator=g)


def _close(got, want, tol):
  torch.testing.assert_close(got.float().cpu(), want.float().cpu(), **tol)


def _prefill_inputs(shape, seed=0):
  B, S, Hkv, G, D = shape
  g = torch.Generator().manual_seed(seed)
  return _rand(g, B, S, Hkv * G, D), _rand(g, B, S, Hkv, D), \
      _rand(g, B, S, Hkv, D)


def _gather_inputs(case, S, D=128, seed=3, E=144, C=16, I=3, G=4, Hkv=2):
  """Stage-2 inputs shaped as the serve step builds them: centroids are
  cluster means, the decrement bias is log(count), extras are a 128-row
  ring (100 valid) plus self-KV: E = 129 as the port builds them, or
  padded to 144 with masked rows as the JAX package does.  Cases: "plain"
  (neither epilogue), "dec_extras", "padded" (some -1 ids), "all_padded"
  (one -1 id, extras only), "all_padded_no_extras" (three -1 ids, no
  extras: every part is padded and all of them survive the merge),
  "equal_keys" (the first selected cluster's C keys are equal, so its
  rows and its centroid term cancel: its part's l is ~0)."""
  B = 2
  M = S // C
  g = torch.Generator().manual_seed(seed)
  q = _rand(g, B, Hkv * G, D)
  k, v = _rand(g, B, Hkv, S, D), _rand(g, B, Hkv, S, D)
  if case == "all_padded":
    sel = torch.full((B, Hkv, 1), -1, dtype=torch.int32)
  elif case == "all_padded_no_extras":
    sel = torch.full((B, Hkv, 3), -1, dtype=torch.int32)
  else:
    sel = torch.stack([torch.stack([torch.randperm(M, generator=g)[:I]
                                    for _ in range(Hkv)]) for _ in range(B)])
    sel = sel.to(torch.int32)
    if case == "padded":
      sel[0, 0, min(1, I - 1)] = -1
      sel[1, :, I - 1] = -1
    if case == "equal_keys":
      for b in range(B):
        for h in range(Hkv):
          c = int(sel[b, h, 0])
          k[b, h, c * C:(c + 1) * C] = k[b, h, c * C]
  kw = {}
  if case != "plain":
    k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
    v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
    safe = sel.long().clamp_min(0)[..., None].expand(-1, -1, -1, D)
    kw["k_sel"] = torch.gather(k_syn, 2, safe)
    kw["v_sel"] = torch.gather(v_syn, 2, safe)
    kw["sel_bias"] = torch.full(sel.shape, float(np.log(C)))
  if case not in ("plain", "all_padded_no_extras"):
    ek, ev = _rand(g, B, Hkv, 144, D), _rand(g, B, Hkv, 144, D)
    ek[:, :, 129:] = 0.0
    ev[:, :, 129:] = 0.0
    eb = torch.zeros((B, 144))
    eb[:, 100:128] = NEG_INF
    eb[:, 129:] = NEG_INF
    kw.update(extras_k=ek[:, :, :E].contiguous(),
              extras_v=ev[:, :, :E].contiguous(),
              extras_bias=eb[:, :E].contiguous())
  return q, k, v, sel, C, kw


def _to(dev, dtype, *tensors):
  return [t.to(device=dev, dtype=dtype) for t in tensors]


def test_ctypes_signatures_match_the_c_entry_points():
  """Every extern "C" launcher in csrc/ has the argtypes _build declares:
  a pointer passed as c_int would be cut to 32 bits."""
  import ctypes
  import re
  kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
           ctypes.c_float: "float"}
  found = {}
  for path in _build.CSRC.glob("*.cu"):
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   path.read_text()):
      found[name] = ["ptr" if "*" in p else p.split()[-2]
                     for p in params.split(",")]
  assert found.keys() == _build.SIGNATURES.keys()
  for name, argtypes in _build.SIGNATURES.items():
    assert [kinds[t] for t in argtypes] == found[name], name
  # The split decode kernels take their outputs, then the scratch of their
  # chunk partials (o, m, l of every part) and the counters of their
  # last-block merge from the wrapper (stage 1 also its scores).
  for name, n_in in (("flash_decode_launch", 4), ("block_gather_launch", 13),
                     ("fused_synopsis_launch", 7)):
    assert found[name][:n_in + 7] == ["ptr"] * (n_in + 7), name
    assert found[name][n_in + 7] == "int", name


def test_cpu_tensors_run_the_plain_versions_without_launching():
  before = _build.launch_counts()
  q, k, v = _prefill_inputs((1, 40, 2, 2, 16))
  torch.testing.assert_close(flash_prefill(q, k, v, sm_scale=0.25),
                             ref.flash_prefill_ref(q, k, v, sm_scale=0.25))
  q, k, v, sel, C, kw = _gather_inputs("padded", 64, D=16)
  got = block_gather_attention(q, k, v, sel, cluster_size=C, **kw)
  want = ref.fused_gather_attention_ref(q, k, v, sel, cluster_size=C, **kw)
  for a, b in zip(got, want):
    torch.testing.assert_close(a, b)
  k_syn = k.reshape(2, 2, 4, 16, 16).mean(3)
  bias = torch.randn((2, 2, 64), generator=torch.Generator().manual_seed(1))
  for a, b in zip(flash_decode(q, k, v, bias, sm_scale=0.25, cap=30.0),
                  ref.flash_decode_ref(q, k, v, bias, sm_scale=0.25,
                                       cap=30.0)):
    torch.testing.assert_close(a, b)
  torch.testing.assert_close(synopsis_score(q, k_syn, sm_scale=0.25),
                             ref.synopsis_score_ref(q, k_syn, sm_scale=0.25))
  assert _build.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,window,cap", [
    ((1, 128, 1, 1, 64), None, None),
    ((2, 300, 2, 4, 128), None, None),      # ragged last query tile
    ((2, 192, 2, 8, 32), 40, 30.0),
    ((1, 100, 2, 2, 16), None, 30.0),
    # The edges of the bf16 (wgmma) kernel's tiles: 128 query rows (128 /
    # G positions) and 128 keys.  (B, S, Hkv, G, D), window, cap.
    ((1, 1000, 2, 4, 128), None, None),     # many KV tiles, ragged to both
    ((2, 2100, 1, 8, 64), None, None),
    ((1, 2100, 2, 3, 128), None, None),     # G not a power of two
    ((2, 40, 2, 4, 128), None, None),       # S below one tile
    ((1, 5, 1, 1, 16), None, None),
    ((1, 520, 2, 1, 16), None, None),       # G = 1: 128 positions a tile
    ((1, 520, 2, 2, 32), None, None),
    ((1, 520, 2, 4, 64), None, None),
    ((1, 520, 1, 8, 128), None, None),
    ((1, 700, 2, 5, 64), 300, None),        # window edge inside a tile
    ((2, 600, 2, 4, 128), 200, 30.0),
    ((1, 300, 1, 8, 32), 57, 20.0),
    ((1, 1000, 2, 2, 128), 1, None),        # window 1: the diagonal only
    # D = 256 (gemma2-2b; the bf16 kernel's tiles of 64 keys):
    ((2, 520, 2, 2, 256), None, None),      # ragged S, several key tiles
    ((1, 40, 1, 2, 256), None, None),       # S below one tile
    ((1, 700, 2, 2, 256), 300, None),       # window edge inside a tile
    ((2, 600, 2, 2, 256), 200, 50.0),       # cap 50 with window
    ((1, 300, 1, 8, 256), 57, 50.0),        # G = 8
    ((1, 64, 1, 2, 256), None, 50.0),       # one whole tile, G = 2
    # smollm-135m's heads (G = 3, D = 64): 42 positions a tile, rows 126
    # and 127 of each tile empty; ragged S.
    ((2, 2100, 3, 3, 64), None, None),
    # whisper-medium's heads (16 of 64, G = 1): 128 positions a tile.
    ((1, 1024, 16, 1, 64), None, None),
    # arctic-480b's G = 7 (18 positions a tile, 126 rows), command-r-plus's
    # G = 12 (10 positions, 120 rows: the Q box 10 x 12 heads) and the
    # largest group built, G = 16 (8 positions); ragged S, with window
    # and cap.
    ((1, 700, 2, 7, 128), None, None),
    ((2, 1000, 2, 12, 128), None, None),
    ((1, 300, 1, 12, 64), 57, 30.0),
    ((1, 520, 1, 16, 128), None, None),
    ((1, 300, 2, 16, 32), 40, 20.0),
    # deepseek-v2's MLA prefill: D = qk_nope + qk_rope = 192 (three
    # 128-byte atoms a row, 64-key tiles, wgmma n192), G = 1 (128
    # positions a tile); and its SMOKE width 48 (f32 only on the card).
    ((1, 700, 4, 1, 192), None, None),      # ragged S, several key tiles
    ((2, 300, 2, 1, 192), None, None),
    ((1, 40, 2, 1, 192), None, None),       # S below one tile
    ((1, 520, 1, 2, 192), 100, 30.0),
])
def test_card_flash_prefill(cuda, dtype, shape, window, cap):
  q, k, v = _to(cuda, dtype, *_prefill_inputs(shape))
  kw = dict(sm_scale=shape[-1] ** -0.5, window=window, cap=cap)
  n0 = _build.LAUNCHES["flash_prefill"]
  got = flash_prefill(q, k, v, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES["flash_prefill"] == n0 + 1
  assert got.dtype == dtype and got.shape == q.shape
  _close(got, ref.flash_prefill_ref(q, k, v, **kw),
         TOL[dtype] if dtype == torch.float32 else BF16_OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 128, 256])
def test_card_flash_prefill_bf16_cancelling_rows(cuda, D):
  """V rows of alternating sign (+1, -1, ...) and logits spread ~1: each
  early output is a difference of nearly equal probabilities, near zero.
  P rounded to one bf16 misses such an output by up to 2^-9 |v| (~2e-3);
  the kernel's P = P_hi + P_lo keeps it within 1e-4 + 2^-7 |x|."""
  B, S, Hkv, G = 1, 300, 2, 4
  g = torch.Generator().manual_seed(11)
  q = _rand(g, B, S, Hkv * G, D)
  k = _rand(g, B, S, Hkv, D)
  sign = (-1.0) ** torch.arange(S, dtype=torch.float32)
  v = sign[None, :, None, None].expand(B, S, Hkv, D).contiguous()
  q, k, v = _to(cuda, torch.bfloat16, q, k, v)
  kw = dict(sm_scale=D ** -0.5)
  want = ref.flash_prefill_ref(q, k, v, **kw)
  assert float(want[:, :8].float().abs().min()) < 0.1
  _close(flash_prefill(q, k, v, **kw), want, BF16_OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 1, _build.GMAX + 1, 64),
                                   (1, 64, 1, 2, 40)])
def test_card_flash_prefill_bf16_refuses_unbuilt_shapes(cuda, shape):
  """G > GMAX and head dims outside WGMMA_HEAD_DIMS are not built for bf16:
  the wrapper raises instead of running the CUDA-core kernel; f32 takes
  them."""
  q, k, v = _to(cuda, torch.bfloat16, *_prefill_inputs(shape))
  n0 = _build.LAUNCHES["flash_prefill"]
  with pytest.raises(ValueError, match="wgmma"):
    flash_prefill(q, k, v)
  assert _build.LAUNCHES["flash_prefill"] == n0
  q, k, v = _to(cuda, torch.float32, q, k, v)
  _close(flash_prefill(q, k, v), ref.flash_prefill_ref(q, k, v),
         TOL[torch.float32])


# (C, D) of the build cases: the loop's (128, 128), clusters shorter than
# one staged piece, and rows whose f32 clusters come in several pieces.
BUILD_SHAPES = [(128, 128), (16, 64), (48, 64), (16, 256), (48, 256)]


def _build_rows(C):
  """Cache rows of a build case: two clusters of 128, else six."""
  return 256 if C == 128 else 6 * C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("perm_kind", ["clustered", "identity"])
@pytest.mark.parametrize("C,D", BUILD_SHAPES)
def test_card_segment_build(cuda, dtype, perm_kind, C, D):
  N, Hkv, S = 3, 2, _build_rows(C)
  g = torch.Generator().manual_seed(7)
  k, v = _to(cuda, dtype, _rand(g, N, Hkv, S, D), _rand(g, N, Hkv, S, D))
  if perm_kind == "identity":
    perm = torch.arange(S, dtype=torch.int32).expand(N, S)
  else:
    perm = torch.stack([torch.randperm(S, generator=g) for _ in range(N)])
  perm = perm.to(cuda)
  got = segment_build(k, v, perm, cluster_size=C)
  want = ref.synopsis_build_ref(k, v, perm, cluster_size=C)
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.shape == b.shape
    _close(a, b, TOL[dtype] if a.dtype == torch.float32 else BF16_OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [64, 65, 300, 1024, 1025])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_fused_synopsis(cuda, dtype, M, cap):
  """64 / 65 are one chunk; 300, 1024 and 1025 split and merge."""
  B, Hkv, G, D = 2, 8, 4, 128
  g = torch.Generator().manual_seed(8)
  q, k_syn, v_syn = _to(cuda, dtype, _rand(g, B, Hkv * G, D),
                        _rand(g, B, Hkv, M, D), _rand(g, B, Hkv, M, D))
  cbias = torch.log(torch.randint(1, 129, (B, M), generator=g).float())
  cbias = cbias.to(cuda)
  kw = dict(sm_scale=D ** -0.5, cap=cap)
  got = fused_synopsis_score_attention(q, k_syn, v_syn, cbias, **kw)
  want = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn, cbias, **kw)
  _close(got[0], want[0], TOL[dtype])
  for a, b in zip(got[1], want[1]):
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, _build.GMAX])
def test_card_fused_synopsis_head_dims(cuda, dtype, kind, D, G):
  """Every head dim stage 1 is built for, at a group of 1 and of GMAX,
  on tables of every storage type, at an M that splits."""
  B, Hkv, M = 2, 2, 300
  g = torch.Generator().manual_seed(D + G)
  q = _rand(g, B, Hkv * G, D).to(device=cuda, dtype=dtype)
  if kind == "none":
    k_syn, v_syn = _to(cuda, dtype, _rand(g, B, Hkv, M, D),
                       _rand(g, B, Hkv, M, D))
    scales = {}
  else:
    k_syn, v_syn, ks, vs = (t.to(cuda) for t in _quant_tables(
        g, kind, B, Hkv, M, D))
    scales = dict(k_scale=ks, v_scale=vs)
  cbias = torch.log(torch.randint(1, 129, (B, M), generator=g).float())
  kw = dict(sm_scale=D ** -0.5, cap=30.0, **scales)
  key = _build.branch("fused_synopsis_score_attention", kind)
  n0 = _build.LAUNCHES[key]
  got = fused_synopsis_score_attention(q, k_syn, v_syn, cbias.to(cuda), **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn,
                                                cbias.to(cuda), **kw)
  _close(got[0], want[0], TOL[dtype])
  for a, b in zip(got[1], want[1]):
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("D,G", [(40, 4), (128, _build.GMAX + 1)])
def test_card_fused_synopsis_refuses_unbuilt_shapes(cuda, D, G):
  """No fallback: a head dim or group the kernel is not built for raises
  and launches nothing."""
  g = torch.Generator().manual_seed(19)
  q, k_syn, v_syn = _to(cuda, torch.float32, _rand(g, 2, 2 * G, D),
                        _rand(g, 2, 2, 64, D), _rand(g, 2, 2, 64, D))
  cbias = torch.zeros((2, 64), device=cuda)
  before = _build.launch_counts()
  with pytest.raises(ValueError, match="head dim"):
    fused_synopsis_score_attention(q, k_syn, v_syn, cbias)
  assert _build.launch_counts() == before


def _check_gather(dev, dtype, q, k, v, sel, C, kw, key=None):
  """block_gather_attention on the card against its plain version on the
  same (card) inputs, softcap 30; one launch of branch ``key`` (default:
  the stream the wrapper picks for the dtype and group)."""
  args = _to(dev, dtype, q, k, v)
  kwc = {n: (t.to(dev) if n in ("sel_bias", "extras_bias")
             else t.to(device=dev, dtype=dtype)) for n, t in kw.items()}
  opts = dict(cluster_size=C, sm_scale=q.shape[-1] ** -0.5, cap=30.0)
  key = key or _build.decode_branch("block_gather_attention", dtype,
                                    q.shape[1] // k.shape[1])
  n0 = _build.LAUNCHES[key]
  got = block_gather_attention(*args, sel.to(dev), **opts, **kwc)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_gather_attention_ref(*args, sel.to(dev), **opts, **kwc)
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["plain", "dec_extras", "padded",
                                  "all_padded", "all_padded_no_extras",
                                  "equal_keys"])
@pytest.mark.parametrize("S", [128, 144])
@pytest.mark.parametrize("E", [129, 144])
def test_card_block_gather(cuda, dtype, case, S, E):
  _check_gather(cuda, dtype, *_gather_inputs(case, S, E=E))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [16, 48, 128])
@pytest.mark.parametrize("I", [1, 3, 32])
@pytest.mark.parametrize("case", ["dec_extras", "padded", "equal_keys"])
def test_card_block_gather_clusters(cuda, dtype, C, I, case):
  """One part a selected cluster: C shorter than a tile (16), not a whole
  number of tiles (48) and several tiles (128); I = 1 (one part with the
  extras), 3 and 32 parts, over M = I + 2 clusters; E = 129."""
  _check_gather(cuda, dtype, *_gather_inputs(case, (I + 2) * C, C=C, I=I,
                                             E=129, seed=C + I))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, _build.GMAX])
def test_card_block_gather_head_dims(cuda, dtype, D, G):
  """Every head dim the kernel is built for, at a group of 1 and of
  GMAX, with both epilogues and a padded id."""
  _check_gather(cuda, dtype, *_gather_inputs("padded", 6 * 48, D=D, C=48,
                                             G=G, E=129, seed=D + G))


@pytest.mark.cuda
@pytest.mark.parametrize("D,G", [(40, 4), (128, _build.GMAX + 1)])
def test_card_block_gather_refuses_unbuilt_shapes(cuda, D, G):
  q, k, v, sel, C, kw = _gather_inputs("dec_extras", 64, D=D, G=G, E=129)
  args = _to(cuda, torch.float32, q, k, v)
  kwc = {n: t.to(cuda) for n, t in kw.items()}
  n0 = _build.LAUNCHES["block_gather_attention"]
  with pytest.raises(ValueError, match="head dim"):
    block_gather_attention(*args, sel.to(cuda), cluster_size=C, **kwc)
  assert _build.LAUNCHES["block_gather_attention"] == n0


def _decode_inputs(g, S, D=128, B=2, Hkv=8, G=4):
  return (_rand(g, B, Hkv * G, D), _rand(g, B, Hkv, S, D),
          _rand(g, B, Hkv, S, D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 65, 129, 385, 4096, 8192, 8320])
@pytest.mark.parametrize("bias_kind", [None, "log_count", "masked"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_flash_decode(cuda, dtype, S, bias_kind, cap):
  """The exact path's shapes (S = 8192, 8320 after an absorb, 1 for the
  self token) and the unfused stage 1's (65 centroids; log(count) bias,
  -1e30 on some keys, or on every key in the S = 1 and 65 cases); S = 129
  and 385 end in a chunk of one row, 4096 is the size of 32 clusters."""
  g = torch.Generator().manual_seed(10)
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, S))
  bias = None
  if bias_kind is not None:
    bias = torch.log(torch.randint(1, 129, (2, 8, S), generator=g).float())
    if bias_kind == "masked":
      bias[torch.rand((2, 8, S), generator=g) < 0.3] = NEG_INF
      if S <= 65:
        bias[:] = NEG_INF
    bias = bias.to(cuda)
  kw = dict(sm_scale=q.shape[-1] ** -0.5, cap=cap)
  n0 = _build.LAUNCHES["flash_decode"]
  got = flash_decode(q, k, v, bias, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES["flash_decode"] == n0 + 1
  want = ref.flash_decode_ref(q, k, v, bias, **kw)
  for a, b in zip(got, want):
    assert a.dtype == torch.float32 and a.shape == b.shape
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,window", [(8192, 4096), (8320, 4096),
                                      (300, 16)])
def test_card_flash_decode_window_view(cuda, dtype, S, window):
  """A local layer's window, ``k[:, :, -window:]`` of a (B, Hkv, S, D)
  layer slice, runs as a strided view (no copy) and equals the kernel on
  a contiguous copy of the same rows, bit for bit; gemma2-2b's shape (D
  256, G 2, cap 50).  A view whose rows are not contiguous is refused."""
  g = torch.Generator().manual_seed(12)
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, S, D=256, B=2, Hkv=4, G=2))
  kw = dict(sm_scale=256 ** -0.5, cap=50.0)
  kw_, vw = k[:, :, -window:], v[:, :, -window:]
  assert not kw_.is_contiguous()
  n0 = _build.LAUNCHES["flash_decode"]
  got = flash_decode(q, kw_, vw, **kw)
  want = flash_decode(q, kw_.contiguous(), vw.contiguous(), **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES["flash_decode"] == n0 + 2
  for a, b in zip(got, want):
    assert torch.equal(a, b)
  for a, b in zip(got, ref.flash_decode_ref(q, kw_, vw, **kw)):
    _close(a, b, TOL[dtype])
  with pytest.raises(ValueError, match="strides"):
    flash_decode(q, k[:, :, ::2], v[:, :, ::2], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,G", sorted({(16, 4), (256, 2)} | {
    (D, G) for D in _build.HEAD_DIMS for G in (1, _build.GMAX)}))
def test_card_flash_decode_head_dims(cuda, dtype, D, G):
  """Every head dim the kernel is built for, at a ragged S, with a group
  of 1 and of GMAX."""
  g = torch.Generator().manual_seed(11)
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, 300, D=D, B=1, Hkv=2, G=G))
  got = flash_decode(q, k, v, sm_scale=D ** -0.5)
  for a, b in zip(got, ref.flash_decode_ref(q, k, v, sm_scale=D ** -0.5)):
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["fused_synopsis", "block_gather",
                                    "flash_decode", "synopsis_score"])
@pytest.mark.parametrize("G", [7, 12, 16])
def test_card_decode_kernels_at_large_groups(cuda, dtype, kernel, G):
  """The decode kernels at arctic-480b's G = 7 (the bucket of 8),
  command-r-plus's G = 12 (the bucket of 16, four zero heads) and G = 16,
  D = 128, Hkv = 8, B = 2, against their plain versions: stage 1 on 300
  centroids (split in chunks, cap 30), stage 2 at I = 32 clusters of 128
  with a padded id and the ring and self token, exact decode over 8320
  rows with a log(count) bias, the unfused op's scores over 1024 rows."""
  g = torch.Generator().manual_seed(G)
  D, B, Hkv = 128, 2, 8
  if kernel == "block_gather":
    _check_gather(cuda, dtype, *_gather_inputs(
        "padded", 36 * 128, D=D, C=128, G=G, Hkv=Hkv, E=129, I=32,
        seed=G))
    return
  S = {"fused_synopsis": 300, "flash_decode": 8320, "synopsis_score": 1024}
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, S[kernel], D=D, B=B,
                                             Hkv=Hkv, G=G))
  sm = D ** -0.5
  if kernel == "synopsis_score":
    got = (synopsis_score(q, k, sm_scale=sm),)
    want = (ref.synopsis_score_ref(q, k, sm_scale=sm),)
  elif kernel == "flash_decode":
    bias = torch.log(torch.randint(1, 129, (B, Hkv, S[kernel]),
                                   generator=g).float()).to(cuda)
    got = flash_decode(q, k, v, bias, sm_scale=sm)
    want = ref.flash_decode_ref(q, k, v, bias, sm_scale=sm)
  else:
    cbias = torch.log(torch.randint(1, 129, (B, S[kernel]),
                                    generator=g).float()).to(cuda)
    got = fused_synopsis_score_attention(q, k, v, cbias, sm_scale=sm,
                                         cap=30.0)
    want = ref.fused_synopsis_score_attention_ref(q, k, v, cbias,
                                                  sm_scale=sm, cap=30.0)
    got, want = (got[0], *got[1]), (want[0], *want[1])
  torch.cuda.synchronize()
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


# The decode core's tensor-core stream (csrc/decode_mma.cuh): bf16 rows read
# by a group in the head bucket of 16, every head dim.

@pytest.mark.cuda
@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("S,bias_kind,cap", [
    (1, None, None), (1, "masked", 30.0), (65, "masked", None),
    (8320, "masked", 30.0)])
def test_card_decode_mma_flash_decode(cuda, D, G, S, bias_kind, cap):
  """flash_decode in bf16 at G = 9, 12 and 16 on the tensor-core stream:
  the self token (S = 1), 65 rows (one chunk, a ragged tile) and 8320
  (chunks merged), a log(count) bias with -1e30 on some keys, cap 30.  One
  launch of ``flash_decode[g16]``, against the plain version."""
  g = torch.Generator().manual_seed(D + G + S)
  B, Hkv = 2, 2
  q, k, v = _to(cuda, torch.bfloat16,
                *_decode_inputs(g, S, D=D, B=B, Hkv=Hkv, G=G))
  bias = None
  if bias_kind is not None:
    bias = torch.log(torch.randint(1, 129, (B, Hkv, S), generator=g).float())
    bias[torch.rand((B, Hkv, S), generator=g) < 0.3] = NEG_INF
    bias = bias.to(cuda)
  kw = dict(sm_scale=D ** -0.5, cap=cap)
  key = _build.branch("flash_decode", _build.DECODE_MMA)
  n0 = _build.LAUNCHES[key]
  got = flash_decode(q, k, v, bias, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  for a, b in zip(got, ref.flash_decode_ref(q, k, v, bias, **kw)):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("case", ["padded", "equal_keys", "all_padded"])
def test_card_decode_mma_block_gather(cuda, D, G, case):
  """block_gather_attention in bf16 at G = 9, 12 and 16: clusters of 48
  rows (tiles of 16 to 64 rows, a ragged last one), a padded id, a
  cluster whose part cancels, or extras only; both epilogues.  One launch
  of ``block_gather_attention[g16]``, against the plain version."""
  _check_gather(cuda, torch.bfloat16, *_gather_inputs(
      case, 6 * 48, D=D, C=48, G=G, E=129, seed=D + G),
      key=_build.branch("block_gather_attention", _build.DECODE_MMA))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_decode", "block_gather"])
@pytest.mark.parametrize("fault", ["build", "launch"])
def test_card_decode_mma_failures_raise(cuda, monkeypatch, kernel, fault):
  """No fallback: where the tensor-core stream's library fails to build, or
  its launch returns an error (here the C entry point's reply to a route
  flag out of range, mma = 2), the wrapper raises and counts no
  launch; it never gives way to the CUDA-core loops or the plain
  version."""
  q, k, v, sel, C, kw = _gather_inputs("padded", 6 * 48, D=128, C=48, G=12,
                                       E=129, seed=5)
  args = _to(cuda, torch.bfloat16, q, k, v)
  kwc = {n: (t.to(cuda) if n in ("sel_bias", "extras_bias")
             else t.to(device=cuda, dtype=torch.bfloat16))
         for n, t in kw.items()}
  if kernel == "flash_decode":
    call = lambda: flash_decode(*args, sm_scale=0.1)  # noqa: E731
  else:
    call = lambda: block_gather_attention(  # noqa: E731
        *args, sel.to(cuda), cluster_size=C, sm_scale=0.1, **kwc)
  call()
  torch.cuda.synchronize()
  if fault == "build":
    def broken(*a, **k):
      raise RuntimeError("nvcc failed (forced)")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", broken)
    match = "forced"
  else:
    monkeypatch.setattr(_build, "decode_mma", lambda name, dtype, G: 2)
    match = "failed to launch"
  before = _build.launch_counts()
  with pytest.raises(RuntimeError, match=match):
    call()
  assert _build.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [64, 65, 300, 1024])
@pytest.mark.parametrize("Hkv,G", [(8, 4), (2, 3)])
def test_card_synopsis_score(cuda, dtype, M, Hkv, G):
  """The loop's M = 64 / 65 (one or a few rows a block), a ragged 300 and
  1024 (four warps a block); G = 3 pads the head bucket with a zero head
  that must stay out of the max."""
  g = torch.Generator().manual_seed(12)
  q, k_syn, _ = _to(cuda, dtype, *_decode_inputs(g, M, Hkv=Hkv, G=G))
  n0 = _build.LAUNCHES["synopsis_score"]
  got = synopsis_score(q, k_syn, sm_scale=128 ** -0.5)
  torch.cuda.synchronize()
  assert _build.LAUNCHES["synopsis_score"] == n0 + 1
  assert got.shape == (2, Hkv, M) and got.dtype == torch.float32
  _close(got, ref.synopsis_score_ref(q, k_syn, sm_scale=128 ** -0.5),
         TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,G", sorted({(D, G) for D in _build.HEAD_DIMS
                                        for G in (1, 2, 5, _build.GMAX)}))
def test_card_synopsis_score_head_dims(cuda, dtype, D, G):
  """Every head dim the kernel is built for (2 to 64 lanes a row, two
  loads a row a lane for f32 at D = 256) and groups of 1 to GMAX, at a
  ragged M.  Rows whose real logits are all negative show a padded
  head's zero taken into the max; a negative sm_scale shows the scale
  applied before the max, as the Pallas kernel applies it."""
  g = torch.Generator().manual_seed(14)
  q, k_syn, _ = _to(cuda, dtype, *_decode_inputs(g, 77, D=D, B=1, Hkv=2,
                                                 G=G))
  logits = torch.einsum("bhgd,bhmd->bhgm", q.reshape(1, 2, G, D).float(),
                        k_syn.float())
  for sm in (D ** -0.5, -(D ** -0.5)):
    _close(synopsis_score(q, k_syn, sm_scale=sm), (logits * sm).amax(2),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["flash_decode", "fused_synopsis",
                                    "block_gather", "synopsis_score"])
def test_card_decode_kernels_at_g3_d64(cuda, dtype, kernel):
  """smollm-135m's heads: 3 KV heads of 64, G = 3, which the decode core
  and the score kernel pad to a bucket of 4 with a zero head row that must
  stay out of every output; ragged sizes (S not a multiple of a chunk, M
  not of a warp tile, C not of a key tile)."""
  B, Hkv, G, D = 2, 3, 3, 64
  g = torch.Generator().manual_seed(21)
  sm = D ** -0.5
  for n in (65, 301, 8191):
    q, k, v = _to(cuda, dtype, *_decode_inputs(g, n, D=D, B=B, Hkv=Hkv,
                                               G=G))
    if kernel == "flash_decode":
      bias = torch.log(torch.randint(1, 129, (B, Hkv, n), generator=g)
                       .float()).to(cuda)
      for a, b in zip(flash_decode(q, k, v, bias, sm_scale=sm),
                      ref.flash_decode_ref(q, k, v, bias, sm_scale=sm)):
        _close(a, b, TOL[dtype])
    elif kernel == "fused_synopsis":
      cbias = torch.log(torch.randint(1, 129, (B, n), generator=g)
                        .float()).to(cuda)
      got = fused_synopsis_score_attention(q, k, v, cbias, sm_scale=sm)
      want = ref.fused_synopsis_score_attention_ref(q, k, v, cbias,
                                                    sm_scale=sm)
      for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        _close(a, b, TOL[dtype])
    elif kernel == "synopsis_score":
      _close(synopsis_score(q, k, sm_scale=sm),
             ref.synopsis_score_ref(q, k, sm_scale=sm), TOL[dtype])
    else:
      C, M, I = (48, 6, 3) if n < 8191 else (128, 64, 32)
      _check_gather(cuda, dtype, *_gather_inputs(
          "padded", M * C, D=D, C=C, G=G, Hkv=Hkv, E=129, I=I, seed=n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,S", [("flash_decode", 1500),
                                      ("flash_decode", 8192),
                                      ("fused_synopsis", 64),
                                      ("block_gather", 8192)])
def test_card_decode_kernels_at_whisper_shapes(cuda, dtype, kernel, S):
  """whisper-medium's heads: 16 KV heads of 64, G = 1 (the decode core's
  head bucket of 1), B = 2.  ``flash_decode`` over the cross rows a step
  reads: 1500 encoder frames (a ragged S) or the loop's 8192 prompt
  tokens; stage 1 on the 64 centroids of an 8192-token prompt; stage 2 at
  S 8192, I 32, C 128, with the ring and self token (E = 129)."""
  B, Hkv, G, D = 2, 16, 1, 64
  g = torch.Generator().manual_seed(22)
  sm = D ** -0.5
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, S, D=D, B=B, Hkv=Hkv, G=G))
  if kernel == "flash_decode":
    n0 = _build.LAUNCHES["flash_decode"]
    got = flash_decode(q, k, v, sm_scale=sm)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_decode"] == n0 + 1
    for a, b in zip(got, ref.flash_decode_ref(q, k, v, sm_scale=sm)):
      _close(a, b, TOL[dtype])
  elif kernel == "fused_synopsis":
    cbias = torch.log(torch.randint(1, 129, (B, S), generator=g)
                      .float()).to(cuda)
    got = fused_synopsis_score_attention(q, k, v, cbias, sm_scale=sm)
    want = ref.fused_synopsis_score_attention_ref(q, k, v, cbias,
                                                  sm_scale=sm)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
      _close(a, b, TOL[dtype])
  else:
    _check_gather(cuda, dtype, *_gather_inputs(
        "padded", S, D=D, C=128, G=G, Hkv=Hkv, E=129, I=32, seed=S))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("i_max", [1, 32, 64])
def test_card_unfused_and_fused_synopsis_ops(cuda, dtype, i_max):
  """The unfused op (synopsis_score, masked flash_decode over the
  centroids, block_gather with neither epilogue) at the decode shape, on
  the card against the plain versions, and against the fused op."""
  B, Hkv, D, C, M = 2, 8, 128, 128, 64
  g = torch.Generator().manual_seed(13)
  q, k, v = _to(cuda, dtype, *_decode_inputs(g, M * C))
  k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  v_syn = v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
  counts = torch.full((B, M), float(C), device=cuda)
  args, kw = (q, k, v, k_syn, v_syn, counts), dict(i_max=i_max,
                                                  sm_scale=D ** -0.5)
  before = _build.launch_counts()
  got = ops.synopsis_attention(*args, **kw)
  after = _build.launch_counts()
  for name in ("synopsis_score", "flash_decode", "block_gather_attention"):
    assert after[name] == before[name] + 1, name
  want, _, _ = ref.synopsis_attention_ref(*args, **kw)
  _close(got, want, TOL[dtype])
  _close(ops.synopsis_attention_fused(*args, **kw), got, TOL[dtype])
  if i_max == M:
    _close(got, ref.exact_attention_ref(q, k, v, sm_scale=D ** -0.5),
           TOL[dtype])


# -- the latent core (MLA's absorbed decode: one key/value head of 576, 128
# query heads in f32; 48 and 4 at SMOKE size) --------------------------------

LATENT_SHAPES = [(4, 48), (128, 576)]        # (G, D)
LATENT = _build.LATENT


def _latent_q(g, B, G, D):
  """An f32 query whose logits spread ~1 over rows of D ~N(0, 1) values."""
  return _rand(g, B, G, D) * (D ** -0.5) * 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("S", [1, 65, 300, 8192])
@pytest.mark.parametrize("bias_kind,cap", [(None, None), ("masked", None),
                                           ("log_count", 30.0)])
def test_card_latent_flash_decode(cuda, dtype, G, D, S, bias_kind, cap):
  """The latent core's flash_decode: an f32 query of G heads over one K/V
  head of f32 or bf16 rows (the exact path's latent cache at S = 8192, the
  self token at S = 1, the unfused op's masked centroids at 65), against
  the plain version; one launch of the "latent" branch."""
  g = torch.Generator().manual_seed(40 + S)
  q = _latent_q(g, 2, G, D).to(cuda)
  k, v = _to(cuda, dtype, _rand(g, 2, 1, S, D), _rand(g, 2, 1, S, D))
  bias = None
  if bias_kind is not None:
    bias = torch.log(torch.randint(1, 129, (2, 1, S), generator=g).float())
    if bias_kind == "masked":
      bias[torch.rand((2, 1, S), generator=g) < 0.3] = NEG_INF
      if S <= 65:
        bias[0] = NEG_INF
    bias = bias.to(cuda)
  kw = dict(sm_scale=192 ** -0.5, cap=cap)
  key = _build.branch("flash_decode", LATENT)
  n0 = _build.LAUNCHES[key]
  got = flash_decode(q, k, v, bias, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  for a, b in zip(got, ref.flash_decode_ref(q, k, v, bias, **kw)):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("case,C,I", [("dec_extras", 128, 32),
                                      ("padded", 16, 3),
                                      ("equal_keys", 48, 3),
                                      ("all_padded", 16, 1),
                                      ("plain", 128, 1)])
def test_card_latent_block_gather(cuda, dtype, G, D, case, C, I):
  """The latent core's stage 2 (its f32 query beside f32 or bf16 cache,
  extras and decrement rows) in every case of the serve step's inputs,
  Hkv = 1; the decrement rows also in f32 beside a bf16 cache."""
  q, k, v, sel, C, kw = _gather_inputs(case, (I + 2) * C, D=D, C=C, I=I,
                                       G=G, Hkv=1, E=129, seed=G + C + I)
  q = (q * (D ** -0.5) * 3.0).to(cuda)
  k, v = _to(cuda, dtype, k, v)
  opts = dict(cluster_size=C, sm_scale=192 ** -0.5, cap=30.0)
  decs = [dtype] + ([torch.float32] if dtype != torch.float32
                    and "k_sel" in kw else [])
  for dec in decs:
    kwc = {n: (t.to(cuda) if n in ("sel_bias", "extras_bias") else
               t.to(device=cuda, dtype=dec if n in ("k_sel", "v_sel")
                    else dtype)) for n, t in kw.items()}
    key = _build.branch("block_gather_attention", LATENT)
    n0 = _build.LAUNCHES[key]
    got = block_gather_attention(q, k, v, sel.to(cuda), **opts, **kwc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n0 + 1
    want = ref.fused_gather_attention_ref(q, k, v, sel.to(cuda), **opts,
                                          **kwc)
    for a, b in zip(got, want):
      assert torch.isfinite(a).all()
      _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("M", [64, 65, 1024])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_latent_fused_synopsis(cuda, dtype, G, D, M, cap):
  """The latent core's stage 1: the scores (a max over all G heads, across
  the head tiles) and the count-biased partials, over f32 or bf16 tables
  of M centroids (one or several chunks of M)."""
  g = torch.Generator().manual_seed(50 + M)
  q = _latent_q(g, 2, G, D).to(cuda)
  k_syn, v_syn = _to(cuda, dtype, _rand(g, 2, 1, M, D), _rand(g, 2, 1, M, D))
  cbias = torch.log(torch.randint(1, 129, (2, M), generator=g).float())
  kw = dict(sm_scale=192 ** -0.5, cap=cap)
  key = _build.branch("fused_synopsis_score_attention", LATENT)
  n0 = _build.LAUNCHES[key]
  got = fused_synopsis_score_attention(q, k_syn, v_syn, cbias.to(cuda), **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn,
                                                cbias.to(cuda), **kw)
  _close(got[0], want[0], TOL[dtype])
  for a, b in zip(got[1], want[1]):
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,D", LATENT_SHAPES + [(100, 576)])
@pytest.mark.parametrize("M", [64, 65, 1024])
def test_card_latent_synopsis_score(cuda, dtype, G, D, M):
  """The latent core's scores: one block a (b, hkv) and 16 rows, the max
  over every head tile (G = 100: a last tile of 4 live heads)."""
  g = torch.Generator().manual_seed(60 + M)
  q = _latent_q(g, 2, G, D).to(cuda)
  k_syn = _rand(g, 2, 1, M, D).to(device=cuda, dtype=dtype)
  key = _build.branch("synopsis_score", LATENT)
  n0 = _build.LAUNCHES[key]
  got = synopsis_score(q, k_syn, sm_scale=192 ** -0.5)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  _close(got, ref.synopsis_score_ref(q, k_syn, sm_scale=192 ** -0.5),
         TOL[dtype])


@pytest.mark.cuda
def test_card_latent_core_refuses_what_it_does_not_take(cuda):
  """The latent widths take an f32 query only, and G <= LATENT_GMAX: a bf16
  query or G = 129 raises and launches nothing."""
  g = torch.Generator().manual_seed(70)
  k = _rand(g, 2, 1, 64, 576).to(cuda)
  before = _build.launch_counts()
  with pytest.raises(TypeError, match="f32 query"):
    flash_decode(_latent_q(g, 2, 4, 576).to(cuda, torch.bfloat16),
                 k.bfloat16(), k.bfloat16())
  with pytest.raises(ValueError, match="group"):
    flash_decode(_latent_q(g, 2, _build.LATENT_GMAX + 1, 576).to(cuda), k,
                 k)
  with pytest.raises(ValueError, match="group"):
    synopsis_score(_latent_q(g, 2, _build.LATENT_GMAX + 1, 576).to(cuda), k)
  assert _build.launch_counts() == before


# The latent core's tensor-core kernels (csrc/latent_mma.cuh): bf16 rows,
# and int8 / fp8 codes beside bf16 extras; head tiles of 64, 16-row tiles,
# a merge launch after more than one part.

@pytest.mark.cuda
@pytest.mark.parametrize("B,G,S", [(2, 100, 1), (2, 100, 10), (2, 100, 300),
                                   (2, 128, 10), (2, 128, 8192),
                                   (1, 128, 512)])
@pytest.mark.parametrize("bias_kind,cap", [(None, None), ("masked", 30.0)])
def test_card_latent_mma_decode_edges(cuda, B, G, S, bias_kind, cap):
  """The tensor-core flash_decode at its geometry's edges, bf16 rows of
  576: a last head tile of 36 live heads (G = 100), S below one 16-row
  tile (1, 10) and ragged (300), one chunk (S = 1, 10) against many (300,
  8192: their parts merged by the second launch), and the cut serving
  path's shard (B = 1, S = 512: [tp-mla]); the latent tests' tolerance."""
  g = torch.Generator().manual_seed(140 + G + S)
  D = 576
  q = _latent_q(g, B, G, D).to(cuda)
  k, v = _to(cuda, torch.bfloat16, _rand(g, B, 1, S, D), _rand(g, B, 1, S, D))
  bias = None
  if bias_kind is not None:
    bias = torch.log(torch.randint(1, 129, (B, 1, S), generator=g).float())
    bias[torch.rand((B, 1, S), generator=g) < 0.3] = NEG_INF
    bias = bias.to(cuda)
  kw = dict(sm_scale=192 ** -0.5, cap=cap)
  key = _build.branch("flash_decode", LATENT)
  n0 = _build.LAUNCHES[key]
  got = flash_decode(q, k, v, bias, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  for a, b in zip(got, ref.flash_decode_ref(q, k, v, bias, **kw)):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("case", ["dec_extras", "padded", "all_padded"])
def test_card_latent_mma_gather_last_tile(cuda, kind, case):
  """The tensor-core stage 2 at G = 100 (a last head tile of 36 live
  heads) on a bf16 cache and on int8 / fp8 codes with one scale per
  cluster block, bf16 extras, against the plain version."""
  C, I = (128, 32) if case == "dec_extras" else (16, 3)
  q, k, v, sel, C, kw = _gather_inputs(case, (I + 2) * C, D=576, C=C, I=I,
                                       G=100, Hkv=1, E=129, seed=I + C)
  q = (q * (576 ** -0.5) * 3.0).to(cuda)
  bf = ("extras_k", "extras_v") + (("k_sel", "v_sel") if kind == "none"
                                   else ())
  kw = {n: t.to(device=cuda, dtype=torch.bfloat16 if n in bf else t.dtype)
        for n, t in kw.items()}
  if kind == "none":
    k, v = _to(cuda, torch.bfloat16, k, v)
  else:
    k, ks = qt.quantize_rows(k, kind, block=C)
    v, vs = qt.quantize_rows(v, kind, block=C)
    k, v = k.to(cuda), v.to(cuda)
    kw.update(kv_k_scale=ks.to(cuda), kv_v_scale=vs.to(cuda))
  opts = dict(cluster_size=C, sm_scale=192 ** -0.5, cap=30.0)
  key = _build.branch("block_gather_attention", _build.latent_branch(kind))
  n0 = _build.LAUNCHES[key]
  got = block_gather_attention(q, k, v, sel.to(cuda), **opts, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_gather_attention_ref(q, k, v, sel.to(cuda), **opts, **kw)
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[torch.bfloat16])


def _device_kernels(fn):
  """The names of the device kernels one call of ``fn`` launches."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  return {e.key for e in prof.key_averages()
          if e.device_type != torch.autograd.DeviceType.CPU}


@pytest.mark.cuda
def test_card_latent_rows_choose_the_kernel(cuda):
  """bf16 rows, and int8 / fp8 codes beside bf16 extras, launch the
  tensor-core kernels; f32 rows, and codes beside f32 extras, the CUDA-core
  ones.  Both count under the latent branch keys; the profiler's kernel
  names tell them apart."""
  g = torch.Generator().manual_seed(150)
  B, G, D, S = 2, 128, 576, 512
  q = _latent_q(g, B, G, D).to(cuda)
  k0, v0 = _rand(g, B, 1, S, D), _rand(g, B, 1, S, D)
  new, old = "latent_flash_decode_wgmma", "latent_flash_decode_kernel"
  for dtype, want, other in ((torch.bfloat16, new, old),
                             (torch.float32, old, new)):
    k, v = _to(cuda, dtype, k0, v0)
    key = _build.branch("flash_decode", LATENT)
    n0 = _build.LAUNCHES[key]
    names = _device_kernels(lambda: flash_decode(q, k, v, sm_scale=0.07))
    assert _build.LAUNCHES[key] == n0 + 2
    assert any(want in n for n in names), (dtype, names)
    assert not any(other in n for n in names), (dtype, names)
  C, I = 128, 2
  sel = torch.tensor([[[0, 2]], [[3, 1]]], dtype=torch.int32, device=cuda)
  ek, ev = _rand(g, B, 1, 129, D), _rand(g, B, 1, 129, D)
  eb = torch.zeros((B, 129), device=cuda)
  new, old = "latent_gather_wgmma", "latent_gather_kernel"
  for kind in ("none", "int8", "fp8"):
    for xtype, want, other in ((torch.bfloat16, new, old),
                               (torch.float32, old, new)):
      kw = dict(cluster_size=C, sm_scale=0.07, extras_k=ek.to(cuda, xtype),
                extras_v=ev.to(cuda, xtype), extras_bias=eb)
      if kind == "none":
        k, v = _to(cuda, xtype, k0, v0)
      else:
        k, ks = qt.quantize_rows(k0, kind, block=C)
        v, vs = qt.quantize_rows(v0, kind, block=C)
        k, v = k.to(cuda), v.to(cuda)
        kw.update(kv_k_scale=ks.to(cuda), kv_v_scale=vs.to(cuda))
      key = _build.branch("block_gather_attention",
                          _build.latent_branch(kind))
      n0 = _build.LAUNCHES[key]
      names = _device_kernels(
          lambda: block_gather_attention(q, k, v, sel, **kw))
      assert _build.LAUNCHES[key] == n0 + 2
      assert any(want in n for n in names), (kind, xtype, names)
      assert not any(other in n for n in names), (kind, xtype, names)


@pytest.mark.cuda
def test_card_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  q, k, v = _to(cuda, torch.float16, *_prefill_inputs((1, 64, 2, 2, 16)))
  with pytest.raises(TypeError):
    flash_prefill(q, k, v)
  q, k, v = _to(cuda, torch.float32, *_prefill_inputs((1, 64, 2, 2, 16)))
  with pytest.raises(ValueError, match="contiguous"):
    segment_build(k.transpose(1, 2), v.transpose(1, 2),
                  torch.zeros((1, 64), dtype=torch.int32, device=cuda),
                  cluster_size=16)
  with pytest.raises(ValueError):
    flash_prefill(q, k[:, :, :1].contiguous(), v)
  q, k, v = _to(cuda, torch.float32, *_decode_inputs(
      torch.Generator().manual_seed(0), 64, D=40))
  with pytest.raises(ValueError, match="head dim"):
    flash_decode(q, k, v)
  perm = torch.arange(64, dtype=torch.int32, device=cuda).expand(2, 64)
  with pytest.raises(ValueError, match="head dim"):
    segment_build(k[..., :40].contiguous(), v[..., :40].contiguous(), perm,
                  cluster_size=16)
  with pytest.raises(ValueError, match="head dim"):
    synopsis_score(q, k)
  q, k, _ = _to(cuda, torch.float32, *_decode_inputs(
      torch.Generator().manual_seed(0), 64, D=16, Hkv=1, G=_build.GMAX + 1))
  before = _build.launch_counts()
  with pytest.raises(ValueError, match="group"):
    synopsis_score(q, k)
  with pytest.raises(ValueError, match="group"):
    flash_decode(q, k, k)
  assert _build.launch_counts() == before


@pytest.mark.cuda
def test_card_synopsis_cache_attention_full_budget_is_exact(cuda):
  """i_max = M: stage 1's centroid terms are all decremented, leaving
  exact attention over cache + ring + self."""
  B, Hkv, G, D, C, M, R = 2, 8, 4, 128, 128, 9, 128
  S = M * C
  g = torch.Generator().manual_seed(9)
  q, k, v, rk, rv, sk, sv = _to(
      cuda, torch.float32, _rand(g, B, Hkv * G, D), _rand(g, B, Hkv, S, D),
      _rand(g, B, Hkv, S, D), _rand(g, B, Hkv, R, D), _rand(g, B, Hkv, R, D),
      _rand(g, B, Hkv, 1, D), _rand(g, B, Hkv, 1, D))
  k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
  v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
  counts = torch.full((B, M), float(C), device=cuda)
  rlen = torch.full((B,), 37, dtype=torch.int32, device=cuda)
  got = ops.synopsis_cache_attention(
      q, k, v, k_syn, v_syn, counts, rk, rv, rlen, sk, sv, i_max=M,
      cluster_size=C, sm_scale=D ** -0.5)
  keys = torch.cat([k, rk[:, :, :37], sk], dim=2)
  vals = torch.cat([v, rv[:, :, :37], sv], dim=2)
  _close(got, ref.exact_attention_ref(q, keys, vals, sm_scale=D ** -0.5),
         TOL[torch.float32])


# ---------------------------------------------------------------------------
# The quantized branches (int8 / fp8 arena) against their plain versions
# ---------------------------------------------------------------------------

QSPECS = ("int8", "fp8", "int8+kv", "fp8+kv")


def _steps(x):
  """Codes as ordered integers (fp8 by sign and magnitude bits), so that
  neighbouring codes differ by 1."""
  if x.dtype == torch.int8:
    return x.cpu().long()
  bits = x.view(torch.uint8).cpu().long()
  return torch.where(bits >= 128, -(bits & 0x7F), bits)


def _tied_cache(g, kind, N, Hkv, S, D, C):
  """Random rows, with the first cluster block of every (n, h) made of
  halves and odd integers up to the kind's qmax, so that its scale is 1
  and the encode meets ties (int8: x.5; fp8: odd values where the step
  is 2, x.5 where it is 1)."""
  x = _rand(g, N, Hkv, S, D) * 3.0
  qmax = qt.qmax(kind)
  ties = torch.randint(-2 * int(qmax) + 1, 2 * int(qmax), (N, Hkv, C, D),
                       generator=g).float() / 2.0
  ties[..., 0, 0] = qmax
  x[:, :, :C] = ties
  return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", QSPECS)
@pytest.mark.parametrize("perm_kind", ["clustered", "identity"])
@pytest.mark.parametrize("C,D", BUILD_SHAPES)
def test_card_segment_build_quant(cuda, dtype, spec, perm_kind, C, D):
  """Sorted-KV codes and their scales bit-equal to the plain version (no
  sum in them); centroid codes at most one step apart (an f32 mean summed
  in another order), on few entries; centroid scales within f32
  rounding."""
  N, Hkv, S = 3, 2, _build_rows(C)
  kind = qt.parse_qconfig(spec).kind
  g = torch.Generator().manual_seed(14)
  k, v = _to(cuda, dtype, _tied_cache(g, kind, N, Hkv, S, D, C),
             _tied_cache(g, kind, N, Hkv, S, D, C))
  if perm_kind == "identity":
    perm = torch.arange(S, dtype=torch.int32).expand(N, S)
  else:
    perm = torch.stack([torch.randperm(S, generator=g) for _ in range(N)])
  perm = perm.to(cuda)
  key = _build.branch("segment_build", spec)
  n0 = _build.LAUNCHES[key]
  got = segment_build(k, v, perm, cluster_size=C, quant=spec)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.synopsis_build_quant_ref(k, v, perm, cluster_size=C,
                                      qc=qt.parse_qconfig(spec))
  assert set(got) == set(want)
  for name in want:
    assert got[name].dtype == want[name].dtype, name
    assert got[name].shape == want[name].shape, name
  for name in ("k", "v", "counts", "k_scale", "v_scale"):
    if name not in want:
      continue
    if want[name].dtype in qt.QDTYPES:
      assert torch.equal(_steps(got[name]), _steps(want[name])), name
    else:
      assert torch.equal(got[name], want[name]), name
  for name in ("k_syn", "v_syn"):
    step = (_steps(got[name]) - _steps(want[name])).abs()
    assert int(step.max()) <= 1, name
    assert float((step > 0).float().mean()) < 0.01, name
    _close(got[name + "_scale"], want[name + "_scale"],
           dict(rtol=1e-5, atol=1e-7))


def _quant_tables(g, kind, B, Hkv, M, D):
  kq, ks = qt.quantize_rows(_rand(g, B, Hkv, M, D) * 0.5, kind)
  vq, vs = qt.quantize_rows(_rand(g, B, Hkv, M, D), kind)
  return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("M", [64, 65, 300, 1024, 1025])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_fused_synopsis_quant(cuda, dtype, kind, M, cap):
  B, Hkv, G, D = 2, 8, 4, 128
  g = torch.Generator().manual_seed(15)
  q = _rand(g, B, Hkv * G, D).to(device=cuda, dtype=dtype)
  kq, vq, ks, vs = (t.to(cuda) for t in _quant_tables(g, kind, B, Hkv, M, D))
  cbias = torch.log(torch.randint(1, 129, (B, M), generator=g).float())
  cbias = cbias.to(cuda)
  kw = dict(sm_scale=D ** -0.5, cap=cap, k_scale=ks, v_scale=vs)
  key = _build.branch("fused_synopsis_score_attention", kind)
  n0 = _build.LAUNCHES[key]
  got = fused_synopsis_score_attention(q, kq, vq, cbias, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_synopsis_score_attention_ref(q, kq, vq, cbias, **kw)
  _close(got[0], want[0], TOL[dtype])
  for a, b in zip(got[1], want[1]):
    _close(a, b, TOL[dtype])


def _quant_gather_inputs(g, spec, M, budget, dtype, dev, C=128,
                         equal=False, Hkv=8, G=4, D=128, latent=False):
  """Stage-2 inputs as ``refine_stage2`` builds them on a quantized arena
  at the decode shape: decrement rows dequantized in f32 from the
  quantized centroid tables (the means of the cache's clusters), E = 129
  extras in the compute type, per-block scales under ``+kv``.  ``equal``:
  the first selected cluster's keys are all equal, so its rows nearly
  cancel its centroid term (exactly up to the centroid table's
  rounding).  ``latent``: the latent core's f32 query (logits spread ~1),
  the extras and an unquantized cache in ``dtype``."""
  B = 2
  qc = qt.parse_qconfig(spec)
  q = _rand(g, B, Hkv * G, D)
  if latent:
    q = q * (D ** -0.5) * 3.0
  k, v = _rand(g, B, Hkv, M * C, D), _rand(g, B, Hkv, M * C, D)
  if budget == 0:
    sel = torch.full((B, Hkv, 1), -1, dtype=torch.int32)
  else:
    sel = torch.stack([torch.stack([torch.randperm(M, generator=g)[:budget]
                                    for _ in range(Hkv)]) for _ in range(B)])
    sel = sel.to(torch.int32)
  if equal:
    for b in range(B):
      for h in range(Hkv):
        c = int(sel[b, h, 0])
        k[b, h, c * C:(c + 1) * C] = k[b, h, c * C]
  kw = {}
  if qc.sorted_kv:
    k, kw["kv_k_scale"] = qt.quantize_rows(k, qc.kind, block=C)
    v, kw["kv_v_scale"] = qt.quantize_rows(v, qc.kind, block=C)
  else:
    k, v = k.to(dtype), v.to(dtype)
  def table(x, scale):  # the centroid table: the clusters' means, quantized
    xf = x.float() if scale is None else qt.dequantize_rows(x, scale, block=C)
    return qt.quantize_rows(xf.reshape(B, Hkv, M, C, D).mean(3), qc.kind)
  kq, ks = table(k, kw.get("kv_k_scale"))
  vq, vs = table(v, kw.get("kv_v_scale"))
  safe = sel.long().clamp_min(0)
  rows = safe[..., None].expand(-1, -1, -1, D)
  kw["k_sel"] = (qt.gather_rows(kq, 2, rows).float()
                 * torch.gather(ks, 2, safe)[..., None])
  kw["v_sel"] = (qt.gather_rows(vq, 2, rows).float()
                 * torch.gather(vs, 2, safe)[..., None])
  kw["sel_bias"] = torch.full(sel.shape, float(np.log(C)))
  ek, ev = _rand(g, B, Hkv, 129, D), _rand(g, B, Hkv, 129, D)
  eb = torch.zeros((B, 129))
  eb[:, 100:128] = NEG_INF
  kw.update(extras_k=ek.to(dtype), extras_v=ev.to(dtype), extras_bias=eb)
  return (q.to(device=dev, dtype=torch.float32 if latent else dtype),
          k.to(dev), v.to(dev), sel.to(dev), C,
          {n: t.to(dev) for n, t in kw.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", QSPECS)
@pytest.mark.parametrize("M", [64, 65])
@pytest.mark.parametrize("budget,equal", [(0, False), (1, False), (3, True),
                                          (32, False), (32, True)])
@pytest.mark.parametrize("C", [16, 128])
def test_card_block_gather_quant(cuda, dtype, spec, M, budget, equal, C):
  """Every stage-2 branch the quantized path runs: a bf16 / f32 cache with
  f32 decrement rows (int8, fp8), and an int8 / fp8 cache with its
  per-block scales (+kv); budget 0 reads cluster 0's scale for the -1
  ids, never past the table; one part (budget 1 with the extras) to 32;
  a cluster of equal keys, whose part nearly cancels."""
  g = torch.Generator().manual_seed(16)
  q, k, v, sel, C, kw = _quant_gather_inputs(g, spec, M, budget, dtype,
                                             cuda, C=C, equal=equal)
  qc = qt.parse_qconfig(spec)
  key = _build.branch("block_gather_attention",
                      qc.kind if qc.sorted_kv else "none")
  opts = dict(cluster_size=C, sm_scale=q.shape[-1] ** -0.5, cap=30.0)
  n0 = _build.LAUNCHES[key]
  got = block_gather_attention(q, k, v, sel, **opts, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_gather_attention_ref(q, k, v, sel, **opts, **kw)
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("spec", QSPECS)
@pytest.mark.parametrize("i_max", [0, 3, 9])
def test_card_quant_synopsis_cache_attention(cuda, spec, i_max):
  """The quantized pipeline (build, stage 1, top-k, stage 2, merge) on the
  card against the same ops on the CPU (plain versions), f32, M = 9."""
  B, Hkv, G, D, C, M, R = 2, 8, 4, 128, 128, 9, 128
  g = torch.Generator().manual_seed(17)
  q = _rand(g, B, Hkv * G, D)
  k, v = _rand(g, B, Hkv, M * C, D), _rand(g, B, Hkv, M * C, D)
  rk, rv = _rand(g, B, Hkv, R, D), _rand(g, B, Hkv, R, D)
  sk, sv = _rand(g, B, Hkv, 1, D), _rand(g, B, Hkv, 1, D)
  perm = torch.stack([torch.randperm(M * C, generator=g) for _ in range(B)])
  rlen = torch.full((B,), 37, dtype=torch.int32)
  outs = []
  for dev in ("cpu", cuda):
    arena = ops.synopsis_build(k.to(dev), v.to(dev), perm.to(dev),
                               cluster_size=C, qconfig=spec)
    outs.append(ops.synopsis_cache_attention(
        *(t.to(dev) for t in (q, arena["k"], arena["v"], arena["k_syn"],
                              arena["v_syn"], arena["counts"], rk, rv, rlen,
                              sk, sv)),
        *(arena.get(n) for n in qt.SCALE_LEAVES), i_max=i_max,
        cluster_size=C, sm_scale=D ** -0.5))
  _close(outs[1], outs[0], TOL[torch.float32])


@pytest.mark.cuda
def test_card_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  g = torch.Generator().manual_seed(18)
  q = _rand(g, 2, 8, 64).to(cuda)
  kq, vq, ks, vs = (t.to(cuda) for t in _quant_tables(g, "int8", 2, 2, 8,
                                                       64))
  cb = torch.zeros((2, 8), device=cuda)
  with pytest.raises(ValueError, match="scales"):
    fused_synopsis_score_attention(q, kq, vq, cb)
  with pytest.raises(ValueError, match="scales"):
    fused_synopsis_score_attention(q, kq.float(), vq.float(), cb,
                                   k_scale=ks, v_scale=vs)
  with pytest.raises(TypeError):
    fused_synopsis_score_attention(q.to(torch.int8), kq, vq, cb, k_scale=ks,
                                   v_scale=vs)
  with pytest.raises(TypeError):
    fused_synopsis_score_attention(q, kq.half(), vq.half(), cb)
  sel = torch.zeros((2, 2, 1), dtype=torch.int32, device=cuda)
  with pytest.raises(ValueError, match="scales"):
    block_gather_attention(q, kq, vq, sel, cluster_size=1)
  with pytest.raises(TypeError):
    block_gather_attention(q, kq.float(), vq.float(), sel, cluster_size=1,
                           k_sel=kq[:, :, :1].bfloat16(),
                           v_sel=vq[:, :, :1].bfloat16(),
                           sel_bias=torch.zeros((2, 2, 1), device=cuda))


# The latent core's quantized branches (MLA under every --quant spec).

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("M", [64, 65, 1024])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_latent_fused_synopsis_quant(cuda, kind, G, D, M, cap):
  """The latent core's stage 1 on int8 / fp8 tables with one scale a row
  (``has_scale``): the scores (the k-scale on the raw dot, a max over all
  G heads across the head tiles) and the partials (the v-scale on p),
  against the plain version; one launch of the "latent-<kind>" branch."""
  g = torch.Generator().manual_seed(80 + M)
  q = _latent_q(g, 2, G, D).to(cuda)
  kq, vq, ks, vs = (t.to(cuda) for t in _quant_tables(g, kind, 2, 1, M, D))
  cbias = torch.log(torch.randint(1, 129, (2, M), generator=g).float())
  kw = dict(sm_scale=192 ** -0.5, cap=cap, k_scale=ks, v_scale=vs)
  key = _build.branch("fused_synopsis_score_attention",
                      _build.latent_branch(kind))
  n0 = _build.LAUNCHES[key]
  got = fused_synopsis_score_attention(q, kq, vq, cbias.to(cuda), **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_synopsis_score_attention_ref(q, kq, vq, cbias.to(cuda),
                                                **kw)
  _close(got[0], want[0], TOL[torch.float32])
  for a, b in zip(got[1], want[1]):
    _close(a, b, TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", QSPECS)
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("budget,equal", [(0, False), (1, False), (3, True),
                                          (32, False)])
@pytest.mark.parametrize("C", [16, 128])
def test_card_latent_block_gather_quant(cuda, dtype, spec, G, D, budget,
                                        equal, C):
  """The latent core's stage 2 as the quantized path runs it: under
  ``+kv`` int8 / fp8 cache blocks with one scale each (``has_kq``: the
  k-scale on the block's dots, the v-scale on its sum) beside f32 or bf16
  extras; under the table-only specs the f32 / bf16 cache with f32
  decrement rows; the f32 query of G heads, Hkv = 1."""
  g = torch.Generator().manual_seed(90 + G + C)
  q, k, v, sel, C, kw = _quant_gather_inputs(
      g, spec, 64, budget, dtype, cuda, C=C, equal=equal, Hkv=1, G=G, D=D,
      latent=True)
  qc = qt.parse_qconfig(spec)
  key = _build.branch("block_gather_attention", _build.latent_branch(
      qc.kind if qc.sorted_kv else "none"))
  opts = dict(cluster_size=C, sm_scale=192 ** -0.5, cap=30.0)
  n0 = _build.LAUNCHES[key]
  got = block_gather_attention(q, k, v, sel, **opts, **kw)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_gather_attention_ref(q, k, v, sel, **opts, **kw)
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", LATENT_SHAPES)
def test_card_latent_fp8_widening_all_codes(cuda, G, D):
  """Every e4m3 code, the two NaN codes included, widened by the latent
  core equals ``quant.dequantize_rows``' decode: each batch row's table
  row 0 holds D of the 256 codes at unit scale and takes p = 1 (the other
  rows are masked and zero), so stage 1's output rows are the decoded
  values.  (Equal as values: the accumulator starts at +0, so the code of
  -0 comes out as +0.)"""
  nb = -(-256 // D)
  M = 16
  codes = torch.zeros((nb, 1, M, D), dtype=torch.uint8)
  codes[:, 0, 0] = (torch.arange(nb * D) % 256).to(torch.uint8).view(nb, D)
  vq = codes.view(torch.float8_e4m3fn).to(cuda)
  kq = torch.zeros_like(vq)
  ones = torch.ones((nb, 1, M), device=cuda)
  cbias = torch.full((nb, M), NEG_INF, device=cuda)
  cbias[:, 0] = 0.0
  q = torch.zeros((nb, G, D), device=cuda)
  _, (o, _, l) = fused_synopsis_score_attention(
      q, kq, vq, cbias, sm_scale=1.0, k_scale=ones, v_scale=ones)
  torch.cuda.synchronize()
  assert torch.equal(l, torch.ones_like(l))
  want = qt.dequantize_rows(vq, ones)[:, 0, 0]                  # (nb, D)
  nan = torch.isnan(want)
  assert int(nan.sum()) == 2 * (nb * D // 256)
  for h in range(G):
    got = o[:, h]
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


# The fleet tier's row map: stage 2 reads each batch row's clusters in
# place from a row of a larger stack.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", ["none", "int8+kv", "fp8+kv"])
@pytest.mark.parametrize("G,D,Hkv", [(4, 128, 2), (12, 128, 2),
                                     (128, 576, 1)])
def test_card_block_gather_row_map(cuda, dtype, spec, G, D, Hkv):
  """A random map of 4 batch rows into a stack of 12 shard rows (repeats
  included), on every branch the fleet reaches (the unquantized cache and
  the int8 / fp8 ``has_kq`` cache; the decode core and, at D = 576, the
  latent core): against the plain version on the same map, and bit for
  bit the launch on the rows copied out without a map."""
  g = torch.Generator().manual_seed(95 + G)
  Bq, P, C, M, I = 4, 12, 16, 8, 3
  latent = D in _build.LATENT_HEAD_DIMS
  q = _rand(g, Bq, Hkv * G, D)
  q = (q * (D ** -0.5) * 3.0) if latent else q.to(dtype)
  k, v = _rand(g, P, Hkv, M * C, D), _rand(g, P, Hkv, M * C, D)
  rows = torch.randint(0, P, (Bq,), generator=g, dtype=torch.int32)
  rows[1] = rows[0]
  sel = torch.stack([torch.stack([torch.randperm(M, generator=g)[:I]
                                  for _ in range(Hkv)]) for _ in range(Bq)])
  sel = sel.to(torch.int32)
  qc = qt.parse_qconfig(spec)
  kw = {}
  if qc.sorted_kv:
    k, ks = qt.quantize_rows(k, qc.kind, block=C)
    v, vs = qt.quantize_rows(v, qc.kind, block=C)
    kw.update(kv_k_scale=ks[rows.long()], kv_v_scale=vs[rows.long()])
  else:
    k, v = k.to(dtype), v.to(dtype)
  mine = qt.select_rows(k, rows.long()), qt.select_rows(v, rows.long())
  kf = mine[0].float() if not qc.sorted_kv else qt.dequantize_rows(
      mine[0], kw["kv_k_scale"], block=C)
  vf = mine[1].float() if not qc.sorted_kv else qt.dequantize_rows(
      mine[1], kw["kv_v_scale"], block=C)
  safe = sel.long()[..., None].expand(-1, -1, -1, D)
  kw["k_sel"] = torch.gather(kf.reshape(Bq, Hkv, M, C, D).mean(3), 2, safe)
  kw["v_sel"] = torch.gather(vf.reshape(Bq, Hkv, M, C, D).mean(3), 2, safe)
  kw["sel_bias"] = torch.full(sel.shape, float(np.log(C)))
  if not qc.sorted_kv:
    kw["k_sel"], kw["v_sel"] = (kw["k_sel"].to(dtype),
                                kw["v_sel"].to(dtype))
  ek, ev = _rand(g, Bq, Hkv, 129, D), _rand(g, Bq, Hkv, 129, D)
  kw.update(extras_k=ek.to(dtype), extras_v=ev.to(dtype),
            extras_bias=torch.zeros((Bq, 129)))
  dev = {n: t.to(cuda) for n, t in kw.items()}
  opts = dict(cluster_size=C, sm_scale=D ** -0.5, cap=30.0)
  args = (q.to(cuda), k.to(cuda), v.to(cuda), sel.to(cuda))
  kind = qc.kind if qc.sorted_kv else "none"
  key = _build.branch("block_gather_attention",
                      _build.latent_branch(kind) if latent else kind)
  if kind == "none" and not latent:
    key = _build.decode_branch("block_gather_attention", dtype, G)
  n0 = _build.LAUNCHES[key]
  got = block_gather_attention(*args, **opts, rows=rows.to(cuda), **dev)
  torch.cuda.synchronize()
  assert _build.LAUNCHES[key] == n0 + 1
  want = ref.fused_gather_attention_ref(*args, **opts, rows=rows.to(cuda),
                                        **dev)
  copied = block_gather_attention(args[0], mine[0].to(cuda),
                                  mine[1].to(cuda), args[3], **opts, **dev)
  for a, b, c in zip(got, want, copied):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])
    assert torch.equal(a, c)


# -- the engine's CUDA graphs -------------------------------------------------

ENGINE_PROMPT, ENGINE_NEW = 64, 4


def _card_or_skip():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the engine captures CUDA graphs")
  return torch.device("cuda")


def _smoke_engine(dev, quant="none", **kw):
  from repro_torch.configs.registry import get_config
  from repro_torch.launch.serve import apply_quant
  from repro_torch.serve.engine import EngineConfig, ServingEngine
  cfg = apply_quant(get_config("llama3-8b", smoke=True), quant)     # bf16
  ecfg = EngineConfig(n_slots=2, prompt_len=ENGINE_PROMPT,
                      max_new_tokens=ENGINE_NEW, **kw)
  return ServingEngine(cfg, ecfg, device=dev)


def _serve_a_trace(eng):
  from repro_torch.serve.engine import make_requests
  eng.run(make_requests([0.0, 1.0, 2.0], ENGINE_PROMPT, ENGINE_NEW,
                        eng.cfg.vocab, seed=5))


@pytest.fixture(scope="module", params=["none", "int8+kv"])
def card_engine(request):
  """A bf16 SMOKE engine (accuracytrader: every bucket captured) after a
  trace, so that its pool holds resident lanes."""
  eng = _smoke_engine(_card_or_skip(), request.param)
  _serve_a_trace(eng)
  return eng


def _step_outputs(eng):
  torch.cuda.synchronize()
  return {k: v.clone() for k, v in eng.step_out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 1, 2, 4])
def test_card_engine_step_graph_replays_its_eager_call(card_engine, budget):
  """Every bucket of the run has its captured graph; its replay writes the
  bits the same program writes when called eagerly on the same pool."""
  eng = card_engine
  assert eng.buckets == (0, 1, 2, 4)
  key = ("step", budget)
  assert key in eng.programs.graphs and "append" in eng.programs.graphs
  eng.programs.run(key)
  replayed = _step_outputs(eng)
  eng.programs.call_eager(key)
  eager = _step_outputs(eng)
  for name, t in replayed.items():
    assert torch.equal(t, eager[name]), name
  assert torch.isfinite(replayed["logits"]).all()


@pytest.mark.cuda
def test_card_engine_allocates_the_merge_tickets_before_capture(monkeypatch):
  """The decode kernels' merge tickets exist before the first capture:
  no kernel allocates them while a graph is being captured, so they never
  land in the graphs' pool."""
  dev = _card_or_skip()
  calls = []
  take = _build.tickets

  def spy(device, n):
    before = _build._tickets.get(device)
    t = take(device, n)
    calls.append((torch.cuda.is_current_stream_capturing(),
                  t is not before))
    return t

  monkeypatch.setattr(_build, "tickets", spy)
  monkeypatch.setattr(_build, "_tickets", {})
  eng = _smoke_engine(dev, policy="fixed", fixed_budget=2)
  assert [alloc for _, alloc in calls].count(True) == 1
  assert calls[0] == (False, True)
  assert any(capturing for capturing, _ in calls)
  assert not any(capturing and alloc for capturing, alloc in calls)
  assert _build._tickets[eng.dev].numel() >= 2 * eng.cfg.n_heads


@pytest.mark.cuda
def test_card_engine_replays_after_the_merge_tickets_grow():
  """A graph bakes in the address of the tickets it was captured with:
  when a later caller needs more rows, the buffer is replaced but the old
  one stays alive, so the replay still merges right; it agrees with the
  eager call, which takes the new buffer.  Growing during a capture
  raises."""
  eng = _smoke_engine(_card_or_skip(), policy="fixed", fixed_budget=2)
  _serve_a_trace(eng)
  old = _build._tickets[eng.dev]
  n_old = old.numel()
  grown = _build.tickets(eng.dev, n_old + 1)
  assert grown.data_ptr() != old.data_ptr()
  del old
  torch.cuda.empty_cache()
  # the old buffer's size: where the allocator would hand out its memory
  # again had it been freed
  junk = torch.full((n_old,), 7, dtype=torch.int32, device=eng.dev)
  eng.programs.run(("step", 2))
  replayed = _step_outputs(eng)
  eng.programs.call_eager(("step", 2))
  eager = _step_outputs(eng)
  for name, t in replayed.items():
    assert torch.equal(t, eager[name]), name
  del junk
  x = torch.zeros(1, device=eng.dev)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    x.add_(1)
    with pytest.raises(RuntimeError, match="capture"):
      _build.tickets(eng.dev, grown.numel() + 1)
  assert _build._tickets[eng.dev] is grown


@pytest.mark.cuda
def test_card_engine_replays_on_the_zeroed_pool_after_reset():
  """reset() zeroes the pool in place: the same tensors, now zero, and a
  replay after it gives what the step gives on a fresh zero pool (before
  the reset it gave something else: the graph reads the live pool)."""
  from repro_torch.serve import kv_cache as kvc
  from repro_torch.serve.serve_step import make_serve_step
  eng = _smoke_engine(_card_or_skip(), policy="fixed", fixed_budget=1)
  ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
  _serve_a_trace(eng)
  eng.programs.run(("step", 1))
  busy = _step_outputs(eng)["logits"]
  eng.reset()
  assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
  assert not any(bool(v.view(torch.uint8).any()) for v in eng.cache.values())
  eng.programs.run(("step", 1))
  got = _step_outputs(eng)
  fresh = kvc.zeros_cache(eng.cfg, 2, ENGINE_PROMPT, synopsis=True,
                          device=eng.dev)
  logits, st = make_serve_step(eng.cfg, i_max=1)(eng.params, fresh,
                                                 torch.zeros_like(eng.tok))
  assert torch.equal(got["logits"], logits)
  assert torch.equal(got["k_delta"], st["k_delta"])
  assert not torch.equal(busy, logits)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", [dict(policy="fixed", fixed_budget=1),
                                 dict(policy="basic")],
                         ids=["fixed1", "basic"])
def test_card_engine_generates_the_cpu_engine_ids(arm):
  """SMOKE in f32 (tf32 off): the engine on the card (graphs, kernels) and
  on the CPU (eager, plain versions) generate the same ids."""
  import dataclasses
  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  dev = _card_or_skip()
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  ids = {}
  for where in ("cpu", dev):
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=2, prompt_len=ENGINE_PROMPT, max_new_tokens=ENGINE_NEW,
        **arm), params=_tree_to(params, where), device=where)
    reqs = make_requests([0.0, 1.0, 2.0, 3.0], ENGINE_PROMPT, ENGINE_NEW,
                         cfg.vocab, seed=9)
    eng.run(reqs)
    ids[str(where)] = [r.tokens for r in reqs]
  assert ids["cuda"] == ids["cpu"]


def _tree_to(tree, dev):
  return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
          for k, v in tree.items()}


def _check_loop_on_card(arch, mode, quant="none"):
  """The arch's SMOKE loop in f32 (tf32 off), prompt 64, 18 steps (one
  absorb in synopsis mode), on the card (kernels) and on the CPU (plain
  versions): the same ids, and every step's logits within the larger of
  1e-4 and four times the CPU's f32 loop's distance from float64, of
  max|logits| (``parity.loop_parity``).  The card launches flash_prefill
  once an attention layer (twice with a cross block: its causal branch;
  a mamba layer launches nothing), flash_decode twice a step on each
  attention layer that decodes exactly (every one in exact mode, the
  local ones in synopsis mode) and once a step on each cross block, and
  stage 1 on the quant spec's branch; under MLA (deepseek) the decode
  kernels' "latent" branches, and their other branches not at all."""
  dev = _card_or_skip()
  cfg = parity.smoke_f32(arch)[0]
  launched, _, _ = parity.loop_parity(arch, dev, mode, quant)
  attn = [s for s in cfg.block_pattern if s.kind == "attn"]
  n_attn = len(attn) * cfg.n_blocks
  exact = n_attn if mode == "exact" else sum(
      s.local for s in attn) * cfg.n_blocks
  cross = sum(s.cross_attn for s in cfg.block_pattern) * cfg.n_blocks
  branch = _build.LATENT if cfg.mla is not None else None
  qc = qt.parse_qconfig(quant)
  assert launched["flash_prefill"] == n_attn + cross
  assert launched[_build.branch("flash_decode", branch or "none")] == (
      2 * exact + cross) * 18
  if mode == "synopsis":
    n_glob = n_attn - sum(s.local for s in attn) * cfg.n_blocks
    s1 = _build.latent_branch(qc.kind) if branch else qc.kind
    s2 = qc.kind if qc.sorted_kv else "none"
    s2 = _build.latent_branch(s2) if branch else s2
    assert launched[_build.branch("fused_synopsis_score_attention", s1)] \
        == n_glob * 18
    assert launched[_build.branch("block_gather_attention", s2)] \
        == n_glob * 18
  if branch is not None:
    assert not any(n for k, n in launched.items()
                   if k != "flash_prefill"
                   and not k.startswith("segment_build")
                   and "[latent" not in k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_gemma2_loop_equals_the_cpu(mode):
  """gemma2-2b: the softcap and window branches, flash_decode on the
  local layers' window views."""
  _check_loop_on_card("gemma2-2b", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_card_gemma2_table_quant_loop_equals_the_cpu(quant):
  """gemma2-2b under int8 / fp8 (tables only): stage 1 on the quantized
  tables with cap 50, the local layers' flash_decode on the unquantized
  sorted cache."""
  _check_loop_on_card("gemma2-2b", "synopsis", quant)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_smollm_loop_equals_the_cpu(mode):
  _check_loop_on_card("smollm-135m", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_pixtral_loop_equals_the_cpu(mode):
  _check_loop_on_card("pixtral-12b", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,quant", [("synopsis", "none"),
                                        ("exact", "none"),
                                        ("synopsis", "int8+kv")])
def test_card_whisper_loop_equals_the_cpu(mode, quant):
  """whisper-medium: G = 1 at D = 32 through every kernel, the causal
  "cross" prefill and each step's cross flash_decode over the prompt's
  cross rows."""
  _check_loop_on_card("whisper-medium", mode, quant)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "command-r-plus-104b"])
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_arctic_command_r_loop_equals_the_cpu(arch, mode):
  """arctic-480b (the MoE with a dense MLP beside it, capacity 1 at
  decode) and command-r-plus-104b (parallel blocks, G = 4 at SMOKE)."""
  _check_loop_on_card(arch, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_deepseek_loop_equals_the_cpu(mode):
  """deepseek-v2-236b: MLA's prefill through flash_prefill at D = 48 (f32)
  and its absorbed decode on the latent core (an f32 query of 4 heads
  over one latent head of 48), the MoE with a shared expert."""
  _check_loop_on_card("deepseek-v2-236b", mode)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "fp8", "int8+kv", "fp8+kv"])
def test_card_deepseek_quant_loop_equals_the_cpu(quant):
  """deepseek-v2-236b under every quant spec: stage 1 on the latent core's
  quantized tables, stage 2 on its quantized cache under ``+kv`` (else the
  unquantized one with f32 decrement rows), the absorb's fresh codes;
  the same ids as the CPU and every step's logits within the parity
  bound."""
  _check_loop_on_card("deepseek-v2-236b", "synopsis", quant)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_card_jamba_loop_equals_the_cpu(mode):
  """jamba-v0.1-52b: the kernels on its one attention layer a block, the
  SSD mixer and the MoE FFN (capacity 1 at decode) in plain torch on both
  devices."""
  _check_loop_on_card("jamba-v0.1-52b", mode)


@pytest.mark.cuda
def test_card_mamba2_loop_equals_the_cpu():
  """mamba2-370m: no attention, so the loop runs exact and the card
  launches none of the six kernels."""
  dev = _card_or_skip()
  launched, _, _ = parity.loop_parity("mamba2-370m", dev, "exact")
  assert not any(launched.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_prefill", "segment_build",
                                    "fused_synopsis", "block_gather",
                                    "flash_decode", "synopsis_score"])
def test_card_kernels_at_jamba_shapes(cuda, kernel):
  """jamba-v0.1-52b's attention layer in bf16 (llama3-8b's heads: 32/8 of
  128, G = 4), B = 2, prompt 8192, at the 16-layer cut the card runs: the
  prefill; the build of the 2 attention layers' 4 sequences into M = 64
  clusters; stage 1 on the 64 centroids; stage 2 at I 32, C 128 with the
  ring and self token (E = 129); exact decode over the 8192 rows; the
  unfused op's scores."""
  dtype = torch.bfloat16
  B, S, Hkv, G, D, C = 2, 8192, 8, 4, 128, 128
  sm = D ** -0.5
  g = torch.Generator().manual_seed(23)
  if kernel == "flash_prefill":
    q, k, v = _to(cuda, dtype, *_prefill_inputs((B, S, Hkv, G, D), seed=23))
    _close(flash_prefill(q, k, v, sm_scale=sm),
           ref.flash_prefill_ref(q, k, v, sm_scale=sm), BF16_OUT_TOL)
  elif kernel == "segment_build":
    k, v = _to(cuda, dtype, _rand(g, 4, Hkv, S, D), _rand(g, 4, Hkv, S, D))
    perm = torch.argsort(torch.rand((4, S), generator=g), -1).to(
        torch.int32).to(cuda)
    for a, b in zip(segment_build(k, v, perm, cluster_size=C),
                    ref.synopsis_build_ref(k, v, perm, cluster_size=C)):
      _close(a, b, BF16_OUT_TOL)
  elif kernel == "block_gather":
    _check_gather(cuda, dtype, *_gather_inputs(
        "padded", S, D=D, C=C, G=G, Hkv=Hkv, E=129, I=32, seed=23))
  else:
    q, k, v = _to(cuda, dtype, *_decode_inputs(g, S, D=D, B=B, Hkv=Hkv,
                                                G=G))
    M = S // C
    k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
    v_syn = v.float().reshape(B, Hkv, M, C, D).mean(3).to(dtype)
    if kernel == "flash_decode":
      got = flash_decode(q, k, v, sm_scale=sm)
      want = ref.flash_decode_ref(q, k, v, sm_scale=sm)
    elif kernel == "synopsis_score":
      got = (synopsis_score(q, k_syn, sm_scale=sm),)
      want = (ref.synopsis_score_ref(q, k_syn, sm_scale=sm),)
    else:
      cbias = ops.count_bias(torch.full((B, M), float(C), device=cuda))
      got = fused_synopsis_score_attention(q, k_syn, v_syn, cbias,
                                           sm_scale=sm)
      want = ref.fused_synopsis_score_attention_ref(q, k_syn, v_syn, cbias,
                                                    sm_scale=sm)
      got, want = (got[0], *got[1]), (want[0], *want[1])
    for a, b in zip(got, want):
      _close(a, b, TOL[dtype])


@pytest.mark.cuda
def test_card_pixtral_prefix_prefill_equals_the_cpu():
  """pixtral-12b SMOKE in f32: 8 patch embeddings and 56 tokens, the
  prefill on the card (flash_prefill over all 64 positions) and on the
  CPU: logits and the cache within 1e-4 of max (f32 sums in another
  order), pos 64."""
  from repro_torch.serve.prefill import make_prefill_step
  dev = _card_or_skip()
  cfg, params = parity.smoke_f32("pixtral-12b")
  g = torch.Generator().manual_seed(4)
  tokens = torch.randint(0, cfg.vocab, (2, 56), generator=g)
  patches = _rand(g, 2, cfg.frontend_tokens, cfg.frontend_dim)
  prefill = make_prefill_step(cfg)
  want = prefill(params, tokens, patches)
  n0 = _build.LAUNCHES["flash_prefill"]
  got = prefill(_tree_to(params, dev), tokens.to(dev), patches.to(dev))
  torch.cuda.synchronize()
  assert _build.LAUNCHES["flash_prefill"] == n0 + cfg.n_layers
  for a, b in ((got[0], want[0]), (got[1]["k"], want[1]["k"]),
               (got[1]["v"], want[1]["v"])):
    torch.testing.assert_close(a.cpu(), b, rtol=0,
                               atol=1e-4 * float(b.abs().max()))
  assert got[1]["pos"].tolist() == [64, 64]


def _check_engine_on_card(arch, arm):
  """The arch's SMOKE engine in f32 on the card (graphs, kernels) and on
  the CPU: the same ids, and each step's logits within 1e-4 of
  max|logits|."""
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        make_requests)
  dev = _card_or_skip()
  cfg, params = parity.smoke_f32(arch)
  ids, logs = {}, {}
  for where in ("cpu", dev):
    before = _build.launch_counts()
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=2, prompt_len=64, max_new_tokens=ENGINE_NEW,
        overlap_admission=False, **arm), params=_tree_to(params, where),
        device=where)
    if str(where) != "cpu" and any(s.local for s in cfg.block_pattern):
      assert _build.launch_counts()["flash_decode"] > before["flash_decode"]
    log = logs[str(where)] = []
    inner = eng._decode_step

    def step(active, *a, _eng=eng, _inner=inner, _log=log, **kw):
      _inner(active, *a, **kw)
      _log.append(_eng.step_out["logits"][list(active)].cpu())
    eng._decode_step = step
    reqs = make_requests([0.0, 1.0, 2.0, 3.0], 64, ENGINE_NEW, cfg.vocab,
                         seed=9)
    eng.run(reqs)
    ids[str(where)] = [r.tokens for r in reqs]
    del eng
  assert ids["cuda"] == ids["cpu"]
  assert len(logs["cuda"]) == len(logs["cpu"]) > 0
  for a, b in zip(logs["cuda"], logs["cpu"]):
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-4 * float(b.abs().max()))


ENGINE_ARMS = dict(argnames="arm", argvalues=[
    dict(policy="fixed", fixed_budget=1), dict(policy="basic")],
                   ids=["fixed1", "basic"])


@pytest.mark.cuda
@pytest.mark.parametrize(**ENGINE_ARMS)
def test_card_gemma2_engine_equals_the_cpu(arm):
  """gemma2-2b: the local layers' flash_decode is captured in each
  bucket's graph."""
  _check_engine_on_card("gemma2-2b", arm)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "pixtral-12b",
                                  "arctic-480b", "command-r-plus-104b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize(**ENGINE_ARMS)
def test_card_arch_engine_equals_the_cpu(arch, arm):
  _check_engine_on_card(arch, arm)


# -- the contracts' telemetry, the corpus cache and delta replay ---------------

@pytest.fixture(scope="module", params=["none", "int8+kv"])
def card_contract_engine(request):
  """A bf16 SMOKE engine under error_bounded (every bucket captured, with
  the coverage profile in each step) after a trace."""
  eng = _smoke_engine(_card_or_skip(), request.param,
                      contract="error_bounded", epsilon=0.02)
  _serve_a_trace(eng)
  return eng


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 1, 2, 4])
def test_card_engine_telemetry_graph_replays_its_eager_call(
    card_contract_engine, budget):
  """Every bucket's graph writes the coverage profile too; the replay's
  outputs, ``est_profile`` included, are the eager call's bits, and the
  profile is a profile (0 at b = 0, 1 at b = M, non-decreasing)."""
  eng = card_contract_engine
  key = ("step", budget)
  assert set(eng.programs.graphs) == {("step", b) for b in eng.buckets} | \
      {"append"}
  eng.programs.run(key)
  replayed = _step_outputs(eng)
  eng.programs.call_eager(key)
  eager = _step_outputs(eng)
  assert set(replayed) == {"logits", "k_delta", "v_delta", "pos",
                           "est_profile"}
  for name, t in replayed.items():
    assert torch.equal(t, eager[name]), name
  prof = replayed["est_profile"]
  assert tuple(prof.shape) == (2, eng.M + 1)
  assert torch.all(prof[:, 1:] >= prof[:, :-1] - 1e-6)
  assert torch.allclose(prof[:, 0], torch.zeros(2, device=prof.device))
  assert torch.allclose(prof[:, -1], torch.ones(2, device=prof.device),
                        atol=1e-5)


def _device_ops(fn, sessions=3):
  """Device ops one call of ``fn`` issues, from the profiler's rows: the
  most of ``sessions`` sessions (a session at times loses a row)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  counts = []
  for _ in range(sessions):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    counts.append(sum(e.count for e in prof.key_averages()
                      if e.device_type != torch.autograd.DeviceType.CPU
                      and e.self_device_time_total > 0))
  return max(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8+kv"])
def test_card_engine_deadline_graphs_issue_the_plain_ops(quant):
  """Under the deadline contract the step has no profile output; under a
  contract with telemetry every bucket's graph issues the same number of
  ops more than the deadline graph (the profile's cost does not depend on
  the budget).  ``chip_smoke.py`` holds the deadline graph's count at full
  width within a band of the count the engine has issued since before
  the contracts existed."""
  dev = _card_or_skip()
  engines = {c: _smoke_engine(dev, quant, contract=c)
             for c in ("deadline", "deadline_with_bound")}
  assert "est_profile" not in engines["deadline"].step_out
  extra = set()
  for b in engines["deadline"].buckets:
    ops_n = {}
    for c, eng in engines.items():
      key = ("step", b)
      if key not in eng.programs.graphs:
        eng.programs.capture(key)
      ops_n[c] = _device_ops(lambda: eng.programs.run(key))
    extra.add(ops_n["deadline_with_bound"] - ops_n["deadline"])
  assert len(extra) == 1 and extra.pop() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8+kv"])
def test_card_engine_hit_lane_equals_miss_lane(quant):
  """One corpus admitted into lane 0 (a miss: prefill, build, publish)
  and into lane 1 (a hit: the cached arena copied): the two lanes hold the
  same bits, and the hit ran neither prefill nor build."""
  from repro_torch.serve.corpus_cache import CacheConfig
  from repro_torch.serve.engine import make_requests
  eng = _smoke_engine(_card_or_skip(), quant, policy="fixed", fixed_budget=1,
                      cache=CacheConfig(capacity=2, delta_unit=16))
  reqs = make_requests([0.0, 0.0], ENGINE_PROMPT, ENGINE_NEW, eng.cfg.vocab,
                       seed=8)
  reqs[1].prompt = reqs[0].prompt
  eng._admit(reqs[0], 0)
  counts = _build.launch_counts()
  eng._admit(reqs[1], 1)
  assert _build.launch_counts() == counts          # no kernel launched
  assert eng.prefills == 1 and eng.corpus_cache.stats()["hits"] == 1
  for name, t in eng.cache.items():
    ax = eng._bx[name]
    assert torch.equal(t.narrow(ax, 0, 1), t.narrow(ax, 1, 1)), name
  assert int(eng.tok[0, 0]) == int(eng.tok[1, 0])
  assert reqs[0].tokens == reqs[1].tokens


def _rows_sorted(x, C):
  """(..., S, D) with S = M * C -> each cluster block's rows in one
  canonical order (by a random projection of the row), so that two builds
  whose clusters hold the same rows in another order compare equal."""
  *lead, S, D = x.shape
  blocks = x.reshape(*lead, S // C, C, D)
  vals = blocks.float() if x.element_size() > 1 else _steps(blocks).float()
  proj = vals.cpu() @ torch.linspace(1.0, 2.0, D, dtype=torch.float32)
  order = proj.argsort(dim=-1)[..., None].expand(*proj.shape, D)
  return torch.gather(blocks.cpu(), -2, order)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8+kv"])
def test_card_extend_synopsis_equals_the_cpu(quant):
  """The delta build on the card (PCA, kd, ``segment_build``) against the
  CPU's (plain versions) on the same arena and extension, bf16: the same
  clusters (counts equal, each cluster's rows bit-equal, or its codes
  bit-equal under +kv, in a canonical order), the prefix untouched,
  centroids within one bf16 ulp or one code step on few entries."""
  import dataclasses
  from repro_torch.configs.registry import get_config
  from repro_torch.launch.serve import apply_quant
  from repro_torch.serve import synopsis_kv as skv
  dev = _card_or_skip()
  cfg = apply_quant(get_config("llama3-8b", smoke=True), quant)
  cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
  C = cfg.synopsis.cluster_size
  g = torch.Generator().manual_seed(19)
  pre = {"k": _rand(g, 2, 1, 1, cfg.n_kv_heads, 2 * C, cfg.hd).bfloat16(),
         "v": _rand(g, 2, 1, 1, cfg.n_kv_heads, 2 * C, cfg.hd).bfloat16(),
         "pos": torch.full((1,), 2 * C, dtype=torch.int32)}
  ext = [_rand(g, 2, 1, 1, cfg.n_kv_heads, 4 * C, cfg.hd).bfloat16()
         for _ in range(2)]
  out = {}
  for where in ("cpu", dev):
    arena = skv.build({k: t.to(where) for k, t in pre.items()}, cfg)
    out[str(where)] = skv.extend_synopsis(arena, ext[0].to(where),
                                          ext[1].to(where), cfg)
  got, want = out["cuda"], out["cpu"]
  assert set(got) == set(want)
  assert torch.equal(got["counts"].cpu(), want["counts"])
  assert torch.equal(got["pos"].cpu(), want["pos"])
  for name in ("k", "v"):
    assert torch.equal(_rows_sorted(got[name], C), _rows_sorted(want[name], C))
  for name in ("k_scale", "v_scale"):
    if name in want:
      torch.testing.assert_close(got[name].cpu(), want[name],
                                 rtol=1e-5, atol=1e-7)
  for name in ("k_syn", "v_syn"):
    if got[name].element_size() == 1:
      step = (_steps(got[name]) - _steps(want[name])).abs()
      assert int(step.max()) <= 1, name
      assert float((step > 0).float().mean()) < 0.01, name
    else:
      _close(got[name], want[name], BF16_OUT_TOL)


# -- the scatter-gather cluster tier (stacked) ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_cluster_stages_over_folded_rows(cuda, dtype):
  """The tier's layout (B, N, Hkv, m_max*C, D) folds, without a copy, into
  B*N rows: stage 1 (with the padding slots masked by ``valid``) and stage
  2 over them are ONE launch each, against their plain versions on the
  CPU.  The components' shards here own 5, 3 and 2 of m_max = 5
  clusters."""
  B, N, Hkv, G, D, Mp, C = 2, 3, 2, 4, 128, 5, 16
  own = (5, 3, 2)
  g = torch.Generator().manual_seed(7)
  k = _rand(g, B, N, Hkv, Mp * C, D)
  v = _rand(g, B, N, Hkv, Mp * C, D)
  counts = torch.zeros(B, N, Mp)
  for c, n in enumerate(own):
    counts[:, c, :n] = float(C)
  k_syn = k.reshape(B, N, Hkv, Mp, C, D).mean(4)
  v_syn = v.reshape(B, N, Hkv, Mp, C, D).mean(4)
  q = _rand(g, B, Hkv * G, D)
  folded, out = {}, {}
  for where in ("cpu", cuda):
    t = {n: x.to(torch.float32 if n == "counts" else dtype).to(where)
         for n, x in dict(k=k, v=v, k_syn=k_syn, v_syn=v_syn, q=q,
                          counts=counts).items()}
    fold = {n: t[n].view(B * N, *t[n].shape[2:])
            for n in ("k", "v", "k_syn", "v_syn", "counts")}
    assert all(fold[n].data_ptr() == t[n].data_ptr() for n in fold)
    fold["q"] = t["q"][:, None].expand(B, N, *q.shape[1:]).reshape(
        B * N, *q.shape[1:])
    folded[str(where)] = fold
    before = _build.launch_counts()
    scores, p_syn = ops.synopsis_stage1(
        fold["q"], fold["k_syn"], fold["v_syn"], fold["counts"],
        sm_scale=D ** -0.5, valid=fold["counts"] > 0)
    if where != "cpu":
      assert _build.launch_counts()["fused_synopsis_score_attention"] \
          - before["fused_synopsis_score_attention"] == 1
    out[str(where)] = (scores, *p_syn)
  got, want = out["cuda"], out["cpu"]
  masked = want[0] <= NEG_INF / 2
  assert torch.equal(got[0].cpu() <= NEG_INF / 2, masked)
  assert int(masked.sum()) == B * Hkv * (3 * Mp - sum(own))
  _close(torch.where(masked, 0.0, got[0].cpu()),
         torch.where(masked, 0.0, want[0]), TOL[dtype])
  for a, b in zip(got[1:], want[1:]):
    _close(a, b, TOL[dtype])
  # Stage 2 over the shards, on one selection (the CPU's top 3, -1 on
  # padding slots).
  top = torch.topk(want[0], 3, dim=-1)
  sel = torch.where(top.values > NEG_INF / 2, top.indices, -1).to(
      torch.int32)
  assert bool((sel < 0).any())
  for where, fold in folded.items():
    before = _build.launch_counts()
    out[where] = ops.refine_stage2(
        fold["q"], fold["k"], fold["v"], sel.to(fold["k"].device),
        fold["k_syn"], fold["v_syn"], fold["counts"], cluster_size=C,
        sm_scale=D ** -0.5)
    if where != "cpu":
      assert _build.launch_counts()["block_gather_attention"] \
          - before["block_gather_attention"] == 1
  for a, b in zip(out["cuda"], out["cpu"]):
    _close(a, b, TOL[dtype])


def _cluster_engine(dev, **kw):
  from repro_torch.configs.registry import get_config
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import EngineConfig, ServingEngine
  cfg = get_config("llama3-8b", smoke=True)                   # bf16
  return ServingEngine(cfg, EngineConfig(
      n_slots=2, prompt_len=ENGINE_PROMPT, max_new_tokens=ENGINE_NEW, **kw),
      device=dev, backend=ClusterStepBackend(ClusterConfig(
          n_components=2, skew=1.2, replicas=2)))


@pytest.fixture(scope="module")
def card_cluster_engine():
  """A bf16 SMOKE cluster engine (accuracytrader: every bucket captured)
  after a trace, its gather modes set to FULL, STAGE1."""
  eng = _cluster_engine(_card_or_skip())
  _serve_a_trace(eng)
  eng.backend.load_mode(np.asarray([2, 1], np.int32))
  return eng


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 1, 2, 4])
def test_card_cluster_step_graph_replays_its_eager_call(card_cluster_engine,
                                                        budget):
  """Each bucket's cluster step graph writes the bits its eager call
  writes, the per-component telemetry included; the modes are read from
  the static buffer at replay (a mode changed after capture changes the
  replay's output)."""
  eng = card_cluster_engine
  key = ("step", budget)
  assert key in eng.programs.graphs
  eng.programs.run(key)
  replayed = _step_outputs(eng)
  eng.programs.call_eager(key)
  eager = _step_outputs(eng)
  assert {"fe_cover", "fe_mass"} <= set(replayed)
  for name, t in replayed.items():
    assert torch.equal(t, eager[name]), name
  if budget:
    eng.backend.load_mode(np.asarray([2, 2], np.int32))
    eng.programs.run(key)
    full = _step_outputs(eng)
    eng.backend.load_mode(np.asarray([2, 1], np.int32))
    assert not torch.equal(full["logits"], replayed["logits"])


@pytest.mark.cuda
@pytest.mark.parametrize(**ENGINE_ARMS)
def test_card_cluster_engine_equals_the_cpu(arm):
  """SMOKE f32, N = 4 at skew 1.2: the cluster engine's ids on the card
  (graphs, kernels) are the CPU's (eager, plain versions)."""
  import dataclasses

  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.cluster import ClusterConfig, ClusterStepBackend
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  dev = _card_or_skip()
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  ids = {}
  for where in ("cpu", dev):
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=2, prompt_len=128, max_new_tokens=ENGINE_NEW,
        deadline_ms=1e6, **arm), params=_tree_to(params, where),
        device=where, backend=ClusterStepBackend(ClusterConfig(
            n_components=4, skew=1.2)))
    run_open_loop(eng, 20.0, 0.3, seed=3)
    ids[str(where)] = [r.tokens for r in sorted(eng.completed,
                                                key=lambda r: r.rid)]
    del eng
  assert ids["cuda"] == ids["cpu"] and ids["cpu"]


@pytest.mark.cuda
def test_card_cluster_cli_exits_0(capsys):
  """The tier's command line on the card: a crash, replicas, the
  ``[cluster]`` and ``[faults]`` lines and the measured per-component
  times."""
  from repro_torch.launch import serve
  _card_or_skip()
  out = serve.main(["--cluster", "2", "--faults", "crash=1@2",
                    "--replicas", "2", "--duration", "1", "--trace",
                    "sogou_hourly", "--hours", "21", "--rate-scale", "0.2"])
  text = capsys.readouterr().out
  assert "[cluster] N=2 (stacked" in text and "  [faults] {" in text
  assert len(out["cluster"]["comp_ms_full"]) == 2
  assert out["results"]["hour21"]["n"] > 0


# -- the fleet tier (stacked) ---------------------------------------------------

def _fleet_engine(dev, **kw):
  from repro_torch.configs.registry import get_config
  from repro_torch.serve.engine import EngineConfig, ServingEngine
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  cfg = get_config("llama3-8b", smoke=True)                   # bf16
  return ServingEngine(cfg, EngineConfig(
      n_slots=2, prompt_len=ENGINE_PROMPT, max_new_tokens=ENGINE_NEW, **kw),
      device=dev, backend=FleetStepBackend(FleetConfig(
          n_components=2, skew=1.2, replicas=2)))


@pytest.fixture(scope="module")
def card_fleet_engine():
  """A bf16 SMOKE fleet engine (accuracytrader: every bucket captured)
  after a trace, its frontend vector set to FULL / STAGE1 read from the
  primaries."""
  eng = _fleet_engine(_card_or_skip())
  _serve_a_trace(eng)
  eng.backend.load_mode(np.asarray([[2, 1], [0, 0]], np.int32))
  return eng


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 1, 2, 4])
def test_card_fleet_step_graph_replays_its_eager_call(card_fleet_engine,
                                                      budget):
  """Each bucket's fleet step graph writes the bits its eager call writes;
  the selection is read from the static buffer at replay and, every copy
  being bit-identical, leaves every output as it was."""
  eng = card_fleet_engine
  key = ("step", budget)
  assert key in eng.programs.graphs
  assert eng.cache["k"].shape[3:5] == (2, 2)          # (R, N) after B
  eng.programs.run(key)
  replayed = _step_outputs(eng)
  eng.programs.call_eager(key)
  eager = _step_outputs(eng)
  for name, t in replayed.items():
    assert torch.equal(t, eager[name]), name
  for sel in ([1, 0], [0, 1], [1, 1]):
    eng.backend.load_mode(np.asarray([[2, 1], sel], np.int32))
    eng.programs.run(key)
    moved = _step_outputs(eng)
    for name, t in replayed.items():
      assert torch.equal(t, moved[name]), (sel, name)
  eng.backend.load_mode(np.asarray([[2, 1], [0, 0]], np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize(**ENGINE_ARMS)
def test_card_fleet_engine_equals_the_cpu(arm):
  """SMOKE f32, N = 4, R = 2 at skew 1.2: the fleet engine's ids on the
  card (graphs, kernels, the row map) are the CPU's (eager, plain
  versions)."""
  import dataclasses

  from repro_torch.configs.registry import get_config
  from repro_torch.models import transformer as tf
  from repro_torch.serve.engine import (EngineConfig, ServingEngine,
                                        run_open_loop)
  from repro_torch.serve.fleet import FleetConfig, FleetStepBackend
  dev = _card_or_skip()
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  params = tf.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
  ids = {}
  for where in ("cpu", dev):
    eng = ServingEngine(cfg, EngineConfig(
        n_slots=2, prompt_len=128, max_new_tokens=ENGINE_NEW,
        deadline_ms=1e6, **arm), params=_tree_to(params, where),
        device=where, backend=FleetStepBackend(FleetConfig(
            n_components=4, skew=1.2, replicas=2)))
    run_open_loop(eng, 20.0, 0.3, seed=3)
    ids[str(where)] = [r.tokens for r in sorted(eng.completed,
                                                key=lambda r: r.rid)]
    del eng
  assert ids["cuda"] == ids["cpu"] and ids["cpu"]


# -- the generic-data Algorithm 1, its services, and training ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_morton_segment_build_equals_plain(cuda, dtype):
  """A Morton permutation (``synopsis_kv.cluster_perms(method="morton")``)
  on the card, then ``segment_build`` against its plain version on it:
  rows bit-equal, counts equal, centroids as the kernel tolerances."""
  from repro_torch.serve import synopsis_kv as skv
  g = torch.Generator().manual_seed(23)
  k = _rand(g, 4, 2, 256, 16).to(cuda, dtype)
  v = _rand(g, 4, 2, 256, 16).to(cuda, dtype)
  perm = skv.cluster_perms(k, 16, method="morton")
  got = segment_build(k, v, perm.to(torch.int32), cluster_size=16)
  want = ref.synopsis_build_ref(k, v, perm, cluster_size=16)
  for i in (0, 1, 4):
    assert torch.equal(got[i], want[i])
  tol = TOL[dtype] if dtype == torch.float32 else BF16_OUT_TOL
  for i in (2, 3):
    _close(got[i], want[i], tol)


def _on_card(obj, dev):
  """A CPU app object's copy on the card with the same synopsis."""
  out = type(obj).__new__(type(obj))
  out.__dict__.update({k: (t.to(dev) if isinstance(t, torch.Tensor) else t)
                       for k, t in obj.__dict__.items() if k != "syn"})
  out.syn = obj.syn.to(dev)
  return out


@pytest.mark.cuda
def test_card_apps_equal_the_cpu(cuda):
  """The recommender and the search engine on the card against the CPU,
  on the same synopsis: ``predict`` within 1e-5 of max|ref| at every
  budget and exact; the same top-10 ids at every budget and exact."""
  from repro_torch.serving import apps
  r, m = apps.movielens_like(512, 300, density=0.3, seed=1)
  cpu = apps.CFRecommender(r, m, num_clusters=16)
  card = _on_card(cpu, cuda)
  for uid in (3, 7, 100):
    qm = m[uid].clone()
    qm[torch.nonzero(qm)[:10, 0]] = 0.0
    q = r[uid] * qm
    items = torch.arange(0, 300, 7)
    for b in (None, 0, 1, 4, 16):
      want = (cpu.predict_exact(q, qm, items) if b is None
              else cpu.predict(q, qm, items, b))
      got = (card.predict_exact(q.to(cuda), qm.to(cuda), items.to(cuda))
             if b is None else card.predict(q.to(cuda), qm.to(cuda),
                                            items.to(cuda), b))
      torch.testing.assert_close(got.cpu(), want, rtol=0,
                                 atol=1e-5 * float(want.abs().max()))
  docs = apps.webpages_like(1024, 256, seed=2)
  cpu = apps.SearchEngine(docs, num_clusters=32)
  card = _on_card(cpu, cuda)
  g = torch.Generator().manual_seed(4)
  for i in range(6):
    qv = docs[i * 37] + 0.05 * torch.randn(256, generator=g)
    assert torch.equal(card.search_exact(qv.to(cuda)).cpu(),
                       cpu.search_exact(qv))
    for b in (0, 1, 2, 8, 32):
      assert torch.equal(card.search(qv.to(cuda), b).cpu(),
                         cpu.search(qv, b))


@pytest.mark.cuda
def test_card_train_step_grads_equal_the_cpu(cuda):
  """One f32 step of smollm's SMOKE config on the card against the CPU:
  the loss within 1e-5, every gradient within 4 times the CPU f32 step's
  distance from its float64 step (1e-4 of max|ref| at least), and every
  gradient finite and non-zero on the card (the training forward takes
  the differentiable attention, launching no kernel)."""
  import dataclasses
  from repro_torch.configs.registry import get_config
  from repro_torch.models.common import leaves
  from repro_torch.train.data import DataConfig, TokenStream
  from repro_torch.train.optimizer import OptConfig, tree_map
  from repro_torch.train.train_step import init_train_state, loss_and_grads
  cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                            dtype=torch.float32)
  state = init_train_state(cfg, OptConfig(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
  tokens, labels = TokenStream(DataConfig(cfg.vocab, 128, 2)).batch_at(0)
  out = {}
  _build.reset_launches()
  for name, where, dt in (("cpu", "cpu", torch.float32),
                          ("card", cuda, torch.float32),
                          ("f64", "cpu", torch.float64)):
    c = dataclasses.replace(cfg, dtype=dt)
    loss, _, g = loss_and_grads(
        c, tree_map(lambda t: t.to(where, dt), state["params"]),
        {"tokens": torch.from_numpy(tokens).to(where),
         "labels": torch.from_numpy(labels).to(where)})
    out[name] = (float(loss), {p: x.double().cpu() for p, x in leaves(g)})
  assert not any(_build.launch_counts().values())

  def dist(a, b):
    return max(float((a[1][p] - b[1][p]).abs().max() / b[1][p].abs().max())
               for p in b[1])
  bound = max(4 * dist(out["cpu"], out["f64"]), 1e-4)
  assert dist(out["card"], out["cpu"]) <= bound
  assert abs(out["card"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
  for p, x in out["card"][1].items():
    assert bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0, p


def test_sharded_synopsis_on_ranks_sharing_the_card(cuda):
  """Four gloo ranks on the one card (``dist.world.run_world``), each on
  its quarter of the sequence: the sharded synopsis attention's kernels
  against the one-rank kernels on the global cache (f32), stage 1 and
  stage 2 launched once on every rank.  The kernels are built here, before
  any rank starts."""
  import torch_mesh_ranks
  from repro_torch.dist import world
  _build.build()
  res = world.run_world(torch_mesh_ranks.card_synopsis_world, 4, (3,),
                        device="cuda", timeout_s=120.0)
  for r in res:
    assert r["err_one_rank"] <= 1e-4 + 1e-4 * r["scale"], r
    assert r["launches"] == {"fused_synopsis_score_attention": 1,
                             "block_gather_attention": 1}, r


def test_sharded_exact_on_ranks_sharing_the_card(cuda):
  """Four gloo ranks on the one card, each on its quarter of a 1024-row
  exact cache: the sharded exact decode against the one-rank kernel on the
  global cache (f32), whole and with a 384-row window that crosses from
  shard 2 into shard 3 and leaves shards 0 and 1 empty; ``flash_decode``
  launched once on each rank's rows it holds, and once more for the self
  token on shard 0."""
  import torch_mesh_ranks
  from repro_torch.dist import world
  _build.build()
  res = world.run_world(torch_mesh_ranks.card_exact_world, 4, (5,),
                        device="cuda", timeout_s=120.0)
  for r in res:
    for window, c in r["cases"].items():
      assert c["err_one_rank"] <= 1e-4 + 1e-4 * c["scale"], (r["rank"], c)
      holds = window is None or r["rank"] >= 2
      want = int(holds) + (r["rank"] == 0)
      assert c["launches"] == want, (r["rank"], window, c)


def _wrapper_calls(dev):
  """Every kernel wrapper's calls, on ``dev``, as the ops layer makes
  them at small shapes: prefill (f32, bf16), each quant spec's build,
  fused decode and stage 2, the unfused op, exact decode over a window's
  strided view (bf16 also at G = 12: the tensor-core stream), and the
  latent core's kernels (f32 and an int8+kv arena)."""
  names = ("flash_prefill", "segment_build",
           "fused_synopsis_score_attention", "block_gather_attention",
           "flash_decode", "synopsis_score")
  calls = []
  mp = pytest.MonkeyPatch()
  for name in names:
    fn = getattr(ops, name)
    mp.setattr(ops, name, (lambda n, f: lambda *a, **kw: (
        calls.append((n, f, a, kw)), f(*a, **kw))[1])(name, fn))
  g = torch.Generator(dev).manual_seed(0)
  B, C, M, R = 2, 16, 8, 5
  S = M * C
  try:
    for D, Hkv, G, dt, specs in (
        (64, 2, 4, torch.float32, ("none", "int8", "fp8", "int8+kv",
                                   "fp8+kv")),
        (64, 2, 4, torch.bfloat16, ("none",)),
        (64, 1, 12, torch.bfloat16, ("none",)),
        (48, 1, 8, torch.float32, ("none", "int8+kv"))):
      H = Hkv * G

      def rnd(*shape, dtype=dt):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
      if D != 48:
        ops.prefill_attention(rnd(B, S, H, D), rnd(B, S, Hkv, D),
                              rnd(B, S, Hkv, D), sm_scale=0.3)
      for spec in specs:
        k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        perm = torch.stack([torch.randperm(S, device=dev)
                            for _ in range(B)])
        built = ops.synopsis_build(k, v, perm, cluster_size=C,
                                   qconfig=None if spec == "none" else spec)
        if spec == "none":
          built = dict(zip(("k", "v", "k_syn", "v_syn", "counts"), built))
        q = rnd(B, H, D, dtype=torch.float32 if D == 48 else dt)
        ops.synopsis_cache_attention(
            q, built["k"], built["v"], built["k_syn"], built["v_syn"],
            built["counts"], rnd(B, Hkv, R, D), rnd(B, Hkv, R, D),
            torch.tensor([3, 5], device=dev), rnd(B, Hkv, 1, D),
            rnd(B, Hkv, 1, D), *(built.get(n) for n in qt.SCALE_LEAVES),
            i_max=3, cluster_size=C, sm_scale=0.25)
        if spec == "none":
          ops.synopsis_attention(q, built["k"], built["v"], built["k_syn"],
                                 built["v_syn"], built["counts"], i_max=3,
                                 sm_scale=0.25)
          ops.decode_partials(q, k[:, :, -40:], v[:, :, -40:],
                              sm_scale=0.25)
  finally:
    mp.undo()
  return calls


def _meta_copy(x):
  if isinstance(x, torch.Tensor):
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")
  if isinstance(x, (tuple, list)):
    return type(x)(_meta_copy(t) for t in x)
  if isinstance(x, dict):
    return {k: _meta_copy(v) for k, v in x.items()}
  return x


def test_meta_allocation_equals_the_cuda_call(cuda):
  """Each wrapper's call on ``meta`` (traced by ``MemoryTracker``)
  allocates the bytes its CUDA call allocates: ``max_memory_allocated`` -
  ``memory_allocated`` around one call, after a warm-up call on each
  device (the merge tickets are made once a device).  A strided view keeps
  its strides on ``meta``."""
  from repro_torch.analysis.tracker import MemoryTracker
  calls = _wrapper_calls(cuda)
  assert {c[0] for c in calls} == {
      "flash_prefill", "segment_build", "fused_synopsis_score_attention",
      "block_gather_attention", "flash_decode", "synopsis_score"}
  for name, fn, args, kw in calls:
    margs, mkw = _meta_copy(args), _meta_copy(kw)
    fn(*args, **kw)
    fn(*margs, **mkw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base
    del out
    with MemoryTracker((margs, mkw)) as trk:
      mout = fn(*margs, **mkw)
      trk.finish(mout)
    assert trk.peak_bytes == card, (name, [getattr(a, "shape", a)
                                           for a in args], trk.peak_bytes,
                                    card)


@pytest.mark.cuda
def test_cut_weights_on_the_card(cuda):
  """Weights cut by SERVE_RULES on 4 ranks sharing the card (SMOKE, f32):
  llama3-8b (2 heads a rank of a group of 4) and deepseek-v2 (MLA, one
  head a rank, its experts over `model`): prefill and a synopsis and an
  exact step within 1e-4 of max|ref| of the one-rank calls on the whole
  weights, every rank launching the kernels of its cut path."""
  del cuda
  import torch_mesh_ranks
  from repro_torch.dist import world
  _build.build()
  res = world.run_world(torch_mesh_ranks.card_tp_world, 4,
                        (("llama3-8b", "deepseek-v2-236b"),),
                        device="cuda", timeout_s=180.0)
  for r in res:
    for arch, c in r["cases"].items():
      for key in ("prefill", "synopsis", "exact"):
        err, scale = c[key]
        assert err <= 1e-4 * scale, (r["rank"], arch, key, c)
      launched = {k.split("[")[0] for k in c["launches"]}
      assert {"flash_prefill", "segment_build",
              "fused_synopsis_score_attention", "block_gather_attention",
              "flash_decode"} <= launched, (arch, c["launches"])


@pytest.mark.cuda
def test_cut_train_step_on_the_card(cuda):
  """A train step on a state cut by TRAIN_RULES on 2 ranks sharing the
  card (SMOKE, f32): llama3-8b and deepseek-v2 (MLA, MoE) on a (model 2)
  mesh (tensor-parallel) and a (data 2) mesh (FSDP).  On CUDA autograd
  runs the backward, and each checkpointed layer's recompute, on a thread
  of its own where no mesh is installed: the collectives' backwards keep
  their mesh from the forward and the recompute runs under the mesh it
  first ran under.  The assembled gradients and loss within 1e-4 of
  max|ref| of the one-rank step (f32: sums in another order), the
  parameters after the step within 1e-6 of the one-rank AdamW on the
  assembled gradients; no kernel launched."""
  del cuda
  import torch_mesh_ranks
  from repro_torch.dist import world
  _build.build()
  res = world.run_world(torch_mesh_ranks.card_train_world, 2,
                        (("llama3-8b", "deepseek-v2-236b"),),
                        device="cuda", timeout_s=300.0)
  for r in res:
    assert len(r["cases"]) == 4
    for key, c in r["cases"].items():
      assert c["loss"] <= 1e-4 and c["grads"] <= 1e-4, (r["rank"], key, c)
      assert c["params"] <= 1e-6, (r["rank"], key, c)
      assert not c["launched"], (key, c["launched"])

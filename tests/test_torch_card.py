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
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build

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


def _gather_inputs(case, S, D=128, seed=3, E=144):
  """Stage-2 inputs shaped as the serve step builds them: centroids are
  cluster means, the decrement bias is log(count), extras are a 128-row
  ring (100 valid) plus self-KV: E = 129 as the port builds them, or
  padded to 144 with masked rows as the JAX package does."""
  B, Hkv, G, C = 2, 2, 4, 16
  M = S // C
  g = torch.Generator().manual_seed(seed)
  q = _rand(g, B, Hkv * G, D)
  k, v = _rand(g, B, Hkv, S, D), _rand(g, B, Hkv, S, D)
  if case == "all_padded":
    sel = torch.full((B, Hkv, 1), -1, dtype=torch.int32)
  else:
    sel = torch.stack([torch.stack([torch.randperm(M, generator=g)[:3]
                                    for _ in range(Hkv)]) for _ in range(B)])
    sel = sel.to(torch.int32)
    if case == "padded":
      sel[0, 0, 1] = -1
      sel[1, :, 2] = -1
  kw = {}
  if case != "plain":
    k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
    v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
    safe = sel.long().clamp_min(0)[..., None].expand(-1, -1, -1, D)
    kw["k_sel"] = torch.gather(k_syn, 2, safe)
    kw["v_sel"] = torch.gather(v_syn, 2, safe)
    kw["sel_bias"] = torch.full(sel.shape, float(np.log(C)))
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
  assert _build.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,window,cap", [
    ((1, 128, 1, 1, 64), None, None),
    ((2, 300, 2, 4, 128), None, None),      # ragged last query tile
    ((2, 192, 2, 8, 32), 40, 30.0),
    ((1, 100, 2, 2, 16), None, 30.0),
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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("perm_kind", ["clustered", "identity"])
def test_card_segment_build(cuda, dtype, perm_kind):
  N, Hkv, S, D, C = 3, 2, 256, 128, 128
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
@pytest.mark.parametrize("M", [64, 65])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_card_fused_synopsis(cuda, dtype, M, cap):
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
@pytest.mark.parametrize("case", ["plain", "dec_extras", "padded",
                                  "all_padded"])
@pytest.mark.parametrize("S", [128, 144])
@pytest.mark.parametrize("E", [129, 144])
def test_card_block_gather(cuda, dtype, case, S, E):
  q, k, v, sel, C, kw = _gather_inputs(case, S, E=E)
  args = _to(cuda, dtype, q, k, v)
  kwc = {n: (t.to(cuda) if n in ("sel_bias", "extras_bias")
             else t.to(device=cuda, dtype=dtype)) for n, t in kw.items()}
  opts = dict(cluster_size=C, sm_scale=q.shape[-1] ** -0.5, cap=30.0)
  got = block_gather_attention(*args, sel.to(cuda), **opts, **kwc)
  want = ref.fused_gather_attention_ref(*args, sel.to(cuda), **opts, **kwc)
  for a, b in zip(got, want):
    assert torch.isfinite(a).all()
    _close(a, b, TOL[dtype])


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
  _close(got, ref.exact_decode_ref(q, keys, vals, sm_scale=D ** -0.5),
         TOL[torch.float32])

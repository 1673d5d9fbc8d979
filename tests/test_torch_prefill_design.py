"""The arithmetic of the bf16 ``flash_prefill`` kernel
(``csrc/flash_prefill.cu``), emulated in torch on the CPU and held against
the f32 plain version.

The kernel runs only on the card; this keeps its numerical design
checkable without one.  The emulation does what the kernel does, tile by
tile: S = Q.K^T on bf16 inputs summed in f32 (the products are exact), the
logits in log2 units, an online softmax over tiles of 128 keys (64 at D =
256, as the kernel's tile there) with the finite -1e30 sentinel, P split into two bf16 values P_hi + P_lo, and two
products of them with the bf16 V tile accumulated in f32; the output is
O / l rounded to bf16.

The tolerance is the card's for a bf16 output (``BF16_OUT_TOL`` of
``chip_smoke.py``): 1e-4 + 2^-7 |x|.  Measured margins (largest
|err| / (1e-4 + 2^-7 |want|) over a case; below 1 passes), on the cases
below: with the split 0.009-0.93, the larger ones where the kernel's and
the reference's f32 results round to neighbouring bf16 values (one ulp is
at most 2^-7 |x|, so such a flip stays below 1); with P rounded to one
bf16 (as SDPA does) 9.6-12.4 on random V, whose smallest outputs are
~1e-4, and 4.2-5.5 on the cancelling rows.  Without the split the check
fails on every case.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

BF16_OUT_TOL = (1e-4, 2.0 ** -7)     # (atol, rtol), as chip_smoke.py
BN = {256: 64}                       # keys a tile by D, as the kernel
LOG2E = 1.4426950408889634
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def emulate(q, k, v, *, sm_scale, cap=None, window=None, split=True):
  """The kernel's arithmetic on bf16 (B, S, H, D) / (B, S, Hkv, D) inputs;
  returns bf16 (B, S, H, D)."""
  B, S, H, D = q.shape
  Hkv = k.shape[2]
  G = H // Hkv
  bn = BN.get(D, 128)
  out = torch.empty_like(q)
  scale_log2 = np.float32(sm_scale) * np.float32(LOG2E)
  qpos = torch.arange(S).repeat_interleave(G)            # row r = (s, g)
  for b in range(B):
    for h in range(Hkv):
      rows = q[b, :, h * G:(h + 1) * G].float().reshape(S * G, D)
      m = torch.full((S * G,), NEG_INF)
      l = torch.zeros(S * G)
      o = torch.zeros(S * G, D)
      for k0 in range(0, S, bn):
        kt = k[b, k0:k0 + bn, h].float()
        vt = v[b, k0:k0 + bn, h].float()
        s = rows @ kt.T
        if cap is not None:
          x = cap * torch.tanh(s * sm_scale / cap) * LOG2E
        else:
          x = s * float(scale_log2)
        kpos = torch.arange(k0, k0 + kt.shape[0])
        ok = kpos[None, :] <= qpos[:, None]
        if window is not None:
          ok &= (qpos[:, None] - kpos[None, :]) < window
        x = torch.where(ok, x, torch.full_like(x, NEG_INF))
        mx = torch.maximum(m, x.max(dim=1).values)
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[:, None])
        l = l * alpha + p.sum(dim=1)
        hi = p.to(torch.bfloat16).float()
        if split:
          lo = (p - hi).to(torch.bfloat16).float()
          pv = hi @ vt + lo @ vt
        else:
          pv = hi @ vt
        o = o * alpha[:, None] + pv
        m = mx
      o = o / l.clamp_min(1e-30)[:, None]
      out[b, :, h * G:(h + 1) * G] = o.reshape(S, G, D).to(q.dtype)
  return out


def _inputs(shape, seed, cancelling=False):
  B, S, Hkv, G, D = shape
  rng = np.random.default_rng(seed)
  q = torch.from_numpy(rng.standard_normal((B, S, Hkv * G, D),
                                           dtype=np.float32))
  k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D), dtype=np.float32))
  if cancelling:    # V rows +1, -1, +1, ...: early outputs near zero
    sign = (-1.0) ** np.arange(S, dtype=np.float32)
    v = torch.from_numpy(np.broadcast_to(
        sign[None, :, None, None], (B, S, Hkv, D)).copy())
  else:
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                             dtype=np.float32))
  return [t.to(torch.bfloat16) for t in (q, k, v)]


def _margin(got, want):
  """Largest |err| / tolerance; the check passes below 1."""
  atol, rtol = BF16_OUT_TOL
  err = (got.float() - want.float()).abs()
  return float((err / (atol + rtol * want.float().abs())).max())


CASES = [
    # (B, S, Hkv, G, D), window, cap, cancelling V
    ((1, 300, 2, 4, 32), None, None, False),   # three tiles, ragged
    ((2, 130, 1, 8, 16), None, None, False),
    ((1, 260, 2, 2, 64), 40, 30.0, False),     # window edge inside a tile
    ((1, 200, 1, 3, 16), None, None, True),    # cancelling V rows
    ((1, 140, 2, 1, 32), 7, None, True),
    ((1, 200, 2, 2, 256), 70, 50.0, False),    # D = 256: 64-key tiles
    ((1, 150, 1, 4, 256), None, None, True),
]


@pytest.mark.parametrize("shape,window,cap,cancelling", CASES)
def test_split_p_emulation_holds_the_bf16_tolerance(shape, window, cap,
                                                    cancelling):
  q, k, v = _inputs(shape, seed=3, cancelling=cancelling)
  kw = dict(sm_scale=shape[-1] ** -0.5, cap=cap, window=window)
  want = ref.flash_prefill_ref(q, k, v, **kw)
  assert _margin(emulate(q, k, v, **kw), want) < 1.0


@pytest.mark.parametrize("shape,window", [((1, 200, 1, 3, 16), None),
                                          ((1, 140, 2, 1, 32), 7)])
def test_p_in_one_bf16_misses_cancelling_rows(shape, window):
  """The reason for the split: with P rounded to one bf16 the near-zero
  outputs of cancelling V rows fall outside the tolerance."""
  q, k, v = _inputs(shape, seed=3, cancelling=True)
  kw = dict(sm_scale=shape[-1] ** -0.5, window=window)
  want = ref.flash_prefill_ref(q, k, v, **kw)
  assert float(want[:, :8].float().abs().min()) < 0.2     # |v| = 1
  assert _margin(emulate(q, k, v, **kw, split=False), want) > 1.0
  assert _margin(emulate(q, k, v, **kw), want) < 1.0


def test_split_error_is_far_below_one_bf16_rounding():
  """P_hi + P_lo carries P to ~2^-17 of itself; P_hi alone to 2^-9."""
  g = torch.Generator().manual_seed(0)
  p = torch.rand(4096, generator=g, dtype=torch.float64).float()
  hi = p.to(torch.bfloat16).float()
  lo = (p - hi).to(torch.bfloat16).float()
  rel_split = float(((hi.double() + lo.double() - p.double()).abs()
                     / p.double()).max())
  rel_one = float(((hi.double() - p.double()).abs() / p.double()).max())
  assert rel_split <= 2.0 ** -16
  assert 2.0 ** -10 < rel_one <= 2.0 ** -8

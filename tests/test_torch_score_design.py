"""The design of the ``synopsis_score`` kernel (``csrc/synopsis_score.cu``),
emulated in torch on the CPU and held against the plain version
(``ref.synopsis_score_ref``) and the JAX package's Pallas kernel in
interpret mode.

The kernel runs only on the card; this keeps its arithmetic checkable
without one.  The emulation does what the kernel does: M is cut into warp
tiles of ``RW`` rows, 1, 2 or 4 warps a block by the launcher's rule; a
tile is read as ``LOADS`` 16-byte loads a lane, load i of lane l covering
bytes (i * 32 + l) * 16 of the tile, so each lane has a fixed column piece
of its rows (two for f32 at D = 256); the query group is padded with zero
heads to its bucket (4, 8 or 16); the row's lanes add their partial dots of
every head at offsets LPR / 2 down to 1 (a butterfly: every lane ends
with the same sums), and the row's first lane writes the max over the
real heads of the scaled sums.

Tolerance 2e-5 (f32 on every side, sums in other orders: the bound of
``test_torch_kernels.py``).  Cases: M from 4 (less than a tile) to 1024,
1000 (ragged), G = 1, 3 and 12 (zero heads in the bucket), 4 and 8, D =
16 (2 to 4 lanes a row, several rows a lane load) and 128, each in the
tile geometry of bf16 and of f32.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.synopsis_score import synopsis_score as j_synopsis_score
from repro_torch.kernels import _build, ref

TOL = dict(rtol=2e-5, atol=2e-5)
H100_SMS = 132
VEC = 16          # bytes of one load
LOADS = 4         # loads a lane keeps in flight
MAX_WARPS = 4     # warps a block at most
SOURCE = (pathlib.Path(_build.__file__).parent / "csrc"
          / "synopsis_score.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def geometry(D, itemsize):
  """``Geo`` of the kernel: elements a load, lanes a row, loads a row a
  lane, rows a warp load, row slots a lane, rows a warp tile."""
  row, warp = D * itemsize, 32 * VEC
  V = VEC // itemsize
  LPR = row // VEC if row < warp else 32
  VPL = row // warp if row > warp else 1
  RPW = warp // row if row < warp else 1
  NS = LOADS // VPL
  return V, LPR, VPL, RPW, NS, NS * RPW


def block_warps(tiles, rows, sms=H100_SMS):
  """The launcher's rule: the most of 4, 2, 1 warps a block that still
  gives every SM a block."""
  w = MAX_WARPS
  while w > 1 and rows * -(-tiles // w) < sms:
    w //= 2
  return w


def blocks(M, rows, D, itemsize, sms=H100_SMS):
  """The grid's chunks of one (b, hkv) row: (warps a block, blocks, the
  rows each block's warps read, padded past M)."""
  RW = geometry(D, itemsize)[-1]
  tiles = -(-M // RW)
  w = block_warps(tiles, rows, sms)
  n = -(-tiles // w)
  return w, n, [range(x * w * RW, (x + 1) * w * RW) for x in range(n)]


def emulate_synopsis_score(q, k_syn, *, sm_scale=1.0, itemsize=4):
  """Scores (B, Hkv, M) as the kernel computes them in the tile geometry
  of ``itemsize``-byte elements (f32 arithmetic either way)."""
  B, H, D = q.shape
  Hkv, M = k_syn.shape[1], k_syn.shape[2]
  G = H // Hkv
  GB = 4 if G <= 4 else 8 if G <= 8 else 16
  V, LPR, VPL, RPW, NS, RW = geometry(D, itemsize)
  _, _, chunks = blocks(M, B * Hkv, D, itemsize)
  Mp = chunks[-1].stop
  k = torch.zeros((B, Hkv, Mp, D))
  k[:, :, :M] = k_syn.float()                 # rows past M load as zeros
  qg = torch.zeros((B, Hkv, GB, D))
  qg[:, :, :G] = q.reshape(B, Hkv, G, D).float()
  # Lane piece pl of a row holds columns (vp * LPR + pl) * V .. + V for
  # each of its VPL loads of the row: its partial dots of every head.
  x = torch.einsum("bhmvpe,bhgvpe->bhmpg",
                   k.reshape(B, Hkv, Mp, VPL, LPR, V),
                   qg.reshape(B, Hkv, GB, VPL, LPR, V))
  lane = torch.arange(LPR)
  o = LPR // 2
  while o:
    x = x + x[..., lane ^ o, :]
    o //= 2
  assert torch.equal(x, x[..., :1, :].expand_as(x))
  assert not x[..., G:].any()                 # the bucket's zero heads
  return (x[..., 0, :G] * sm_scale).amax(-1)[:, :, :M]


def _case(M, G, D, seed, B=1, Hkv=2):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
  k_syn = rng.standard_normal((B, Hkv, M, D)).astype(np.float32)
  return q, k_syn


@pytest.mark.parametrize("M", [4, 16, 64, 65, 1000, 1024])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("D", [16, 128])
def test_warp_tiles_match_plain_and_pallas(M, G, D):
  """The emulation in the bf16 and the f32 tile geometry against the
  plain version and the Pallas kernel: every row once, the partial dots
  of each lane's pieces, the shuffle tree over the row's lanes, and a
  max over the real heads only (G = 1, 3 and 12 leave zero heads in the
  bucket, which a row with negative logits would otherwise take)."""
  q, k_syn = _case(M, G, D, seed=M + 10 * G + D)
  sm = D ** -0.5
  want = ref.synopsis_score_ref(torch.from_numpy(q),
                                torch.from_numpy(k_syn), sm_scale=sm)
  pallas = j_synopsis_score(jnp.asarray(q), jnp.asarray(k_syn), sm_scale=sm,
                            block_m=M, interpret=True)
  _close(want, pallas)
  for itemsize in (2, 4):
    got = emulate_synopsis_score(torch.from_numpy(q), torch.from_numpy(k_syn),
                                 sm_scale=sm, itemsize=itemsize)
    assert got.shape == (1, 2, M) and torch.isfinite(got).all()
    _close(got, want)
    _close(got, pallas)


@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_tile_geometry_is_whole_coalesced_loads(D, itemsize):
  """Each load instruction of a warp reads 512 contiguous bytes of the
  tile, every byte of the tile once, and a lane's column pieces are the
  same in every row it reads (its query pieces stay in registers)."""
  V, LPR, VPL, RPW, NS, RW = geometry(D, itemsize)
  row = D * itemsize
  assert RW * row == LOADS * 32 * VEC
  seen, pieces = set(), {}
  for i in range(LOADS):
    offs = [(i * 32 + lane) * VEC for lane in range(32)]
    assert offs == list(range(offs[0], offs[0] + 32 * VEC, VEC))
    for lane, off in enumerate(offs):
      r, col = divmod(off, row)
      assert r == (i // VPL) * RPW + lane // LPR      # the kernel's row
      assert col // itemsize == (i % VPL * LPR + lane % LPR) * V
      pieces.setdefault(lane, set()).add(col)
      seen.add(off)
  assert seen == set(range(0, RW * row, VEC))
  assert all(len(p) == VPL for p in pieces.values())


@pytest.mark.parametrize("M", [1, 4, 64, 65, 300, 1000, 1024, 8192])
@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("D,itemsize", [(16, 2), (128, 2), (128, 4),
                                        (256, 4)])
def test_blocks_cover_every_row_once(M, rows, D, itemsize):
  """Every row of a (b, hkv) belongs to exactly one block and one warp
  tile; the padding past M is less than one block."""
  w, n, chunks = blocks(M, rows, D, itemsize)
  covered = [r for c in chunks for r in c]
  assert covered == list(range(len(covered)))
  assert M <= len(covered) < M + w * geometry(D, itemsize)[-1]
  assert w in (1, 2, 4) and n == len(chunks)


def test_the_loop_shapes_fill_the_card():
  """At the unfused op's shape (B = 2, Hkv = 8, D = 128, bf16) M = 64
  takes 128 blocks of one warp, 8 rows each; M = 65 144; M = 1024 512
  blocks of four warps, 32 rows each, all resident on 132 SMs."""
  assert blocks(64, 16, 128, 2)[:2] == (1, 8)
  assert geometry(128, 2)[-1] == 8
  assert blocks(65, 16, 128, 2)[:2] == (1, 9)
  assert blocks(1024, 16, 128, 2)[:2] == (4, 32)
  assert blocks(64, 16, 128, 4)[:2] == (1, 16)        # f32: 4 rows a tile


def test_emulated_constants_are_the_kernels():
  """The constants mirrored above are the ones the source builds with."""
  src = SOURCE.read_text()
  for name, value in (("VEC", VEC), ("LOADS", LOADS),
                      ("MAX_WARPS", MAX_WARPS)):
    assert re.search(rf"constexpr int {name} = {value};", src), name
  assert "DISPATCH_HEAD_BUCKET" in src and "stream_chunk" not in src

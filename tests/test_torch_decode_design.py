"""The split-and-merge design of the three decode kernels
(``csrc/decode_core.cuh``, ``csrc/flash_decode.cu``,
``csrc/block_gather.cu``, ``csrc/fused_synopsis.cu``), emulated in torch
on the CPU and held against the plain versions
(``ref.fused_gather_attention_ref``, ``ref.flash_decode_ref``,
``ref.fused_synopsis_score_attention_ref``) and the JAX package's Pallas
kernels in interpret mode.

The kernels run only on the card; this keeps their arithmetic checkable
without one.  The emulation does what a block does: its span of rows is
cut into tiles of ``_build.decode_tile_rows`` rows, tile t goes to warp
t % DECODE_WARPS, each warp keeps an f32 online softmax over its tiles
with the finite -1e30 sentinel, and the warps merge into the block's
*unnormalised* partial (acc, m, l).  ``block_gather`` has one part a
selected cluster, with its scales and its centroid's decrement term
folded in as a row of weight -1, and one part an extras chunk of at most
``EXTRAS_ROWS`` rows; ``flash_decode`` one part a chunk of
``flash_decode._chunk`` rows; stage 1 one part a chunk of centroid rows
by the same rule, with its group-max scores taken
from each tile's raw dots and its per-row k / v scales.  The merge is exact: m the max, l the sum
of l_s * exp(m_s - m), o divided by l only where |l| > 1e-30 for
``block_gather`` (l is signed), by max(l, 1e-30) for ``flash_decode``.

Tolerance 2e-5 (f32 on every side, sums in other orders: the bound of
``test_torch_kernels.py``).  The traps of the split are cases here:
budget 0 (all ``-1`` ids, extras only), every part padded with no extras
(every part survives), a cluster of equal keys (its part's l cancels to
~0), C = 16 (shorter than one tile), a ragged E, S = 8320 / M = 65 after
an absorb, and the int8 / fp8 ``+kv`` scales; for stage 1, M = 1000 /
1024 (split) against 64 / 65 (one chunk), G = 3 and 12 (zero heads in
the buckets of 4 and 16), and int8 / fp8 tables.

The latent core (``csrc/latent_core.cuh``, MLA's absorbed decode: one
key/value head of D = 576 read by G = 128 query heads, 48 and 4 at SMOKE
size) is emulated the same way at the end: a block takes a head tile of
``LATENT_HEAD_TILE`` heads (the heads past G dead: excluded from the
softmax and the scores) and a chunk of ``latent_chunk`` rows in tiles of
``LATENT_TILE_ROWS``, each head's online softmax its own; the chunks of a
(b, hkv, head tile) merge as the ticketed merge does, and stage 1's
scores are each tile's max over its live heads, then the max across the
tiles (the kernel's second ticket).  The latent core's tensor-core
kernels (``csrc/latent_mma.cuh``: bf16 flash_decode, stage 2 on a bf16 /
int8 / fp8 cache) are emulated last: head tiles of ``LATENT_MMA_HEADS``,
chunks of ``latent_mma_chunk`` rows in tiles of ``LATENT_MMA_ROWS``, the
query and P each as bf16 hi + lo with the products summed in f32, the
logits as the three warpgroups' thirds of the k steps; held against the
plain versions and, at SMOKE size, the Pallas kernels.  The decode core's
tensor-core stream (``csrc/decode_mma.cuh``: bf16 rows for a group in the
head bucket of 16) comes after it: 16-row M tiles of the query, tiles of
16-row steps, the fragment's online softmax, P as bf16 hi + lo, the
warps' partials and the chunk / part merges, at G = 9, 12 and 16 against
the plain versions and the Pallas kernels; and the route and launch key
each wrapper picks, with the allocations of its ``meta`` branch.
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
from repro_torch.kernels import _build, ref
from repro_torch.kernels import quant as qt
from repro_torch.kernels.block_gather_attention import EXTRAS_ROWS, _parts
from repro_torch.kernels.flash_decode import (BLOCKS_PER_SM, MIN_CHUNK,
                                              _chunk)

TOL = dict(rtol=2e-5, atol=2e-5)
NEG_INF = -1e30
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return bridge.arena_from_numpy({"x": np.asarray(a)}, "cpu")["x"]


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _normal(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _span(qg, k, v, logit, tile_rows, on_tile=None, pscale=None):
  """One block over the rows of k, v (..., n, D) (codes widened to f32)
  for the query groups qg (..., G, D): its warps' online softmaxes over
  their tiles, merged.  logit(raw (..., G, r), r0, r1) gives the logits
  of rows [r0, r1); on_tile(raw, r0, r1) sees the tile's raw dots (the
  core's row hook); pscale(p, r0, r1) weighs p on its way into p.V, after
  p was added to l.  Returns the unnormalised (acc, m, l)."""
  n = k.shape[-2]
  lead, G, D = qg.shape[:-2], qg.shape[-2], qg.shape[-1]
  ntiles = -(-n // tile_rows)
  warps = []
  for w in range(_build.DECODE_WARPS):
    m = torch.full(lead + (G,), NEG_INF)
    l = torch.zeros(lead + (G,))
    acc = torch.zeros(lead + (G, D))
    for t in range(w, ntiles, _build.DECODE_WARPS):
      r0, r1 = t * tile_rows, min(n, (t + 1) * tile_rows)
      raw = torch.einsum("...gd,...rd->...gr", qg, k[..., r0:r1, :])
      if on_tile is not None:
        on_tile(raw, r0, r1)
      x = logit(raw, r0, r1)
      m_new = torch.maximum(m, x.amax(-1))
      alpha = torch.exp(m - m_new)
      p = torch.exp(x - m_new[..., None])
      l = l * alpha + p.sum(-1)
      if pscale is not None:
        p = pscale(p, r0, r1)
      acc = acc * alpha[..., None] + torch.einsum("...gr,...rd->...gd", p,
                                                  v[..., r0:r1, :])
      m = m_new
    warps.append((acc, m, l))
  return _combine(warps)


def _combine(parts):
  """Exact merge of unnormalised partials: (acc, m, l), l signed."""
  m = torch.stack([p[1] for p in parts]).amax(0)
  acc = sum(p[0] * torch.exp(p[1] - m)[..., None] for p in parts)
  l = sum(p[2] * torch.exp(p[1] - m) for p in parts)
  return acc, m, l


def _finish(parts, B, H, D, signed):
  acc, m, l = _combine(parts)
  if signed:
    o = acc / torch.where(l.abs() > 1e-30, l, torch.ones_like(l))[..., None]
  else:
    o = acc / l.clamp_min(1e-30)[..., None]
  return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def gather_parts(q, k, v, selected, *, cluster_size, sm_scale=1.0, cap=None,
                 k_sel=None, v_sel=None, sel_bias=None, extras_k=None,
                 extras_v=None, extras_bias=None, kv_k_scale=None,
                 kv_v_scale=None, span=_span):
  """block_gather's parts, as its blocks leave them (unnormalised): one
  per selected cluster, then one per extras chunk.  ``span(qg, k, v,
  logit, tile_rows)``: a block's stream (the CUDA-core one by default)."""
  B, H, D = q.shape
  _, Hkv, _, _ = k.shape
  G, C = H // Hkv, cluster_size
  qg = q.reshape(B, Hkv, G, D).float()
  parts = []
  for i in range(selected.shape[-1]):
    sel = selected[..., i].long()                           # (B, Hkv)
    valid, cid = sel >= 0, sel.clamp_min(0)
    idx = (cid[..., None] * C + torch.arange(C))[..., None].expand(
        -1, -1, -1, D)
    kc = qt.gather_rows(k, 2, idx).float()                  # raw codes
    vc = qt.gather_rows(v, 2, idx).float()
    one = torch.ones((B, Hkv))
    ksc = (one if kv_k_scale is None
           else torch.gather(kv_k_scale.float(), 2, cid[..., None])[..., 0])
    vsc = (one if kv_v_scale is None
           else torch.gather(kv_v_scale.float(), 2, cid[..., None])[..., 0])

    def logit(raw, r0, r1, ksc=ksc, valid=valid):
      x = ref.apply_softcap(raw * ksc[..., None, None] * sm_scale, cap)
      return torch.where(valid[..., None, None], x, torch.tensor(NEG_INF))

    acc, m, l = span(qg, kc, vc, logit,
                     _build.decode_tile_rows(D, k.element_size()))
    acc = acc * vsc[..., None, None]
    if k_sel is not None:                # the decrement: a row of weight -1
      sc = ref.apply_softcap(torch.einsum(
          "bhgd,bhd->bhg", qg, k_sel[:, :, i].float()) * sm_scale, cap)
      sc = torch.where(valid[..., None], sc + sel_bias[:, :, i, None],
                       torch.tensor(NEG_INF))
      m2 = torch.maximum(m, sc)
      e1, e2 = torch.exp(m - m2), torch.exp(sc - m2)
      l = l * e1 - e2
      acc = (acc * e1[..., None]
             - v_sel[:, :, i, None, :].float() * e2[..., None])
      m = m2
    parts.append((acc, m, l))
  if extras_k is not None:
    E = extras_k.shape[2]
    xrows = -(-E // -(-E // EXTRAS_ROWS))
    for x0 in range(0, E, xrows):
      eb = extras_bias[:, x0:x0 + xrows].float()

      def logit(raw, r0, r1, eb=eb):
        return (ref.apply_softcap(raw * sm_scale, cap)
                + eb[:, None, None, r0:r1])

      parts.append(span(qg, extras_k[:, :, x0:x0 + xrows].float(),
                        extras_v[:, :, x0:x0 + xrows].float(), logit,
                        _build.decode_tile_rows(D, extras_k.element_size())))
  return parts


def emulate_block_gather(q, k, v, selected, **kw):
  B, H, D = q.shape
  return _finish(gather_parts(q, k, v, selected, **kw), B, H, D, True)


def emulate_flash_decode(q, k, v, bias=None, *, sm_scale=1.0, cap=None,
                         chunk, span=_span):
  B, H, D = q.shape
  Hkv, S = k.shape[1], k.shape[2]
  qg = q.reshape(B, Hkv, H // Hkv, D).float()
  tr = _build.decode_tile_rows(D, k.element_size())
  parts = []
  for s0 in range(0, S, chunk):
    bc = None if bias is None else bias[:, :, s0:s0 + chunk].float()

    def logit(raw, r0, r1, bc=bc):
      x = ref.apply_softcap(raw * sm_scale, cap)
      return x if bc is None else x + bc[:, :, None, r0:r1]

    parts.append(span(qg, k[:, :, s0:s0 + chunk].float(),
                      v[:, :, s0:s0 + chunk].float(), logit, tr))
  return _finish(parts, B, H, D, False)


# ---------------------------------------------------------------------------
# block_gather_attention
# ---------------------------------------------------------------------------

GATHER_CASES = {
    # name: (M, C, I, E, selection, extras)
    "budget0": (8, 16, 1, 129, "all_padded", True),
    "all_padded_no_extras": (8, 16, 3, 0, "all_padded", False),
    "equal_keys": (8, 16, 3, 129, "equal_keys", True),
    "c16_padded": (9, 16, 5, 129, "padded", True),
    "ragged_e144": (8, 16, 3, 144, "padded", True),
    "absorbed_m65": (65, 128, 32, 129, "padded", True),
    "one_part": (8, 16, 1, 0, "random", False),
}


def _gather_case(name, seed=0, D=32, B=2, Hkv=2, G=4):
  """Numpy inputs of a case, built as the serve step builds them:
  centroids are the clusters' means, the decrement bias log(count), the
  extras a 128-row ring (100 valid) plus self-KV, masked past 129."""
  M, C, I, E, selection, extras = GATHER_CASES[name]
  rng = np.random.default_rng(seed)
  S = M * C
  q = _normal(rng, B, Hkv * G, D)
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  if selection == "all_padded":
    sel = np.full((B, Hkv, I), -1, np.int32)
  else:
    sel = np.stack([[rng.permutation(M)[:I] for _ in range(Hkv)]
                    for _ in range(B)]).astype(np.int32)
    if selection == "padded":
      sel[0, 0, 1] = -1
      sel[1, :, I - 1] = -1
    if selection == "equal_keys":
      for b in range(B):
        for h in range(Hkv):
          c = sel[b, h, 0]
          k[b, h, c * C:(c + 1) * C] = k[b, h, c * C]
  k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
  v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
  safe = np.maximum(sel, 0)[..., None]
  kw = dict(k_sel=np.take_along_axis(k_syn, safe, axis=2),
            v_sel=np.take_along_axis(v_syn, safe, axis=2),
            sel_bias=np.full(sel.shape, np.log(C), np.float32))
  if extras:
    ek, ev = _normal(rng, B, Hkv, E, D), _normal(rng, B, Hkv, E, D)
    eb = np.zeros((B, E), np.float32)
    eb[:, 100:128] = NEG_INF
    eb[:, 129:] = NEG_INF
    ek[:, :, 129:] = 0.0
    ev[:, :, 129:] = 0.0
    kw.update(extras_k=ek, extras_v=ev, extras_bias=eb)
  return q, k, v, sel, C, kw


def _hold(q, k, v, sel, C, kw, cap, kq=None, vq=None):
  """The emulation against the plain version and the Pallas kernel.
  kq / vq: the cache as JAX codes when it is quantized."""
  sm = q.shape[-1] ** -0.5
  tk = {n: _t(a) for n, a in kw.items()}
  args = (_t(q), _t(k if kq is None else kq), _t(v if vq is None else vq),
          _t(sel))
  got = emulate_block_gather(*args, cluster_size=C, sm_scale=sm, cap=cap,
                             **tk)
  want = ref.fused_gather_attention_ref(*args, cluster_size=C, sm_scale=sm,
                                        cap=cap, **tk)
  jax_out = j_block_gather(
      jnp.asarray(q), jnp.asarray(k if kq is None else kq),
      jnp.asarray(v if vq is None else vq), jnp.asarray(sel),
      cluster_size=C, sm_scale=sm, cap=cap, interpret=True,
      **{n: jnp.asarray(a) for n, a in kw.items()})
  for g, w, j in zip(got, want, jax_out):
    assert torch.isfinite(g).all()
    _close(g, w)
    _close(g, j)
  return args, tk


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
@pytest.mark.parametrize("cap", [None, 30.0])
def test_split_gather_matches_plain_and_pallas(case, cap):
  q, k, v, sel, C, kw = _gather_case(case)
  _hold(q, k, v, sel, C, kw, cap)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("case", ["c16_padded", "equal_keys"])
def test_split_gather_quantized_cache_scales(kind, case):
  """The int8 / fp8 ``+kv`` cache: one scale per cluster block on the
  part's raw logits and on its acc (p entering p.V), none on the
  decrement (dequantized f32 rows) or the extras."""
  q, k, v, sel, C, kw = _gather_case(case, seed=4)
  B, Hkv, S, D = k.shape
  kq, ks = jqt.quantize_rows(jnp.asarray(k), kind, block=C)
  vq, vs = jqt.quantize_rows(jnp.asarray(v), kind, block=C)
  kw.update(kv_k_scale=np.asarray(ks), kv_v_scale=np.asarray(vs))
  _hold(q, k, v, sel, C, kw, 30.0, kq=np.asarray(kq), vq=np.asarray(vq))


def test_equal_keys_part_cancels_and_is_kept_unnormalised():
  """A cluster whose C keys equal its centroid: its rows' mass C e^x and
  its decrement e^(x + log C) cancel, so its part's l is ~0 (and its acc
  ~0 with the centroid's value the rows' mean).  Normalising that part
  on its own would divide by ~0; the unnormalised part merges to the
  plain version's output."""
  q, k, v, sel, C, kw = _gather_case("equal_keys")
  tk = {n: _t(a) for n, a in kw.items()}
  parts = gather_parts(_t(q), _t(k), _t(v), _t(sel), cluster_size=C,
                       sm_scale=q.shape[-1] ** -0.5, **tk)
  acc, m, l = parts[0]
  assert float(l.abs().max()) < 1e-5
  assert float(acc.abs().max()) < 1e-4
  others = parts[1]
  assert float(others[2].abs().min()) > 1e-2


def test_padded_parts_are_wiped_out_or_all_kept():
  """An all-padded part is (m = -1e30, l = C - 1): every row and its
  decrement at the sentinel.  A finite m elsewhere wipes it out; with no
  extras every part survives, as in the unsplit sum."""
  q, k, v, sel, C, kw = _gather_case("all_padded_no_extras")
  tk = {n: _t(a) for n, a in kw.items()}
  sm = q.shape[-1] ** -0.5
  parts = gather_parts(_t(q), _t(k), _t(v), _t(sel), cluster_size=C,
                       sm_scale=sm, **tk)
  for acc, m, l in parts:
    assert torch.all(m == NEG_INF) and torch.all(l == C - 1)
  o, m, l = emulate_block_gather(_t(q), _t(k), _t(v), _t(sel),
                                 cluster_size=C, sm_scale=sm, **tk)
  assert torch.all(m == NEG_INF) and torch.all(l == len(parts) * (C - 1))
  q, k, v, sel, C, kw = _gather_case("budget0")
  tk = {n: _t(a) for n, a in kw.items()}
  parts = gather_parts(_t(q), _t(k), _t(v), _t(sel), cluster_size=C,
                       sm_scale=sm, **tk)
  _, m, l = _combine(parts)
  extras = _combine(parts[1:])
  torch.testing.assert_close(l, extras[2], rtol=0, atol=0)
  assert torch.all(m > NEG_INF)


def test_extras_chunks_cover_e_in_near_equal_parts():
  for E, want in ((129, [65, 64]), (128, [128]), (144, [72, 72]),
                  (1, [1]), (300, [100, 100, 100])):
    xrows = -(-E // -(-E // EXTRAS_ROWS))
    assert [min(xrows, E - x0) for x0 in range(0, E, xrows)] == want


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def test_chunks_fill_one_wave_of_whole_tile_rounds():
  """The exact path's shape (B = 2, Hkv = 8, D = 128, bf16): whole rounds
  of one tile a warp, about BLOCKS_PER_SM blocks an SM and never more than
  one wave of the 5 blocks an SM holds (~37 KB of shared memory each); the
  self token and the centroid tables are one chunk."""
  rnd = _build.DECODE_WARPS * _build.decode_tile_rows(128, 2)
  for S in (4096, 8192, 8320):
    chunk = _chunk(S, 128, 2, 16, H100_SMS)
    nsplit = -(-S // chunk)
    assert chunk % rnd == 0
    assert 0.75 * BLOCKS_PER_SM * H100_SMS <= nsplit * 16 <= 5 * H100_SMS
  for S in (1, 64, 65, MIN_CHUNK):
    assert _chunk(S, 128, 2, 16, H100_SMS) >= S


DECODE_CASES = [
    # (S, bias kind, cap)
    (1, None, None), (65, "masked", None), (65, "all_masked", None),
    (129, "log_count", None), (385, None, 30.0), (8192, None, None),
    (8320, "masked", 30.0),
]


@pytest.mark.parametrize("S,bias_kind,cap", DECODE_CASES)
@pytest.mark.parametrize("chunking", ["main_path", "this_shape"])
def test_split_decode_matches_plain_and_pallas(S, bias_kind, cap, chunking):
  """flash_decode's chunks: at the chunk length of the exact path's shape
  (bf16, D = 128, 16 (b, hkv) rows) and at the one this f32 test shape
  gets, against the plain version and the Pallas kernel."""
  B, Hkv, G, D = 1, 2, 4, 32
  rng = np.random.default_rng(S)
  q = _normal(rng, B, Hkv * G, D)
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  bias = None
  if bias_kind is not None:
    bias = np.log(rng.integers(1, 129, (B, Hkv, S))).astype(np.float32)
    if bias_kind != "log_count":
      bias[(rng.random((B, Hkv, S)) < 0.4) | (bias_kind == "all_masked")] = (
          NEG_INF)
  chunk = (_chunk(S, 128, 2, 16, H100_SMS) if chunking == "main_path"
           else _chunk(S, D, 4, B * Hkv, H100_SMS))
  sm = D ** -0.5
  tb = None if bias is None else _t(bias)
  got = emulate_flash_decode(_t(q), _t(k), _t(v), tb, sm_scale=sm, cap=cap,
                             chunk=chunk)
  want = ref.flash_decode_ref(_t(q), _t(k), _t(v), tb, sm_scale=sm, cap=cap)
  jax_out = jops._decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if bias is None else jnp.asarray(bias), sm,
                         "interpret", cap=cap)
  for g, w, j in zip(got, want, jax_out):
    assert torch.isfinite(g).all()
    _close(g, w)
    _close(g, j)


# ---------------------------------------------------------------------------
# fused_synopsis_score_attention (stage 1)
# ---------------------------------------------------------------------------

def emulate_fused_synopsis(q, k_syn, v_syn, cbias, *, sm_scale=1.0,
                           cap=None, k_scale=None, v_scale=None, chunk):
  """Stage 1 as its blocks compute it: chunks of ``chunk`` centroid rows,
  the query group padded with zero heads to its bucket (4, 8 or 16), each
  row's group-max score over the G real heads taken from the tile's raw
  dots (scaled, uncapped), the k-scale on the raw dot before sm_scale, the
  count bias after the softcap, the v-scale on p after l, and the chunks
  merged exactly (l >= 0: o / max(l, 1e-30))."""
  B, H, D = q.shape
  Hkv, M = k_syn.shape[1], k_syn.shape[2]
  G = H // Hkv
  GB = 4 if G <= 4 else 8 if G <= 8 else 16
  qg = torch.zeros((B, Hkv, GB, D))
  qg[:, :, :G] = q.reshape(B, Hkv, G, D).float()
  tr = _build.decode_tile_rows(D, k_syn.element_size())
  scores = torch.full((B, Hkv, M), float("nan"))
  parts = []
  for s0 in range(0, M, chunk):
    s1 = min(M, s0 + chunk)
    ks = None if k_scale is None else k_scale[:, :, s0:s1].float()
    vs = None if v_scale is None else v_scale[:, :, s0:s1].float()
    cb = cbias[:, s0:s1].float()

    def scaled(raw, r0, r1, ks=ks):
      return (raw if ks is None else raw * ks[:, :, None, r0:r1]) * sm_scale

    def on_tile(raw, r0, r1, s0=s0, scaled=scaled):
      scores[:, :, s0 + r0:s0 + r1] = scaled(raw, r0, r1)[:, :, :G].amax(2)

    def logit(raw, r0, r1, cb=cb, scaled=scaled):
      return (ref.apply_softcap(scaled(raw, r0, r1), cap)
              + cb[:, None, None, r0:r1])

    def pscale(p, r0, r1, vs=vs):
      return p if vs is None else p * vs[:, :, None, r0:r1]

    acc, m, l = _span(qg, k_syn[:, :, s0:s1].float(),
                      v_syn[:, :, s0:s1].float(), logit, tr, on_tile, pscale)
    parts.append((acc[:, :, :G], m[:, :, :G], l[:, :, :G]))
  return scores, _finish(parts, B, H, D, False)


def _stage1_case(M, G, kind, seed, B=1, Hkv=2, D=32, C=4):
  """Numpy stage-1 inputs built as the serve step builds them: the
  centroid tables are the means of a cache's C-row clusters (quantized
  per row under ``kind``: JAX codes and scales), the bias log(count) of
  counts in [1, 128] (clusters grown unevenly by absorbs)."""
  rng = np.random.default_rng(seed)
  q = _normal(rng, B, Hkv * G, D)
  k = _normal(rng, B, Hkv, M * C, D)
  v = _normal(rng, B, Hkv, M * C, D)
  k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
  v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
  cbias = np.log(rng.integers(1, 129, (B, M))).astype(np.float32)
  scales = {}
  if kind != "none":
    kq, ks = jqt.quantize_rows(jnp.asarray(k_syn), kind)
    vq, vs = jqt.quantize_rows(jnp.asarray(v_syn), kind)
    k_syn, v_syn = np.asarray(kq), np.asarray(vq)
    scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
  return q, k_syn, v_syn, cbias, scales


@pytest.mark.parametrize("M", [64, 65, 1000, 1024])
@pytest.mark.parametrize("G", [3, 4, 8, 12])
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_split_stage1_matches_plain_and_pallas(M, G, kind, cap):
  """Stage 1's chunks, at the chunk length of the loop's shape (bf16 or
  int8 / fp8 tables, D = 128, 16 (b, hkv) rows) and at the one this test
  shape gets, against the plain version and the Pallas kernel: the scores
  over the real heads only (G = 3 and 12 leave zero heads in their
  buckets), the per-row k / v scales, the count bias and the exact merge
  (M = 1000 and 1024 split, 64 and 65 do not at the loop's shape)."""
  q, k_syn, v_syn, cbias, scales = _stage1_case(M, G, kind, seed=M + G)
  B, Hkv, _, D = k_syn.shape
  sm = D ** -0.5
  args = tuple(_t(a) for a in (q, k_syn, v_syn, cbias))
  tsc = {n: _t(a) for n, a in scales.items()}
  want = ref.fused_synopsis_score_attention_ref(*args, sm_scale=sm, cap=cap,
                                                **tsc)
  js, jp = j_fused_synopsis(*(jnp.asarray(a) for a in (q, k_syn, v_syn, cbias)),
                   sm_scale=sm, cap=cap, interpret=True,
                   **{n: jnp.asarray(a) for n, a in scales.items()})
  itemsize = args[1].element_size()
  main = _chunk(M, 128, 2 if kind == "none" else 1, 16, H100_SMS)
  here = _chunk(M, D, itemsize, B * Hkv, H100_SMS)
  assert (M > MIN_CHUNK) == (-(-M // main) > 1)
  for chunk in (main, here):
    scores, got = emulate_fused_synopsis(*args, sm_scale=sm, cap=cap,
                                         chunk=chunk, **tsc)
    assert torch.isfinite(scores).all()
    _close(scores, want[0])
    _close(scores, js)
    for g, w, j in zip(got, want[1], jp):
      assert torch.isfinite(g).all()
      _close(g, w)
      _close(g, j)



# ---------------------------------------------------------------------------
# The latent core (MLA's absorbed decode)
# ---------------------------------------------------------------------------

def _latent_span(qt_, k, v, logit):
  """One latent block: the head tile's queries qt_ (h, D) over the rows of
  k, v (n, D) in tiles of LATENT_TILE_ROWS rows, each head's online
  softmax; logit(raw (h, r), r0, r1).  Returns the unnormalised (acc (h,
  D), m (h,), l (h,)) and each row's raw dots (h, n)."""
  n, D = k.shape
  h = qt_.shape[0]
  m, l, acc = torch.full((h,), NEG_INF), torch.zeros(h), torch.zeros(h, D)
  raws = []
  for r0 in range(0, n, _build.LATENT_TILE_ROWS):
    r1 = min(n, r0 + _build.LATENT_TILE_ROWS)
    raw = qt_ @ k[r0:r1].T
    raws.append(raw)
    x = logit(raw, r0, r1)
    m_new = torch.maximum(m, x.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(x - m_new[:, None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[:, None] + p @ v[r0:r1]
    m = m_new
  return (acc, m, l), torch.cat(raws, 1)


def _latent_tiles(G):
  """The head tiles: (first head, live heads) of each."""
  T = _build.LATENT_HEAD_TILE
  return [(g0, min(T, G - g0)) for g0 in range(0, G, T)]


def emulate_latent_decode(q, k, v, bias=None, *, sm_scale=1.0, cap=None):
  """flash_decode on the latent core: grid (chunks, head tiles, B Hkv)."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  tiles = _latent_tiles(G)
  chunk = _build.latent_chunk(S, B * Hkv * len(tiles), H100_SMS)
  o, m_out, l_out = (torch.zeros(B, H, D), torch.zeros(B, H),
                     torch.zeros(B, H))
  for b in range(B):
    for hk in range(Hkv):
      for g0, h in tiles:
        rows = slice(hk * G + g0, hk * G + g0 + h)
        parts = []
        for s0 in range(0, S, chunk):
          s1 = min(S, s0 + chunk)
          bb = None if bias is None else bias[b, hk, s0:s1]
          parts.append(_latent_span(
              q[b, rows], k[b, hk, s0:s1], v[b, hk, s0:s1],
              lambda raw, r0, r1, bb=bb: ref.apply_softcap(
                  raw * sm_scale, cap) + (0.0 if bb is None
                                          else bb[r0:r1]))[0])
        acc, m, l = _combine(parts)
        o[b, rows] = acc / l.clamp_min(1e-30)[:, None]
        m_out[b, rows], l_out[b, rows] = m, l
  return o, m_out, l_out


def emulate_latent_gather(q, k, v, selected, *, cluster_size, sm_scale=1.0,
                          cap=None, k_sel=None, v_sel=None, sel_bias=None,
                          extras_k=None, extras_v=None, extras_bias=None):
  """block_gather on the latent core: grid (I clusters + extras chunks,
  head tiles, B Hkv); a cluster part folds its centroid's term in as a row
  of weight -1; the parts merge with the signed rule."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G, C, I = H // Hkv, cluster_size, selected.shape[-1]
  E = extras_k.shape[2] if extras_k is not None else 0
  xrows, _ = _parts(I, E, extras_k is not None)
  o, m_out, l_out = (torch.zeros(B, H, D), torch.zeros(B, H),
                     torch.zeros(B, H))
  for b in range(B):
    for hk in range(Hkv):
      for g0, h in _latent_tiles(G):
        rows = slice(hk * G + g0, hk * G + g0 + h)
        qt_ = q[b, rows]
        parts = []
        for i in range(I):
          sel = int(selected[b, hk, i])
          cid = max(sel, 0)
          cl = slice(cid * C, (cid + 1) * C)
          (acc, m, l), _ = _latent_span(
              qt_, k[b, hk, cl], v[b, hk, cl],
              lambda raw, r0, r1, ok=sel >= 0: ref.apply_softcap(
                  raw * sm_scale, cap) if ok else torch.full_like(raw,
                                                                  NEG_INF))
          if k_sel is not None:
            dl = (ref.apply_softcap(qt_ @ k_sel[b, hk, i] * sm_scale, cap)
                  + sel_bias[b, hk, i]) if sel >= 0 else torch.full(
                      (h,), NEG_INF)
            m2 = torch.maximum(m, dl)
            e1, e2 = torch.exp(m - m2), torch.exp(dl - m2)
            acc = acc * e1[:, None] - v_sel[b, hk, i][None] * e2[:, None]
            m, l = m2, l * e1 - e2
          parts.append((acc, m, l))
        for x0 in range(0, E, xrows):
          x1 = min(E, x0 + xrows)
          eb = extras_bias[b, x0:x1]
          parts.append(_latent_span(
              qt_, extras_k[b, hk, x0:x1], extras_v[b, hk, x0:x1],
              lambda raw, r0, r1, eb=eb: ref.apply_softcap(
                  raw * sm_scale, cap) + eb[r0:r1])[0])
        acc, m, l = _combine(parts)
        o[b, rows] = acc / torch.where(l.abs() > 1e-30, l,
                                       torch.ones_like(l))[:, None]
        m_out[b, rows], l_out[b, rows] = m, l
  return o, m_out, l_out


def emulate_latent_stage1(q, k_syn, v_syn, cbias, *, sm_scale=1.0, cap=None):
  """Stage 1 on the latent core: each (chunk, head tile) block writes its
  rows' max over the tile's live heads of the scaled raw dot to the
  tile's scratch row; the (b, hkv)'s last block takes the max across the
  tiles.  Returns (scores, partials)."""
  B, H, D = q.shape
  _, Hkv, M, _ = k_syn.shape
  G = H // Hkv
  tiles = _latent_tiles(G)
  chunk = _build.latent_chunk(M, B * Hkv * len(tiles), H100_SMS)
  part_scores = torch.full((B, Hkv, len(tiles), M), float("nan"))
  o, m_out, l_out = (torch.zeros(B, H, D), torch.zeros(B, H),
                     torch.zeros(B, H))
  for b in range(B):
    for hk in range(Hkv):
      for t, (g0, h) in enumerate(tiles):
        rows = slice(hk * G + g0, hk * G + g0 + h)
        parts = []
        for s0 in range(0, M, chunk):
          s1 = min(M, s0 + chunk)
          cb = cbias[b, s0:s1]
          part, raw = _latent_span(
              q[b, rows], k_syn[b, hk, s0:s1], v_syn[b, hk, s0:s1],
              lambda raw, r0, r1, cb=cb: ref.apply_softcap(
                  raw * sm_scale, cap) + cb[r0:r1])
          parts.append(part)
          part_scores[b, hk, t, s0:s1] = (raw * sm_scale).amax(0)
        acc, m, l = _combine(parts)
        o[b, rows] = acc / l.clamp_min(1e-30)[:, None]
        m_out[b, rows], l_out[b, rows] = m, l
  return part_scores.amax(2), (o, m_out, l_out)


def _latent_case(G, D, seed, S=256, C=16):
  rng = np.random.default_rng(seed)
  B, M = 2, S // C
  q = _t(_normal(rng, B, G, D) * np.float32(3.0 * D ** -0.5))
  k, v = _t(_normal(rng, B, 1, S, D)), _t(_normal(rng, B, 1, S, D))
  return q, k, v, M, C, rng


LATENT_SHAPES = [(4, 48), (100, 576), (128, 576)]


@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_latent_decode_design_matches_plain(G, D, cap):
  """The latent flash_decode's head tiles and chunk merge (S = 1000 cut
  into chunks by latent_chunk, a -1e30 bias on a tenth of the keys)
  against the plain version; G = 100 leaves a last tile of 4 live
  heads."""
  q, k, v, _, _, rng = _latent_case(G, D, seed=G + D, S=1000)
  bias = _t(np.where(rng.random((2, 1, 1000)) < 0.1, NEG_INF,
                     0.0).astype(np.float32))
  kw = dict(sm_scale=192 ** -0.5, cap=cap)
  assert len(range(0, 1000, _build.latent_chunk(
      1000, 2 * len(_latent_tiles(G)), H100_SMS))) > 1
  for got, want in zip(emulate_latent_decode(q, k, v, bias, **kw),
                       ref.flash_decode_ref(q, k, v, bias, **kw)):
    _close(got, want)


@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("case", ["dec_extras", "padded", "budget0"])
def test_latent_gather_design_matches_plain(G, D, case):
  """The latent stage 2's parts (clusters with the decrement row, extras
  chunks of a ragged E = 129) and signed merge against the plain version:
  selected clusters, one padded id, and budget 0 (all -1, extras only)."""
  q, k, v, M, C, rng = _latent_case(G, D, seed=3 * G + D)
  sel = np.stack([rng.permutation(M)[:4] for _ in range(2)])[:, None]
  if case == "padded":
    sel[1, 0, 2] = -1
  if case == "budget0":
    sel = np.full((2, 1, 1), -1)
  sel = _t(sel.astype(np.int32))
  k_syn = k.reshape(2, 1, M, C, D).mean(3)
  v_syn = v.reshape(2, 1, M, C, D).mean(3)
  safe = sel.long().clamp_min(0)[..., None].expand(-1, -1, -1, D)
  ek, ev = _t(_normal(rng, 2, 1, 129, D)), _t(_normal(rng, 2, 1, 129, D))
  eb = torch.zeros(2, 129)
  eb[:, 100:128] = NEG_INF
  kw = dict(cluster_size=C, sm_scale=192 ** -0.5, cap=30.0,
            k_sel=torch.gather(k_syn, 2, safe),
            v_sel=torch.gather(v_syn, 2, safe),
            sel_bias=torch.full(sel.shape, float(np.log(C))), extras_k=ek,
            extras_v=ev, extras_bias=eb)
  for got, want in zip(emulate_latent_gather(q, k, v, sel, **kw),
                       ref.fused_gather_attention_ref(q, k, v, sel, **kw)):
    _close(got, want)


@pytest.mark.parametrize("G,D", LATENT_SHAPES)
@pytest.mark.parametrize("M", [64, 65, 1024])
def test_latent_stage1_design_matches_plain(G, D, M):
  """The latent stage 1: the scores' max taken per head tile over its live
  heads, then across the tiles, and the count-biased partials merged over
  the chunks of M, against the plain version."""
  rng = np.random.default_rng(M + G)
  q = _t(_normal(rng, 2, G, D) * np.float32(3.0 * D ** -0.5))
  k_syn, v_syn = _t(_normal(rng, 2, 1, M, D)), _t(_normal(rng, 2, 1, M, D))
  cbias = _t(np.log(rng.integers(1, 129, (2, M)).astype(np.float32)))
  kw = dict(sm_scale=192 ** -0.5, cap=30.0)
  scores, part = emulate_latent_stage1(q, k_syn, v_syn, cbias, **kw)
  want_scores, want_part = ref.fused_synopsis_score_attention_ref(
      q, k_syn, v_syn, cbias, **kw)
  assert not torch.isnan(scores).any()
  _close(scores, want_scores)
  for got, want in zip(part, want_part):
    _close(got, want)


# ---------------------------------------------------------------------------
# The latent core's tensor-core kernels (csrc/latent_mma.cuh): flash_decode
# on bf16 rows, block_gather on a bf16 / int8 / fp8 cache beside bf16
# extras.  A block takes LATENT_MMA_HEADS heads and tiles of
# LATENT_MMA_ROWS rows; the query and P go into the products as two bf16
# halves each, the products (exact in f32) summed in f32; the logits are
# the three warpgroups' thirds of the k steps, added (S_0 + S_1) + S_2.
# ---------------------------------------------------------------------------

def _bf16_split(x):
  """x = hi + lo with hi = bf16(x), lo = bf16(x - hi), as f32 values."""
  hi = x.to(torch.bfloat16).float()
  return hi, (x - hi).to(torch.bfloat16).float()


def _mma_span(qt_, k, v, logit):
  """One tensor-core block: the head tile's queries qt_ (h, D) f32 over
  the rows of k, v (n, D) (bf16 values, or codes widened to f32) in tiles
  of LATENT_MMA_ROWS rows.  Returns the unnormalised (acc, m, l)."""
  n, D = k.shape
  h = qt_.shape[0]
  third = D // 3                       # a warpgroup's logit columns
  q_hi, q_lo = _bf16_split(qt_)
  m, l, acc = torch.full((h,), NEG_INF), torch.zeros(h), torch.zeros(h, D)
  for r0 in range(0, n, _build.LATENT_MMA_ROWS):
    r1 = min(n, r0 + _build.LATENT_MMA_ROWS)
    kt = k[r0:r1]
    s0, s1, s2 = (q_hi[:, c] @ kt[:, c].T + q_lo[:, c] @ kt[:, c].T
                  for c in (slice(w * third, (w + 1) * third)
                            for w in range(3)))
    x = logit((s0 + s1) + s2, r0, r1)
    m_new = torch.maximum(m, x.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(x - m_new[:, None])
    l = l * alpha + p.sum(-1)
    p_hi, p_lo = _bf16_split(p)
    acc = acc * alpha[:, None] + p_hi @ v[r0:r1] + p_lo @ v[r0:r1]
    m = m_new
  return acc, m, l


def _mma_tiles(G):
  """The tensor-core head tiles: (first head, live heads) of each."""
  T = _build.LATENT_MMA_HEADS
  return [(g0, min(T, G - g0)) for g0 in range(0, G, T)]


def emulate_latent_mma_decode(q, k, v, bias=None, *, sm_scale=1.0,
                              cap=None):
  """The tensor-core flash_decode: grid (chunks of latent_mma_chunk rows,
  head tiles of 64, B Hkv), the chunks merged exactly."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G = H // Hkv
  tiles = _mma_tiles(G)
  chunk = _build.latent_mma_chunk(S, B * Hkv * len(tiles), H100_SMS)
  o, m_out, l_out = (torch.zeros(B, H, D), torch.zeros(B, H),
                     torch.zeros(B, H))
  for b in range(B):
    for hk in range(Hkv):
      for g0, h in tiles:
        rows = slice(hk * G + g0, hk * G + g0 + h)
        parts = []
        for s0 in range(0, S, chunk):
          s1 = min(S, s0 + chunk)
          bb = None if bias is None else bias[b, hk, s0:s1]
          parts.append(_mma_span(
              q[b, rows], k[b, hk, s0:s1].float(), v[b, hk, s0:s1].float(),
              lambda raw, r0, r1, bb=bb: ref.apply_softcap(
                  raw * sm_scale, cap) + (0.0 if bb is None
                                          else bb[r0:r1])))
        acc, m, l = _combine(parts)
        o[b, rows] = acc / l.clamp_min(1e-30)[:, None]
        m_out[b, rows], l_out[b, rows] = m, l
  return o, m_out, l_out


def emulate_latent_mma_gather(q, k, v, selected, *, cluster_size,
                              sm_scale=1.0, cap=None, k_sel=None, v_sel=None,
                              sel_bias=None, extras_k=None, extras_v=None,
                              extras_bias=None, kv_k_scale=None,
                              kv_v_scale=None):
  """The tensor-core block_gather: grid (I clusters + extras chunks of at
  most LATENT_MMA_EXTRAS_ROWS, head tiles of 64, B Hkv); a cluster's
  k-scale on its raw logits, its v-scale on its sum, its centroid's term
  as a row of weight -1 (logits from q_hi + q_lo); the signed merge."""
  B, H, D = q.shape
  _, Hkv, S, _ = k.shape
  G, C, I = H // Hkv, cluster_size, selected.shape[-1]
  E = extras_k.shape[2] if extras_k is not None else 0
  xrows, _ = _parts(I, E, extras_k is not None,
                    _build.LATENT_MMA_EXTRAS_ROWS)
  kf, vf = k.float(), v.float()         # codes widen exactly
  o, m_out, l_out = (torch.zeros(B, H, D), torch.zeros(B, H),
                     torch.zeros(B, H))
  for b in range(B):
    for hk in range(Hkv):
      for g0, h in _mma_tiles(G):
        rows = slice(hk * G + g0, hk * G + g0 + h)
        qt_ = q[b, rows]
        parts = []
        for i in range(I):
          sel = int(selected[b, hk, i])
          cid = max(sel, 0)
          ksc = 1.0 if kv_k_scale is None else float(kv_k_scale[b, hk, cid])
          vsc = 1.0 if kv_v_scale is None else float(kv_v_scale[b, hk, cid])
          cl = slice(cid * C, (cid + 1) * C)
          acc, m, l = _mma_span(
              qt_, kf[b, hk, cl], vf[b, hk, cl],
              lambda raw, r0, r1, ok=sel >= 0, ksc=ksc: ref.apply_softcap(
                  raw * ksc * sm_scale, cap) if ok else torch.full_like(
                      raw, NEG_INF))
          acc = acc * vsc
          if k_sel is not None:
            q_hi, q_lo = _bf16_split(qt_)
            dl = (ref.apply_softcap((q_hi + q_lo) @ k_sel[b, hk, i].float()
                                    * sm_scale, cap) + sel_bias[b, hk, i]
                  if sel >= 0 else torch.full((h,), NEG_INF))
            m2 = torch.maximum(m, dl)
            e1, e2 = torch.exp(m - m2), torch.exp(dl - m2)
            acc = (acc * e1[:, None]
                   - v_sel[b, hk, i].float()[None] * e2[:, None])
            m, l = m2, l * e1 - e2
          parts.append((acc, m, l))
        for x0 in range(0, E, xrows):
          x1 = min(E, x0 + xrows)
          eb = extras_bias[b, x0:x1]
          parts.append(_mma_span(
              qt_, extras_k[b, hk, x0:x1].float(),
              extras_v[b, hk, x0:x1].float(),
              lambda raw, r0, r1, eb=eb: ref.apply_softcap(
                  raw * sm_scale, cap) + eb[r0:r1]))
        acc, m, l = _combine(parts)
        o[b, rows] = acc / torch.where(l.abs() > 1e-30, l,
                                       torch.ones_like(l))[:, None]
        m_out[b, rows], l_out[b, rows] = m, l
  return o, m_out, l_out


def _mma_bias(rng, kind, S):
  if kind is None:
    return None
  bias = np.log(rng.integers(1, 129, (2, 1, S))).astype(np.float32)
  if kind == "masked":
    bias[rng.random((2, 1, S)) < 0.3] = NEG_INF
  return _t(bias)


MMA_SHAPES = [(4, 48), (100, 576), (128, 576)]


@pytest.mark.parametrize("G,D", MMA_SHAPES)
@pytest.mark.parametrize("S", [1, 65, 300, 1000])
@pytest.mark.parametrize("bias_kind,cap", [(None, None), ("masked", 30.0)])
def test_latent_mma_decode_matches_plain(G, D, S, bias_kind, cap):
  """The tensor-core flash_decode (head tiles of 64: G = 100 leaves a
  last tile of 36 live heads; 16-row tiles: S = 1 and 65 leave a ragged
  one; chunks: one at S = 1, several from 65 on) on bf16 rows against the
  plain version; at SMOKE size also against the Pallas kernel."""
  rng = np.random.default_rng(7 * G + S)
  q = _t(_normal(rng, 2, G, D) * np.float32(3.0 * D ** -0.5))
  k, v = (_t(_normal(rng, 2, 1, S, D)).to(torch.bfloat16) for _ in range(2))
  bias = _mma_bias(rng, bias_kind, S)
  kw = dict(sm_scale=192 ** -0.5, cap=cap)
  nsplit = -(-S // _build.latent_mma_chunk(S, 2 * len(_mma_tiles(G)),
                                           H100_SMS))
  assert (nsplit == 1) == (S == 1)
  got = emulate_latent_mma_decode(q, k, v, bias, **kw)
  for g, w in zip(got, ref.flash_decode_ref(q, k, v, bias, **kw)):
    assert torch.isfinite(g).all()
    _close(g, w)
  if D == 48:
    jax_out = jops._decode(
        jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy()),
        jnp.asarray(v.float().numpy()),
        None if bias is None else jnp.asarray(bias.numpy()),
        kw["sm_scale"], "interpret", cap=cap)
    for g, j in zip(got, jax_out):
      _close(g, j)


def _mma_gather_case(case, G, D, kind="none", seed=0):
  """A case of the card tests' stage-2 inputs (``_gather_inputs``: Hkv =
  1, E = 129 as the port builds it, the q of the latent tests) with the
  cache, extras and decrement rows in bf16, or the cache as the JAX
  package's int8 / fp8 codes with one scale per cluster block beside bf16
  extras and f32 decrement rows.  Returns the torch inputs and the JAX
  ones (the same values)."""
  from test_torch_card import _gather_inputs  # noqa: PLC0415
  C, I = {"dec_extras": (128, 32), "plain": (128, 1)}.get(case, (16, 3))
  q, k, v, sel, C, kw = _gather_inputs(case, (I + 2) * C, D=D, C=C, I=I,
                                       G=G, Hkv=1, E=129, seed=seed)
  q = q * (D ** -0.5) * 3.0
  bf = ("extras_k", "extras_v") + (("k_sel", "v_sel") if kind == "none"
                                   else ())
  kw = {n: (t.bfloat16() if n in bf else t) for n, t in kw.items()}
  jkw = {n: jnp.asarray(t.float().numpy()) for n, t in kw.items()}
  if kind == "none":
    k, v = k.bfloat16(), v.bfloat16()
    jk, jv = jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy())
  else:
    jk, ks = jqt.quantize_rows(jnp.asarray(k.numpy()), kind, block=C)
    jv, vs = jqt.quantize_rows(jnp.asarray(v.numpy()), kind, block=C)
    k, v = _t(np.asarray(jk)), _t(np.asarray(jv))
    kw.update(kv_k_scale=_t(np.asarray(ks)), kv_v_scale=_t(np.asarray(vs)))
    jkw.update(kv_k_scale=ks, kv_v_scale=vs)
  return (q, k, v, sel, C, kw), (jnp.asarray(q.numpy()), jk, jv,
                                  jnp.asarray(sel.numpy()), jkw)


MMA_GATHER_CASES = ["dec_extras", "padded", "equal_keys", "all_padded",
                    "all_padded_no_extras", "plain"]
MMA_GATHER_KINDS = [("none", c) for c in MMA_GATHER_CASES] + [
    (kind, c) for kind in ("int8", "fp8")
    for c in ("dec_extras", "padded", "equal_keys")]


@pytest.mark.parametrize("G,D", MMA_SHAPES)
@pytest.mark.parametrize("kind,case", MMA_GATHER_KINDS)
def test_latent_mma_gather_matches_plain(G, D, kind, case):
  """The tensor-core block_gather in every case of the card tests' inputs
  on a bf16 cache, and on int8 / fp8 codes with their per-cluster scales
  in the cases that select clusters, against the plain version; at SMOKE
  size also against the Pallas kernel in interpret mode."""
  (q, k, v, sel, C, kw), (jq, jk, jv, jsel, jkw) = _mma_gather_case(
      case, G, D, kind, seed=G + D)
  opts = dict(cluster_size=C, sm_scale=192 ** -0.5, cap=30.0)
  got = emulate_latent_mma_gather(q, k, v, sel, **opts, **kw)
  want = ref.fused_gather_attention_ref(q, k, v, sel, **opts, **kw)
  for g, w in zip(got, want):
    assert torch.isfinite(g).all()
    _close(g, w)
  if D == 48:
    for g, j in zip(got, j_block_gather(jq, jk, jv, jsel, interpret=True,
                                        **opts, **jkw)):
      _close(g, j)


def test_latent_mma_extras_are_one_part_beside_32_clusters():
  """deepseek-v2's budget-32 step: 32 clusters and E = 129 extras rows in
  one chunk are 33 parts, x 2 head tiles of 64 x B = 2 = 132 blocks, one
  wave of one block an SM; the exact path's S = 8192 is 32 chunks of 256
  rows (128 blocks), the self token one."""
  xrows, nparts = _parts(32, 129, True, _build.LATENT_MMA_EXTRAS_ROWS)
  assert (xrows, nparts) == (129, 33)
  assert nparts * _build.latent_mma_tiles(128) * 2 == H100_SMS
  groups = 2 * _build.latent_mma_tiles(128)
  assert _build.latent_mma_chunk(8192, groups, H100_SMS) == 256
  assert _build.latent_mma_chunk(1, groups, H100_SMS) == 16
  for S in (1, 65, 300, 1000, 8192, 8320):
    chunk = _build.latent_mma_chunk(S, groups, H100_SMS)
    assert chunk % _build.LATENT_MMA_ROWS == 0
    assert -(-S // chunk) * groups <= H100_SMS


def test_latent_mma_query_split_keeps_the_logits():
  """q_hi + q_lo carries the f32 query's logits at deepseek-v2's width (G
  = 128, D = 576, 8192 rows of bf16 latent) far inside the card tests'
  bf16 bound (rtol = atol = 1e-3), against a float64 reference; q rounded
  once to bf16 is reported beside it, not asserted to miss."""
  rng = np.random.default_rng(0)
  G, D, S = 128, 576, 8192
  q = torch.from_numpy(_normal(rng, G, D) * np.float32(3.0 * D ** -0.5))
  k = torch.from_numpy(_normal(rng, S, D)).bfloat16().float()
  sm = 192 ** -0.5
  want = (q.double() @ k.double().T) * sm
  hi, lo = _bf16_split(q)
  split = (hi @ k.T + lo @ k.T).double() * sm
  one = (hi @ k.T).double() * sm

  def excess(got):  # the largest |err| / (atol + rtol |want|)
    return float(((got - want).abs() / (1e-3 + 1e-3 * want.abs())).max())
  assert excess(split) < 0.01
  print(f"logit error / bf16 card bound: q_hi + q_lo {excess(split):.2e}, "
        f"q rounded once {excess(one):.2e}")


# ---------------------------------------------------------------------------
# The decode core's tensor-core stream (csrc/decode_mma.cuh): flash_decode
# and block_gather on bf16 rows for a group in the head bucket of 16
# (command-r-plus's G = 12).  The group's query rows are one 16-row M tile
# (rows past G zero and dead: p = 0), a block's tiles (_build's tile rows,
# at least 16) go to its teams of warps in turn (a warp a team at D <= 64;
# above, D / 64 warps read one tile and split O's columns: the same sums),
# each tile as 16-row steps: logits as f32 sums of exact bf16 products,
# the step's online softmax per head (the fragment's quad max and sum), P
# split into bf16 hi + lo through P.V; the warps' partials merge as the
# decode core's do, and the chunks (flash_decode) or parts with the
# decrement row (block_gather) as before.  Tolerance: the file's 2e-5
# (the P split keeps ~2^-17 of p; sums in other orders).
# ---------------------------------------------------------------------------

def _g16_geo(D):
  """(rows a tile, teams a block): the decode core's tile, at least one
  16-row step; the warps in teams of D / 64 above D = 64."""
  rows = max(16, _build.decode_tile_rows(D, 2))
  return rows, _build.DECODE_WARPS // max(1, D // 64)


def _g16_span(qg, k, v, logit, tile_rows=None):
  """One block of the tensor-core stream over the rows of k, v (..., n, D)
  (bf16 values as f32) for query groups qg (..., G, D); ``tile_rows`` (the
  CUDA-core stream's) is not its geometry.  Returns the unnormalised
  (acc, m, l) of the G live heads."""
  del tile_rows
  n, D = k.shape[-2:]
  lead, G = qg.shape[:-2], qg.shape[-2]
  q16 = torch.zeros(lead + (16, D))
  q16[..., :G, :] = qg
  live = (torch.arange(16) < G)[:, None]
  rows, readers = _g16_geo(D)
  ntiles = -(-n // rows)
  parts = []
  for w in range(readers):
    m = torch.full(lead + (16,), NEG_INF)
    l = torch.zeros(lead + (16,))
    acc = torch.zeros(lead + (16, D))
    for t in range(w, ntiles, readers):
      for r0 in range(t * rows, min(n, (t + 1) * rows), 16):
        r1 = min(n, r0 + 16)
        raw = torch.einsum("...gd,...rd->...gr", q16, k[..., r0:r1, :])
        x = torch.where(live, logit(raw, r0, r1), torch.tensor(NEG_INF))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(x - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        hi, lo = _bf16_split(p)
        acc = (acc * alpha[..., None]
               + torch.einsum("...gr,...rd->...gd", hi, v[..., r0:r1, :])
               + torch.einsum("...gr,...rd->...gd", lo, v[..., r0:r1, :]))
        m = m_new
    parts.append((acc[..., :G, :], m[..., :G], l[..., :G]))
  return _combine(parts)


def _bf16_inputs(*arrays):
  """numpy f32 arrays rounded to bf16: (torch bf16 tensors, numpy f32 of
  the same values for the Pallas kernels)."""
  ts = [_t(a).to(torch.bfloat16) for a in arrays]
  return ts, [t.float().numpy() for t in ts]


G16_DECODE_CASES = [(1, None, None), (65, "masked", None),
                    (8192, None, None), (8320, "masked", 30.0)]


@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,bias_kind,cap", G16_DECODE_CASES)
def test_g16_decode_design_matches_plain_and_pallas(G, D, S, bias_kind, cap):
  """flash_decode on the tensor-core stream in the chunks of the exact
  path's grid (B Hkv = 16) at this D: the self token, 65 rows with a
  masked log(count) bias, the whole cache and 8320 rows after an absorb
  with cap 30, against the plain version and the Pallas kernel."""
  B, Hkv = 1, 1 if S >= 8192 else 2
  rng = np.random.default_rng(G * D + S)
  (q, k, v), (jq, jk, jv) = _bf16_inputs(
      _normal(rng, B, Hkv * G, D), _normal(rng, B, Hkv, S, D),
      _normal(rng, B, Hkv, S, D))
  bias = None
  if bias_kind is not None:
    bias = np.log(rng.integers(1, 129, (B, Hkv, S))).astype(np.float32)
    bias[rng.random((B, Hkv, S)) < 0.4] = NEG_INF
  sm = D ** -0.5
  tb = None if bias is None else _t(bias)
  got = emulate_flash_decode(q, k, v, tb, sm_scale=sm, cap=cap,
                             chunk=_chunk(S, D, 2, 16, H100_SMS),
                             span=_g16_span)
  want = ref.flash_decode_ref(q, k, v, tb, sm_scale=sm, cap=cap)
  jax_out = jops._decode(jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv),
                         None if bias is None else jnp.asarray(bias), sm,
                         "interpret", cap=cap)
  for g, w, j in zip(got, want, jax_out):
    assert torch.isfinite(g).all()
    _close(g, w)
    _close(g, j)


@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("case", ["budget0", "equal_keys", "c16_padded",
                                  "absorbed_m65"])
def test_g16_gather_design_matches_plain_and_pallas(G, D, case):
  """block_gather on the tensor-core stream: every selected cluster a
  part (C = 16: one step; C = 128: several tiles), the decrement row of
  weight -1, the extras in chunks, padded ids, a part that cancels, extras
  only; against the plain version and the Pallas kernel."""
  q, k, v, sel, C, kw = _gather_case(case, seed=G + D, D=D, B=2, Hkv=1,
                                     G=G)
  names = sorted(n for n in kw if n not in ("sel_bias", "extras_bias"))
  (q, k, v, *rows), (jq, jk, jv, *jrows) = _bf16_inputs(
      q, k, v, *(kw[n] for n in names))
  tk = {**{n: _t(kw[n]) for n in ("sel_bias", "extras_bias") if n in kw},
        **dict(zip(names, rows))}
  jkw = {**{n: jnp.asarray(kw[n]) for n in ("sel_bias", "extras_bias")
            if n in kw}, **{n: jnp.asarray(a) for n, a in zip(names, jrows)}}
  opts = dict(cluster_size=C, sm_scale=D ** -0.5, cap=30.0)
  sel_t = _t(sel)
  B, H, _ = q.shape
  got = _finish(gather_parts(q, k, v, sel_t, **opts, **tk, span=_g16_span),
                B, H, D, True)
  want = ref.fused_gather_attention_ref(q, k, v, sel_t, **opts, **tk)
  jax_out = j_block_gather(jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv),
                           jnp.asarray(sel), interpret=True, **opts, **jkw)
  for g, w, j in zip(got, want, jax_out):
    assert torch.isfinite(g).all()
    _close(g, w)
    _close(g, j)


@pytest.mark.parametrize("name,dtype,G,mma", [
    ("flash_decode", torch.bfloat16, 12, True),
    ("flash_decode", torch.bfloat16, 9, True),
    ("flash_decode", torch.bfloat16, 16, True),
    ("flash_decode", torch.bfloat16, 8, False),
    ("flash_decode", torch.float32, 12, False),
    ("block_gather_attention", torch.bfloat16, 12, True),
    ("block_gather_attention", torch.bfloat16, 4, False),
    ("block_gather_attention", torch.int8, 12, False),
    ("block_gather_attention", torch.float32, 16, False),
    ("fused_synopsis_score_attention", torch.bfloat16, 12, False),
    ("synopsis_score", torch.bfloat16, 12, False)])
def test_g16_route_and_launch_key(name, dtype, G, mma):
  """The stream each wrapper passes to its C entry point (1 for the
  tensor-core stream, 0 for the CUDA-core loops) and the key its launch
  counts under, by the rows' dtype and the group: the tensor-core stream
  for bf16 in the head bucket of 16, the CUDA-core loops otherwise (stage
  1 and the score kernel always)."""
  assert _build.decode_mma(name, dtype, G) is mma
  key = _build.decode_branch(name, dtype, G)
  assert key == (f"{name}[{_build.DECODE_MMA}]" if mma else name)
  assert key in _build.LAUNCHES


@pytest.mark.parametrize("kernel", ["flash_decode", "block_gather"])
def test_g16_meta_branch_allocates_what_the_launch_does(kernel):
  """On ``meta`` (the dry run) each wrapper at command-r-plus's shape (G =
  12, bf16: the tensor-core stream) allocates its outputs and one scratch
  buffer of its parts' partials, as the launch does (the stream changes
  neither), and launches nothing."""
  from repro_torch.analysis.tracker import MemoryTracker
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  B, Hkv, G, D, S, C, I, E = 2, 8, 12, 128, 8192, 128, 32, 129
  H = Hkv * G
  meta = dict(device="meta", dtype=torch.bfloat16)
  q = torch.empty((B, H, D), **meta)
  k = torch.empty((B, Hkv, S, D), **meta)
  if kernel == "flash_decode":
    args, kw = (q, k, k), {}
    nparts = -(-S // _chunk(S, D, 2, B * Hkv, H100_SMS))
    fn = flash_decode
  else:
    ek = torch.empty((B, Hkv, E, D), **meta)
    kw = dict(cluster_size=C,
              k_sel=torch.empty((B, Hkv, I, D), **meta),
              v_sel=torch.empty((B, Hkv, I, D), **meta),
              sel_bias=torch.empty((B, Hkv, I), device="meta"),
              extras_k=ek, extras_v=ek,
              extras_bias=torch.empty((B, E), device="meta"))
    args = (q, k, k, torch.empty((B, Hkv, I), device="meta",
                                 dtype=torch.int32))
    nparts = _parts(I, E, True)[1]
    fn = gather
  assert _build.decode_mma(fn.__name__, torch.bfloat16, G)
  before = _build.launch_counts()
  fn(*args, **kw)                          # the merge tickets, made once
  with MemoryTracker((args, kw)) as trk:
    out = fn(*args, **kw)
    trk.finish(out)
  unit = lambda n: -(-n // 512) * 512  # noqa: E731
  assert trk.output_bytes == unit(B * H * D * 4) + 2 * unit(B * H * 4)
  assert trk.temp_bytes == unit(B * H * nparts * (D + 2) * 4)
  assert _build.launch_counts() == before

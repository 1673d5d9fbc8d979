"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; here it is held against the Pallas kernel run by the Pallas
interpreter, on the same numpy inputs, within 2e-5 (f32 on both sides,
sums taken in another order: the bound the JAX suite holds its own kernels
to).  Cases cover softcap None/30, ``-1``-padded and all-padded selections
with extras, the ragged M = 65 / E = 144 tails and absorb's identity
permutation, the five attention kernels at command-r-plus's GQA group
of 12 (the kernels' head bucket of 16 on the card), and deepseek-v2's MLA
shapes: the four decode kernels at one latent head (Hkv = 1) of D = 48
(G = 4, SMOKE) and 576 (G = 128, full width) with an f32 query beside
bf16 or f32 rows (the latent core on the card), and ``flash_prefill`` at
D = 192 with G = 1.

``test_torch_card.py`` holds each CUDA kernel against its plain version on
the card (that file imports no JAX, which the card's machine lacks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.block_gather_attention import (
    block_gather_attention as j_block_gather)
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.kernels.fused_synopsis import (
    fused_synopsis_score_attention as j_fused_synopsis)
from repro.kernels.synopsis_build import segment_build as j_segment_build
from repro.kernels.synopsis_score import synopsis_score as j_synopsis_score
from repro_torch.kernels import _build, ops
from repro_torch.kernels.block_gather_attention import block_gather_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_prefill import WGMMA_HEAD_DIMS, flash_prefill
from repro_torch.kernels.fused_synopsis import fused_synopsis_score_attention
from repro_torch.kernels.synopsis_build import segment_build
from repro_torch.kernels.synopsis_score import synopsis_score

TOL = dict(rtol=2e-5, atol=2e-5)
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  """Full-f32 products on both backends; one CPU thread (the suite runs
  several workers side by side)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _normal(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------

PREFILL = [
    # (B, S, Hkv, G, D, window) — S=100/192 leave a ragged final tile
    (1, 128, 1, 1, 64, None),
    (2, 192, 2, 4, 32, None),
    (1, 100, 2, 2, 16, None),
    (2, 96, 2, 4, 16, 40),
]


def _prefill_inputs(shape, seed=0):
  B, S, Hkv, G, D, _ = shape
  rng = np.random.default_rng(seed)
  return (_normal(rng, B, S, Hkv * G, D), _normal(rng, B, S, Hkv, D),
          _normal(rng, B, S, Hkv, D))


@pytest.mark.parametrize("shape", PREFILL)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_flash_prefill_matches_pallas(shape, cap):
  q, k, v = _prefill_inputs(shape)
  window = shape[-1]
  sm = shape[4] ** -0.5
  want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sm_scale=sm, cap=cap, window=window, block_q=64,
                         block_k=64, interpret=True)
  got = flash_prefill(_t(q), _t(k), _t(v), sm_scale=sm, cap=cap,
                      window=window)
  _close(got, want)


# ---------------------------------------------------------------------------
# segment_build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm_kind", ["clustered", "identity"])
def test_segment_build_matches_pallas(perm_kind):
  N, Hkv, S, D, C = 3, 2, 64, 16, 16
  rng = np.random.default_rng(1)
  k, v = _normal(rng, N, Hkv, S, D), _normal(rng, N, Hkv, S, D)
  if perm_kind == "identity":            # absorb of the recent ring
    perm = np.broadcast_to(np.arange(S, dtype=np.int32), (N, S))
  else:
    perm = np.stack([rng.permutation(S) for _ in range(N)]).astype(np.int32)
  want = j_segment_build(jnp.asarray(k), jnp.asarray(v), jnp.asarray(perm),
                         cluster_size=C, interpret=True)
  got = segment_build(_t(k), _t(v), _t(perm), cluster_size=C)
  assert len(got) == len(want) == 5
  for g, w in zip(got, want):
    assert tuple(g.shape) == tuple(w.shape)
    _close(g, w)


# ---------------------------------------------------------------------------
# fused_synopsis_score_attention (stage 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 4, 16, 8), (1, 2, 4, 32, 65)],
                         ids=["M8", "ragged_M65"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_fused_synopsis_matches_pallas(shape, cap):
  B, Hkv, G, D, M = shape
  rng = np.random.default_rng(2)
  q = _normal(rng, B, Hkv * G, D)
  k_syn, v_syn = _normal(rng, B, Hkv, M, D), _normal(rng, B, Hkv, M, D)
  counts = rng.integers(1, 17, (B, M)).astype(np.float32)
  cbias = np.log(counts)
  sm = D ** -0.5
  scores_w, part_w = j_fused_synopsis(
      jnp.asarray(q), jnp.asarray(k_syn), jnp.asarray(v_syn),
      jnp.asarray(cbias), sm_scale=sm, cap=cap, block_m=4, interpret=True)
  scores_g, part_g = fused_synopsis_score_attention(
      _t(q), _t(k_syn), _t(v_syn), _t(cbias), sm_scale=sm, cap=cap)
  _close(scores_g, scores_w)
  for g, w in zip(part_g, part_w):
    _close(g, w)


# ---------------------------------------------------------------------------
# block_gather_attention (stage 2, decrement + extras epilogues)
# ---------------------------------------------------------------------------

def _gather_inputs(case, S=128, seed=3):
  """Stage-2 inputs the way the serve step builds them: centroids are the
  clusters' means, the decrement bias is log(count), and extras are a
  128-row recent ring (100 valid) plus self-KV, padded 129 -> 144."""
  B, Hkv, G, D, C = 2, 2, 4, 16, 16
  M = S // C
  rng = np.random.default_rng(seed)
  q = _normal(rng, B, Hkv * G, D)
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  if case == "all_padded":
    sel = np.full((B, Hkv, 1), -1, np.int32)
  else:
    sel = np.stack([[rng.permutation(M)[:3] for _ in range(Hkv)]
                    for _ in range(B)]).astype(np.int32)
    if case == "padded":
      sel[0, 0, 1] = -1
      sel[1, :, 2] = -1
  kw = {}
  if case != "plain":
    k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
    v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
    safe = np.maximum(sel, 0)
    kw["k_sel"] = np.take_along_axis(k_syn, safe[..., None], axis=2)
    kw["v_sel"] = np.take_along_axis(v_syn, safe[..., None], axis=2)
    kw["sel_bias"] = np.full(sel.shape, np.log(C), np.float32)
    E = 144
    ek, ev = _normal(rng, B, Hkv, E, D), _normal(rng, B, Hkv, E, D)
    ek[:, :, 129:] = 0.0
    ev[:, :, 129:] = 0.0
    eb = np.zeros((B, E), np.float32)
    eb[:, 100:128] = NEG_INF          # ring slots not yet written
    eb[:, 129:] = NEG_INF             # padding
    kw.update(extras_k=ek, extras_v=ev, extras_bias=eb)
  return q, k, v, sel, C, kw


@pytest.mark.parametrize("case", ["plain", "dec_extras", "padded",
                                  "all_padded"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_block_gather_matches_pallas(case, cap):
  q, k, v, sel, C, kw = _gather_inputs(case)
  sm = q.shape[-1] ** -0.5
  want = j_block_gather(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sel),
      cluster_size=C, sm_scale=sm, cap=cap, interpret=True,
      **{n: jnp.asarray(a) for n, a in kw.items()})
  got = block_gather_attention(_t(q), _t(k), _t(v), _t(sel), cluster_size=C,
                               sm_scale=sm, cap=cap,
                               **{n: _t(a) for n, a in kw.items()})
  for g, w in zip(got, want):
    assert np.isfinite(np.asarray(g)).all()
    _close(g, w)


def test_block_gather_ragged_cache_after_absorb():
  """S = 144 (one absorbed 16-token cluster on top of 128): M = 9."""
  q, k, v, sel, C, kw = _gather_inputs("padded", S=144)
  sm = q.shape[-1] ** -0.5
  want = j_block_gather(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sel),
      cluster_size=C, sm_scale=sm, interpret=True,
      **{n: jnp.asarray(a) for n, a in kw.items()})
  got = block_gather_attention(_t(q), _t(k), _t(v), _t(sel), cluster_size=C,
                               sm_scale=sm,
                               **{n: _t(a) for n, a in kw.items()})
  for g, w in zip(got, want):
    _close(g, w)


# ---------------------------------------------------------------------------
# ops: the fused decode pipeline end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i_max", [0, 2, 9])
def test_synopsis_cache_attention_matches_pallas(i_max):
  """Stage 1 -> top-k -> stage 2 (decrement + ring + self) -> merge, on a
  ragged M = 9 synopsis with a partly filled 16-slot ring."""
  B, Hkv, G, D, C, M, R = 2, 2, 4, 16, 16, 9, 16
  S = M * C
  rng = np.random.default_rng(4)
  q = _normal(rng, B, Hkv * G, D)
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  k_syn = k.reshape(B, Hkv, M, C, D).mean(3)
  v_syn = v.reshape(B, Hkv, M, C, D).mean(3)
  counts = np.full((B, M), float(C), np.float32)
  rk, rv = _normal(rng, B, Hkv, R, D), _normal(rng, B, Hkv, R, D)
  rlen = np.full((B,), 5, np.int32)
  sk, sv = _normal(rng, B, Hkv, 1, D), _normal(rng, B, Hkv, 1, D)
  args = (q, k, v, k_syn, v_syn, counts, rk, rv, rlen, sk, sv)
  kw = dict(i_max=i_max, cluster_size=C, sm_scale=D ** -0.5)
  want = jops.synopsis_cache_attention(*map(jnp.asarray, args), **kw,
                                       impl="interpret")
  got = ops.synopsis_cache_attention(*map(_t, args), **kw)
  _close(got, want)


def test_build_extras_and_count_bias_match_jax():
  rng = np.random.default_rng(5)
  rk, rv = _normal(rng, 2, 2, 16, 8), _normal(rng, 2, 2, 16, 8)
  rlen = np.array([3, 3], np.int32)
  sk, sv = _normal(rng, 2, 2, 1, 8), _normal(rng, 2, 2, 1, 8)
  want = jops.build_extras(*map(jnp.asarray, (rk, rv, rlen)),
                           (jnp.asarray(sk), jnp.asarray(sv)))
  got = ops.build_extras(*map(_t, (rk, rv, rlen)), (_t(sk), _t(sv)))
  # The port leaves E = 17 unpadded (its kernel masks the ragged tail);
  # JAX pads to 32 with zero rows that its bias masks.
  E = 17
  for g, w in zip(got, want):
    assert g.shape[-1 if g.dim() == 2 else -2] == E
    w = np.asarray(w)
    np.testing.assert_array_equal(np.asarray(g), w[..., :E] if w.ndim == 2
                                  else w[..., :E, :])
  assert (np.asarray(want[0])[:, :, E:] == 0).all()
  assert (np.asarray(want[2])[:, E:] == NEG_INF).all()
  counts = np.array([[16.0, 0.0, 3.0]], np.float32)
  np.testing.assert_array_equal(ops.count_bias(_t(counts)).numpy(),
                                np.asarray(jops.count_bias(counts)))


def test_merge_partials_matches_jax():
  rng = np.random.default_rng(6)
  a = (_normal(rng, 2, 4, 8), _normal(rng, 2, 4), np.abs(_normal(rng, 2, 4)))
  b = (_normal(rng, 2, 4, 8), _normal(rng, 2, 4), np.abs(_normal(rng, 2, 4)))
  want = jops.merge_partials(tuple(map(jnp.asarray, a)),
                             tuple(map(jnp.asarray, b)))
  got = ops.merge_partials(tuple(map(_t, a)), tuple(map(_t, b)))
  for g, w in zip(got, want):
    _close(g, w)


# ---------------------------------------------------------------------------
# The five attention kernels at G = 12 (command-r-plus-104b's group)
# ---------------------------------------------------------------------------

def _g12(kernel, D, cap):
  """(port output, Pallas output) of one attention kernel at G = 12, Hkv =
  2, head dim D: q and the tables from one seed, the Pallas kernel in
  interpret mode."""
  B, Hkv, G, C, S = 2, 2, 12, 16, 128
  M = S // C
  rng = np.random.default_rng(D + (cap is not None))
  q = _normal(rng, B, Hkv * G, D)
  sm = D ** -0.5
  if kernel == "flash_prefill":
    qp, k, v = (_normal(rng, B, 80, Hkv * G, D), _normal(rng, B, 80, Hkv, D),
                _normal(rng, B, 80, Hkv, D))
    return (flash_prefill(_t(qp), _t(k), _t(v), sm_scale=sm, cap=cap),
            j_flash_prefill(jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v),
                            sm_scale=sm, cap=cap, block_q=16, block_k=16,
                            interpret=True))
  k, v = _normal(rng, B, Hkv, S, D), _normal(rng, B, Hkv, S, D)
  k_syn, v_syn = k.reshape(B, Hkv, M, C, D).mean(3), v.reshape(
      B, Hkv, M, C, D).mean(3)
  cbias = np.log(rng.integers(1, 17, (B, M)).astype(np.float32))
  if kernel == "flash_decode":
    bias = np.where(rng.random((B, Hkv, S)) < 0.1, NEG_INF,
                    0.0).astype(np.float32)
    return (flash_decode(_t(q), _t(k), _t(v), _t(bias), sm_scale=sm,
                         cap=cap),
            j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(bias), sm_scale=sm, cap=cap,
                           block_s=32, interpret=True))
  if kernel == "synopsis_score":
    return ((synopsis_score(_t(q), _t(k_syn), sm_scale=sm),),
            (j_synopsis_score(jnp.asarray(q), jnp.asarray(k_syn),
                              sm_scale=sm, block_m=4, interpret=True),))
  if kernel == "fused_synopsis":
    got = fused_synopsis_score_attention(_t(q), _t(k_syn), _t(v_syn),
                                         _t(cbias), sm_scale=sm, cap=cap)
    want = j_fused_synopsis(jnp.asarray(q), jnp.asarray(k_syn),
                            jnp.asarray(v_syn), jnp.asarray(cbias),
                            sm_scale=sm, cap=cap, block_m=4, interpret=True)
    return (got[0], *got[1]), (want[0], *want[1])
  sel = np.stack([[rng.permutation(M)[:3] for _ in range(Hkv)]
                  for _ in range(B)]).astype(np.int32)
  sel[1, 0, 2] = -1
  safe = np.maximum(sel, 0)[..., None]
  E = 17
  kw = dict(k_sel=np.take_along_axis(k_syn, safe, axis=2),
            v_sel=np.take_along_axis(v_syn, safe, axis=2),
            sel_bias=np.full(sel.shape, np.log(C), np.float32),
            extras_k=_normal(rng, B, Hkv, E, D),
            extras_v=_normal(rng, B, Hkv, E, D),
            extras_bias=np.where(np.arange(E) < 12, 0.0, NEG_INF)[None]
            .repeat(B, 0).astype(np.float32))
  return (block_gather_attention(_t(q), _t(k), _t(v), _t(sel),
                                 cluster_size=C, sm_scale=sm, cap=cap,
                                 **{n: _t(a) for n, a in kw.items()}),
          j_block_gather(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(sel), cluster_size=C, sm_scale=sm,
                         cap=cap, interpret=True,
                         **{n: jnp.asarray(a) for n, a in kw.items()}))


@pytest.mark.parametrize("kernel", ["flash_prefill", "fused_synopsis",
                                    "block_gather", "flash_decode",
                                    "synopsis_score"])
@pytest.mark.parametrize("D,cap", [(16, None), (32, 30.0)])
def test_g12_matches_pallas(kernel, D, cap):
  """The plain version of each attention kernel at G = 12 against its
  Pallas kernel (which takes any G); the card's kernels are built for
  groups up to GMAX = 16 and test_torch_card.py holds them to these plain
  versions at G = 7, 12 and 16."""
  assert 12 <= _build.GMAX
  got, want = _g12(kernel, D, cap)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert tuple(g.shape) == tuple(w.shape)
    assert np.isfinite(np.asarray(g)).all()
    _close(g, w)


# ---------------------------------------------------------------------------
# deepseek-v2's MLA shapes: the latent decode head, the D = 192 prefill
# ---------------------------------------------------------------------------

def _latent(kernel, G, D, kv_dtype):
  """(port output, Pallas output) of one decode kernel over one latent
  key/value head (Hkv = 1) of width D read by G query heads: an f32 query
  (the absorbed q_eff), the rows in ``kv_dtype`` (rounded alike on both
  sides), the Pallas kernel in interpret mode."""
  B, Hkv, C, S = 2, 1, 16, 128
  M = S // C
  rng = np.random.default_rng(G + D + (kv_dtype == "bf16"))
  q = _normal(rng, B, G, D) * np.float32(3.0 * D ** -0.5)
  sm = 192 ** -0.5
  jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kv_dtype == "bf16"
              else (jnp.float32, torch.float32))

  def both(a):
    """(port tensor, JAX array) of the same rows in kv_dtype."""
    return _t(a).to(tdt), jnp.asarray(a, jdt)
  (tk, jk), (tv, jv) = both(_normal(rng, B, Hkv, S, D)), both(
      _normal(rng, B, Hkv, S, D))
  kf, vf = tk.float().numpy(), tv.float().numpy()
  (tks, jks), (tvs, jvs) = both(kf.reshape(B, Hkv, M, C, D).mean(3)), both(
      vf.reshape(B, Hkv, M, C, D).mean(3))
  cbias = np.log(rng.integers(1, 17, (B, M)).astype(np.float32))
  jq = jnp.asarray(q)
  if kernel == "flash_decode":
    bias = np.where(rng.random((B, Hkv, S)) < 0.1, NEG_INF,
                    0.0).astype(np.float32)
    return (flash_decode(_t(q), tk, tv, _t(bias), sm_scale=sm),
            j_flash_decode(jq, jk, jv, jnp.asarray(bias), sm_scale=sm,
                           block_s=32, interpret=True))
  if kernel == "synopsis_score":
    return ((synopsis_score(_t(q), tks, sm_scale=sm),),
            (j_synopsis_score(jq, jks, sm_scale=sm, block_m=4,
                              interpret=True),))
  if kernel == "fused_synopsis":
    got = fused_synopsis_score_attention(_t(q), tks, tvs, _t(cbias),
                                         sm_scale=sm)
    want = j_fused_synopsis(jq, jks, jvs, jnp.asarray(cbias), sm_scale=sm,
                            block_m=4, interpret=True)
    return (got[0], *got[1]), (want[0], *want[1])
  sel = np.stack([[rng.permutation(M)[:3] for _ in range(Hkv)]
                  for _ in range(B)]).astype(np.int32)
  sel[1, 0, 2] = -1
  safe = np.maximum(sel, 0)[..., None]
  E = 17
  (tksel, jksel), (tvsel, jvsel) = both(np.take_along_axis(
      tks.float().numpy(), safe, axis=2)), both(np.take_along_axis(
          tvs.float().numpy(), safe, axis=2))
  (tek, jek), (tev, jev) = both(_normal(rng, B, Hkv, E, D)), both(
      _normal(rng, B, Hkv, E, D))
  sel_bias = np.full(sel.shape, np.log(C), np.float32)
  eb = np.where(np.arange(E) < 12, 0.0, NEG_INF)[None].repeat(
      B, 0).astype(np.float32)
  return (block_gather_attention(
      _t(q), tk, tv, _t(sel), cluster_size=C, sm_scale=sm, k_sel=tksel,
      v_sel=tvsel, sel_bias=_t(sel_bias), extras_k=tek, extras_v=tev,
      extras_bias=_t(eb)),
          j_block_gather(jq, jk, jv, jnp.asarray(sel), cluster_size=C,
                         sm_scale=sm, k_sel=jksel, v_sel=jvsel,
                         sel_bias=jnp.asarray(sel_bias), extras_k=jek,
                         extras_v=jev, extras_bias=jnp.asarray(eb),
                         interpret=True))


@pytest.mark.parametrize("kernel", ["fused_synopsis", "block_gather",
                                    "flash_decode", "synopsis_score"])
@pytest.mark.parametrize("G,D", [(4, 48), (128, 576)])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_latent_decode_matches_pallas(kernel, G, D, kv_dtype):
  """The plain version of each decode kernel at MLA's latent shapes (what
  the latent core runs on the card: D in LATENT_HEAD_DIMS, G up to
  LATENT_GMAX, an f32 query beside bf16 or f32 rows) against its Pallas
  kernel, which casts the query to f32 as the plain version does."""
  assert D in _build.LATENT_HEAD_DIMS and G <= _build.LATENT_GMAX
  got, want = _latent(kernel, G, D, kv_dtype)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert tuple(g.shape) == tuple(w.shape)
    assert np.isfinite(np.asarray(g)).all()
    _close(g, w)


@pytest.mark.parametrize("S", [64, 100])
def test_mla_prefill_d192_matches_pallas(S):
  """flash_prefill at deepseek-v2's MLA prefill width (D = qk_nope +
  qk_rope = 192, v zero-padded to it, G = 1, scale 192^-0.5) against the
  Pallas kernel; the card's wgmma kernel takes D = 192 in bf16."""
  assert 192 in WGMMA_HEAD_DIMS
  rng = np.random.default_rng(S)
  q, k = _normal(rng, 1, S, 2, 192), _normal(rng, 1, S, 2, 192)
  v = np.zeros((1, S, 2, 192), np.float32)
  v[..., :128] = _normal(rng, 1, S, 2, 128)
  sm = 192 ** -0.5
  got = flash_prefill(_t(q), _t(k), _t(v), sm_scale=sm)
  want = j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sm_scale=sm, block_q=16, block_k=16, interpret=True)
  _close(got, want)
  assert not got[..., 128:].any()

#!/usr/bin/env python3
"""Device times of the synopsis build, stage-1 and latent-core kernels of
whichever ``repro_torch`` is on ``PYTHONPATH``, at the serving loop's
shapes.

  PYTHONPATH=<tree>/src python3 tools/kernel_times.py --label <tree>

Run it for two trees in turns in one call on one card (parent, change,
change, parent) to compare them: each run builds its tree's kernels into
that tree's own ``build/``.  It times, with the profiler's rows of the
kernel's own launches (median over ``--rounds`` turns of 20 calls each):

* ``segment_build`` at the build's shape (N = 64 = B * layers, Hkv = 8,
  S = 8192, D = 128, C = 128), bf16 and f32, under every quant spec;
* ``fused_synopsis_score_attention`` at the loop's shape (q (2, 32, 128),
  tables (2, 8, M, 128)) at M = 64, 65 and 1024, on bf16, int8 and fp8
  tables, warm and L2-cold (256 MB written and read back before each
  call);
* ``synopsis_score`` (``--only score``) at the unfused op's shape (q (2,
  32, 128), k_syn (2, 8, M, 128)) at M = 64, 65 and 1024, bf16 and f32,
  warm and L2-cold.  Its rows are matched by the first version's kernel
  name and by the redesigned one's, so the tool reads either tree;
* the latent core (``--only latent``) at deepseek-v2's absorbed decode (an
  f32 query of 128 heads over one latent head of 576): ``flash_decode``
  over the exact loop's bf16 cache (2, 1, 8192, 576) and over the self
  token, and ``block_gather_attention`` over 32 clusters of 128 rows of
  an 8192-row cache with the 129 extras rows (the ring and the self token)
  and the decrement rows, on a bf16 cache and on int8 / fp8 codes (bf16
  extras; f32 decrement rows beside the codes), warm and L2-cold, each
  beside its bound both ways: bytes, and the operations the tensor-core
  kernels issue (every product twice: the query and P split in bf16
  halves) at the bf16 tensor rate, the decrement rows' at the f32 rate.
  A call's time sums its rows (the main kernel's and, where it has one,
  the merge launch's), so it reads either tree;
* the head bucket of 16 (``--only g16``) at command-r-plus's decode (96 /
  8 heads of 128, G = 12, bf16): ``flash_decode`` over the exact loop's
  cache (2, 8, 8192, 128), beside SDPA on the same inputs (GQA, one
  query; its device rows, warm), and over the self token (S = 1);
  ``block_gather_attention`` over 32 clusters of 128 rows of the 8192-row
  cache with the 129 extras rows and the decrement rows; warm and
  L2-cold, each beside its byte bound.  The same calls at arctic-480b's G
  = 7, llama3-8b's G = 4 and gemma2-2b's D = 256 (``G16_SHAPES``: the
  CUDA-core loops in every tree) are data points beside it; the kernels'
  rows keep their names in every tree.

``--chunking BLOCKS_PER_SM,MIN_CHUNK`` sets the chunk rule of the split
decode kernels (``flash_decode._chunk``, which stage 1 follows in a tree
whose stage 1 splits).  Prints one JSON object a line, with the card's
name and power limit.
"""
import argparse
import json
import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
FLUSH = []


def _flush_l2():
  if not FLUSH:
    FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.float32,
                             device="cuda"))
  FLUSH[0].zero_()
  FLUSH[0].sum()


def device_ms(fn, names, reps=20, cold=False, tries=5):
  """Device time of one call: the profiler rows whose name holds one of
  ``names``, over ``reps`` calls, per launch recorded (a call launches
  the kernel once; a session may lose a record); a session that recorded
  no launch is run again."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(tries):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        if cold:
          _flush_l2()
        fn()
      torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and any(n in e.key for n in names)]
    if rows:  # each row's time a launch, times its launches a call
      return sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / reps)) for e in rows) / 1e3
  raise AssertionError(f"the profiler lost launches of {names}")


def nbytes(*tensors):
  return sum(t.numel() * t.element_size() for t in tensors)


def build_times(g, rounds, label, smi):
  from repro_torch.kernels.synopsis_build import segment_build
  N, Hkv, S, D, C = 64, 8, 8192, 128, 128
  for dtype in (torch.bfloat16, torch.float32):
    k = torch.randn((N, Hkv, S, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((N, Hkv, S, D), generator=g, device="cuda").to(dtype)
    perm = torch.argsort(torch.rand((N, S), generator=g, device="cuda"),
                         dim=-1).to(torch.int32)
    for spec in (None, "int8", "fp8", "int8+kv", "fp8+kv"):
      fn = lambda: segment_build(k, v, perm, cluster_size=C, quant=spec)
      out = fn()
      outs = out if spec is None else tuple(out.values())
      bound = nbytes(k, v, perm, *outs) / HBM_BYTES_PER_S * 1e3
      t = statistics.median(device_ms(fn, ("segment_build_kernel",))
                            for _ in range(rounds))
      print(json.dumps({"tree": label, "kernel": "segment_build",
                        "spec": spec or "none", "dtype": str(dtype)[6:],
                        "device_ms": t, "bound_ms": bound,
                        "share": bound / t, "card": smi}), flush=True)
      del out, outs
    del k, v
    torch.cuda.empty_cache()


def stage1_times(g, rounds, label, smi):
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.fused_synopsis import (
      fused_synopsis_score_attention as fused)
  B, Hkv, G, D = 2, 8, 4, 128
  for M in (64, 65, 1024):
    q = torch.randn((B, Hkv * G, D), generator=g, device="cuda").to(
        torch.bfloat16)
    cbias = torch.full((B, M), 4.85, device="cuda")
    for kind in ("none", "int8", "fp8"):
      kt = torch.randn((B, Hkv, M, D), generator=g, device="cuda")
      vt = torch.randn((B, Hkv, M, D), generator=g, device="cuda")
      if kind == "none":
        tables, kw = (kt.to(torch.bfloat16), vt.to(torch.bfloat16)), {}
      else:
        (kq, ks), (vq, vs) = (qt.quantize_rows(kt, kind),
                              qt.quantize_rows(vt, kind))
        tables, kw = (kq, vq), dict(k_scale=ks, v_scale=vs)
      fn = lambda: fused(q, *tables, cbias, sm_scale=D ** -0.5, **kw)
      out = fn()
      bound = nbytes(q, *tables, cbias, *kw.values(), out[0],
                     *out[1]) / HBM_BYTES_PER_S * 1e3
      warm = statistics.median(device_ms(fn, ("fused_synopsis_kernel",))
                               for _ in range(rounds))
      cold = statistics.median(device_ms(fn, ("fused_synopsis_kernel",),
                                         cold=True) for _ in range(rounds))
      print(json.dumps({"tree": label, "kernel": "fused_synopsis",
                        "kind": kind, "M": M, "device_ms": warm,
                        "device_ms_cold": cold, "bound_ms": bound,
                        "card": smi}), flush=True)


def score_times(g, rounds, label, smi):
  from repro_torch.kernels.synopsis_score import synopsis_score
  B, Hkv, G, D = 2, 8, 4, 128
  rows = ("synopsis_score_kernel", "synopsis_score_warp_kernel")
  for dtype in (torch.bfloat16, torch.float32):
    for M in (64, 65, 1024):
      q = torch.randn((B, Hkv * G, D), generator=g, device="cuda").to(dtype)
      k_syn = torch.randn((B, Hkv, M, D), generator=g, device="cuda").to(
          dtype)
      fn = lambda: synopsis_score(q, k_syn, sm_scale=D ** -0.5)
      bound = nbytes(q, k_syn, fn()) / HBM_BYTES_PER_S * 1e3
      warm = statistics.median(device_ms(fn, rows) for _ in range(rounds))
      cold = statistics.median(device_ms(fn, rows, cold=True)
                               for _ in range(rounds))
      print(json.dumps({"tree": label, "kernel": "synopsis_score",
                        "dtype": str(dtype)[6:], "M": M, "device_ms": warm,
                        "device_ms_cold": cold, "bound_ms": bound,
                        "share_cold": bound / cold, "card": smi}),
            flush=True)


TENSOR_OPS_PER_S = 989e12  # H100 SXM, dense bf16


def _bounds(nbytes_, ops_):
  """The bound both ways: bytes over HBM, and the operations the function
  needs (4 H D a row) at the bf16 tensor rate; with the one that binds."""
  t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
  t_ops = ops_ / TENSOR_OPS_PER_S * 1e3
  return {"bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def latent_times(g, rounds, label, smi):
  from repro_torch.kernels import ops
  from repro_torch.kernels import quant as qt
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  B, H, S, D, C, I, E = 2, 128, 8192, 576, 128, 32, 129
  sm = 192 ** -0.5
  bf = torch.bfloat16

  def rnd(*shape):
    return torch.randn(shape, generator=g, device="cuda")

  def emit(kernel, fn, names, nbytes_, ops_, **extra):
    warm = statistics.median(device_ms(fn, names) for _ in range(rounds))
    cold = statistics.median(device_ms(fn, names, cold=True)
                             for _ in range(rounds))
    b = _bounds(nbytes_, ops_)
    print(json.dumps({"tree": label, "kernel": kernel, **extra,
                      "device_ms": warm, "device_ms_cold": cold, **b,
                      "share_warm": b["bound_ms"] / warm,
                      "share_cold": b["bound_ms"] / cold, "card": smi}),
          flush=True)

  q = rnd(B, H, D) * (3.0 * D ** -0.5)
  k, v = rnd(B, 1, S, D).to(bf), rnd(B, 1, S, D).to(bf)
  fd_rows = ("latent_flash_decode", "latent_merge_kernel")
  for name, (kk, vv) in (("cache", (k, v)),
                         ("self token", (k[:, :, :1].contiguous(),
                                         v[:, :, :1].contiguous()))):
    fn = lambda kk=kk, vv=vv: flash_decode(q, kk, vv, sm_scale=sm)
    out = fn()
    n = kk.shape[2]
    emit("flash_decode", fn, fd_rows, nbytes(q, kk, vv, *out),
         4 * B * H * n * D, span=name, S=n)

  M = S // C
  sel = torch.stack([torch.randperm(M, generator=g, device="cuda")[:I]
                     for _ in range(B)])[:, None].to(torch.int32)
  safe = sel.long()[..., None].expand(-1, -1, -1, D)
  k_syn = k.float().reshape(B, 1, M, C, D).mean(3)
  v_syn = v.float().reshape(B, 1, M, C, D).mean(3)
  ek, ev, eb = ops.build_extras(rnd(B, 1, E - 1, D).to(bf),
                                rnd(B, 1, E - 1, D).to(bf), None,
                                (rnd(B, 1, 1, D).to(bf),
                                 rnd(B, 1, 1, D).to(bf)))
  sel_bias = torch.full((B, 1, I), 4.85, device="cuda")
  rows = B * I * C
  for kind in ("none", "int8", "fp8"):
    if kind == "none":
      kc, vc, kw = k, v, {}
      dec = torch.gather(k_syn, 2, safe).to(bf), torch.gather(
          v_syn, 2, safe).to(bf)
    else:
      (kc, ks), (vc, vs) = (qt.quantize_rows(k.float(), kind, block=C),
                            qt.quantize_rows(v.float(), kind, block=C))
      kw = dict(kv_k_scale=ks, kv_v_scale=vs)
      dec = torch.gather(k_syn, 2, safe), torch.gather(v_syn, 2, safe)
    gkw = dict(cluster_size=C, sm_scale=sm, k_sel=dec[0], v_sel=dec[1],
               sel_bias=sel_bias, extras_k=ek, extras_v=ev, extras_bias=eb,
               **kw)
    fn = lambda kc=kc, vc=vc, gkw=gkw: gather(q, kc, vc, sel, **gkw)
    out = fn()
    nb = (nbytes(q, sel, *dec, sel_bias, ek, ev, eb, *kw.values(), *out)
          + 2 * rows * D * kc.element_size())
    emit("block_gather", fn, ("latent_gather", "latent_merge_kernel"), nb,
         4 * H * D * (rows + B * (E + I)), kind=kind)


# The decode shapes of --only g16: (arch, Hkv, G, D, cap).  command-r-plus's
# G = 12 takes the tensor-core stream in a tree that has it; the others
# stay on the CUDA-core loops in both trees, whose shared merge and
# staging a tree may change: arctic's G = 7 (the bucket of 8), llama3-8b's
# G = 4 and gemma2-2b's D = 256 (G = 2, softcap 50).
G16_SHAPES = (("command-r-plus-104b", 8, 12, 128, None),
              ("arctic-480b", 8, 7, 128, None),
              ("llama3-8b", 8, 4, 128, None),
              ("gemma2-2b", 4, 2, 256, 50.0))


def g16_times(g, rounds, label, smi):
  from repro_torch.kernels import ops
  from repro_torch.kernels.block_gather_attention import (
      block_gather_attention as gather)
  from repro_torch.kernels.flash_decode import flash_decode
  B, S, C, I, E = 2, 8192, 128, 32, 129
  bf = torch.bfloat16
  sdpa = torch.nn.functional.scaled_dot_product_attention

  def rnd(*shape):
    return torch.randn(shape, generator=g, device="cuda").to(bf)

  def emit(kernel, fn, names, nbytes_, cold=True, **extra):
    warm = statistics.median(device_ms(fn, names) for _ in range(rounds))
    cold_ms = (statistics.median(device_ms(fn, names, cold=True)
                                 for _ in range(rounds)) if cold else None)
    bound = nbytes_ / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"tree": label, "kernel": kernel, **extra,
                      "device_ms": warm, "device_ms_cold": cold_ms,
                      "bound_ms": bound, "share_warm": bound / warm,
                      "share_cold": None if cold_ms is None
                      else bound / cold_ms, "card": smi}), flush=True)

  for arch, Hkv, G, D, cap in G16_SHAPES:
    H, sm = Hkv * G, D ** -0.5
    at = dict(arch=arch, G=G, D=D)
    q, k, v = rnd(B, H, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    fn = lambda: flash_decode(q, k, v, sm_scale=sm, cap=cap)
    emit("flash_decode", fn, ("flash_decode_kernel",),
         nbytes(q, k, v, *fn()), **at, span="cache", S=S)
    if cap is None:  # SDPA has no softcap
      lib = lambda: sdpa(q[:, :, None], k, v, enable_gqa=True)
      emit("sdpa", lib, ("",), nbytes(q, k, v, lib()), cold=False, **at,
           span="cache", S=S)
    k1, v1 = k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
    fn = lambda: flash_decode(q, k1, v1, sm_scale=sm, cap=cap)
    emit("flash_decode", fn, ("flash_decode_kernel",),
         nbytes(q, k1, v1, *fn()), **at, span="self token", S=1)

    M = S // C
    sel = torch.stack([torch.stack([torch.randperm(M, generator=g,
                                                   device="cuda")[:I]
                                    for _ in range(Hkv)])
                       for _ in range(B)]).to(torch.int32)
    safe = sel.long()[..., None].expand(-1, -1, -1, D)
    k_syn = k.float().reshape(B, Hkv, M, C, D).mean(3).to(bf)
    v_syn = v.float().reshape(B, Hkv, M, C, D).mean(3).to(bf)
    ek, ev, eb = ops.build_extras(rnd(B, Hkv, E - 1, D),
                                  rnd(B, Hkv, E - 1, D), None,
                                  (rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D)))
    gkw = dict(cluster_size=C, sm_scale=sm, cap=cap,
               k_sel=torch.gather(k_syn, 2, safe),
               v_sel=torch.gather(v_syn, 2, safe),
               sel_bias=torch.full((B, Hkv, I), 4.85, device="cuda"),
               extras_k=ek, extras_v=ev, extras_bias=eb)
    fn = lambda: gather(q, k, v, sel, **gkw)
    nb = (nbytes(q, sel, gkw["k_sel"], gkw["v_sel"], gkw["sel_bias"], ek,
                 ev, eb, *fn())
          + 2 * B * Hkv * I * C * D * k.element_size())
    emit("block_gather", fn, ("block_gather_kernel",), nb, **at, S=S, I=I,
         E=E)
    del q, k, v, k1, v1, k_syn, v_syn, ek, ev, eb, gkw
    torch.cuda.empty_cache()


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--label", required=True)
  ap.add_argument("--rounds", type=int, default=3)
  ap.add_argument("--only", nargs="+", choices=("build", "stage1", "score",
                                                "latent", "g16"))
  ap.add_argument("--chunking", help="BLOCKS_PER_SM,MIN_CHUNK")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("kernel_times: no CUDA device")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  if args.chunking:
    from repro_torch.kernels import flash_decode
    bps, mc = map(int, args.chunking.split(","))
    flash_decode.BLOCKS_PER_SM, flash_decode.MIN_CHUNK = bps, mc
    args.label += f" chunking={bps},{mc}"
  g = torch.Generator("cuda").manual_seed(0)
  stages = {"build": build_times, "stage1": stage1_times,
            "score": score_times, "latent": latent_times,
            "g16": g16_times}
  for name, stage in stages.items():
    if args.only is None or name in args.only:
      stage(g, args.rounds, args.label, smi)


if __name__ == "__main__":
  main()

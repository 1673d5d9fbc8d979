"""Build and load the port's CUDA kernels, and count their launches.

Each source in ``csrc/*.cu`` is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds, not minutes)
under ``<repo>/build/repro_torch/``, at the first launch of any kernel;
later launches reuse it while it is newer than every source.  The build
uses ``-O3`` and no ``--use_fast_math``: the quantized encode needs the
IEEE-rounded ``1 / scale``.  The library is loaded with ``ctypes``:
pointers and the stream travel as ``c_void_p``, and every C entry point
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.

Nothing here runs at import: the CPU test suite imports every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Head dims and largest GQA group the decode kernels are built for
# (DISPATCH_HEAD_DIM and GMAX in csrc/attn_common.cuh).
HEAD_DIMS = (16, 32, 64, 128, 256)
GMAX = 16

# The latent decode core (csrc/latent_core.cuh): MLA's absorbed decode, one
# key/value head of D = kv_lora + rope read by up to LATENT_GMAX query heads
# with an f32 query (deepseek-v2: D = 576, G = 128; 48 and 4 at SMOKE
# size).  flash_decode, block_gather_attention,
# fused_synopsis_score_attention and synopsis_score take these widths
# there, and count those launches under their "latent" branch.
LATENT_HEAD_DIMS = (48, 576)
LATENT_GMAX = 128
LATENT = "latent"
# Its geometry (csrc/latent_core.cuh): a block takes LATENT_HEAD_TILE heads
# (8 warps of 2) and tiles of LATENT_TILE_ROWS rows; two blocks fit an SM
# at D = 576 in bf16 (74 KB of K/V stages, 128 registers a thread).
LATENT_HEAD_TILE = 16
LATENT_TILE_ROWS = 16
LATENT_BLOCKS_PER_SM = 2
# The latent core's tensor-core kernels (csrc/latent_mma.cuh): flash_decode
# on bf16 rows and block_gather on a bf16 / int8 / fp8 cache beside bf16
# extras (f32 rows stay on the kernels above).  A block takes
# LATENT_MMA_HEADS heads (one wgmma M tile) and tiles of LATENT_MMA_ROWS
# rows, one block an SM (222 KB of shared memory at D = 576); a
# flash_decode chunk is at least LATENT_MMA_MIN_CHUNK rows (a block's query
# split costs about four tiles), and block_gather takes its extras in
# chunks of at most LATENT_MMA_EXTRAS_ROWS rows (E = 129: one chunk beside
# 32 clusters, 33 parts x 2 head tiles x B = 2 = 132 blocks).
LATENT_MMA_HEADS = 64
LATENT_MMA_ROWS = 16
LATENT_MMA_MIN_CHUNK = 64
LATENT_MMA_EXTRAS_ROWS = 256

# Geometry of the decode core (csrc/decode_core.cuh) that the wrappers of
# flash_decode, block_gather_attention and fused_synopsis_score_attention
# size their chunks by: a block
# has DECODE_WARPS warps, and a tile is whole rows, at most
# DECODE_TILE_BYTES of K and at most DECODE_TILE_ROWS rows.
DECODE_WARPS = 4
DECODE_TILE_BYTES = 4096
DECODE_TILE_ROWS = 64


# Streaming multiprocessors of the card the kernels are built for (NVIDIA
# H100 80GB HBM3, SXM5: 132): the decode wrappers size their chunks by the
# card's SM count, and a meta tensor (the dry run) takes this one.
H100_SMS = 132


def sm_count(device) -> int:
  """SMs of ``device``'s card; H100_SMS for the ``meta`` device."""
  import torch  # noqa: PLC0415
  if device.type == "meta":
    return H100_SMS
  return torch.cuda.get_device_properties(device).multi_processor_count


def is_meta(t) -> bool:
  """Whether ``t`` lies on the ``meta`` device: a wrapper then allocates
  what its kernel's launch allocates and launches nothing (the dry run's
  trace of a rank's program)."""
  return t.device.type == "meta"


def decode_tile_rows(D: int, itemsize: int) -> int:
  """Rows of one tile of the decode core for rows of D elements of
  ``itemsize`` bytes."""
  return min(DECODE_TILE_ROWS, DECODE_TILE_BYTES // (D * itemsize))


# The decode core's tensor-core stream (csrc/decode_mma.cuh): flash_decode
# and block_gather_attention on bf16 rows (query, cache and extras) for a
# group in the head bucket of 16, G in DECODE_MMA_GMIN .. GMAX
# (command-r-plus's G = 12), counted under each kernel's DECODE_MMA
# branch; the same grid, chunks and merges as the CUDA-core loops, which
# keep f32 rows, quantized caches, G <= 8 and stage 1.  The self token (S
# = 1) takes it too: it measured faster there than the CUDA-core loops'
# bucket of 16 (PERF.md §6).  Those loops are not built for bf16 rows in
# the bucket of 16 in either kernel.
DECODE_MMA = "g16"
DECODE_MMA_KERNELS = ("flash_decode", "block_gather_attention")
DECODE_MMA_GMIN = 9


def decode_mma(name: str, dtype, G: int) -> bool:
  """Whether kernel ``name`` streams rows of ``dtype`` (the query's too)
  read by a group of G on the tensor cores; the wrappers pass it to the C
  entry point as its route flag (1, else 0 for the CUDA-core loops)."""
  import torch  # noqa: PLC0415
  return (name in DECODE_MMA_KERNELS and dtype == torch.bfloat16
          and DECODE_MMA_GMIN <= G <= GMAX)


def decode_branch(name: str, dtype, G: int) -> str:
  """The launch-count key of the stream :func:`decode_mma` picks."""
  return branch(name, DECODE_MMA) if decode_mma(name, dtype, G) else name


# C entry point -> argtypes (see each .cu file's extern "C" function).
SIGNATURES = {
    "fused_synopsis_launch": [_P] * 14 + [_I] * 6 + [_F, _F, _I, _I, _P],
    "block_gather_launch": [_P] * 20 + [_I] * 9 + [_F, _F] + [_I] * 4 + [_P],
    "segment_build_launch": [_P] * 12 + [_I] * 8 + [_P],
    "flash_prefill_launch": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _I, _P],
    "flash_decode_launch": [_P] * 11 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "synopsis_score_launch": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
    "flash_decode_latent_launch": [_P] * 11 + [_I] * 8 + [_F, _F, _I, _I,
                                                          _P],
    "block_gather_latent_launch": [_P] * 20 + [_I] * 10 + [_F, _F]
                                  + [_I] * 4 + [_P],
    "fused_synopsis_latent_launch": [_P] * 15 + [_I] * 6 + [_F, _F, _I, _P],
    "synopsis_score_latent_launch": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
}

# Launch counts per kernel branch: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show it went through the
# kernels.  A quantized branch counts under its own key: the build under
# its spec, stage 1 and stage 2 under the storage type of the tables or
# cache they read quantized; the latent core's kernels under "latent", and
# its quantized stage 1 and stage 2 under "latent-int8" / "latent-fp8";
# the decode core's tensor-core stream under DECODE_MMA ("g16").
KERNELS = ("flash_prefill", "segment_build", "fused_synopsis_score_attention",
           "block_gather_attention", "flash_decode", "synopsis_score")
QUANT_BRANCHES = {
    "segment_build": ("int8", "fp8", "int8+kv", "fp8+kv"),
    "fused_synopsis_score_attention": ("int8", "fp8"),
    "block_gather_attention": ("int8", "fp8"),
}


def branch(name: str, quant: str = "none") -> str:
  """The launch-count key of kernel ``name``'s branch ``quant``."""
  return name if quant == "none" else f"{name}[{quant}]"


LATENT_KERNELS = ("fused_synopsis_score_attention", "block_gather_attention",
                  "flash_decode", "synopsis_score")


def latent_branch(kind: str = "none") -> str:
  """The latent core's branch of a kernel reading ``kind`` rows ("none",
  or a quantized arena's "int8" / "fp8")."""
  return LATENT if kind == "none" else f"{LATENT}-{kind}"


def _branches(name: str):
  quant = QUANT_BRANCHES.get(name, ())
  latent = ()
  if name in LATENT_KERNELS:
    latent = (LATENT, *(latent_branch(k) for k in ("int8", "fp8")
                        if k in quant))
  mma = (DECODE_MMA,) if name in DECODE_MMA_KERNELS else ()
  return (*quant, *latent, *mma)


LAUNCHES: Dict[str, int] = {
    key: 0 for name in KERNELS
    for key in (name, *(branch(name, q) for q in _branches(name)))
}

_lib = None
_lock = threading.Lock()
_tickets: Dict = {}
_tickets_superseded: list = []


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
  return dict(LAUNCHES)


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
  if cand.is_file():
    return str(cand)
  raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                     "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds):
  """Run the commands side by side; wait for every one, then raise on the
  first that failed.  Returns their outputs, in order."""
  procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for c in cmds]
  outs = [p.communicate()[0] for p in procs]
  for cmd, p, out in zip(cmds, procs, outs):
    if p.returncode != 0:
      raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n"
                         f"{out}")
  return outs


def build(force: bool = False, verbose: bool = False,
          log=print) -> pathlib.Path:
  """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link the
  shared library, unless an up-to-date library exists.  Returns its path.
  ``verbose`` gives ``log`` ptxas's register / shared-memory / spill report
  of each source under a ``[ptxas <file>]`` line."""
  sources = sorted(CSRC.glob("*.cu"))
  headers = sorted(CSRC.glob("*.cuh"))
  lib = BUILD_DIR / LIB_NAME
  if (not force and lib.is_file()
      and lib.stat().st_mtime >= max(p.stat().st_mtime
                                     for p in sources + headers)):
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tag = f"{os.getpid()}"
  objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
  nvcc = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3"]
  try:
    reports = _run_all([
        nvcc + ["-Xcompiler", "-fPIC", "-I", str(CSRC), "-c", str(src),
                "-o", str(obj), *(["-Xptxas=-v"] if verbose else [])]
        for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    _run_all([nvcc + ["-shared", "-o", str(tmp), *map(str, objs)]])
  finally:
    for obj in objs:
      obj.unlink(missing_ok=True)
  if verbose:
    for src, report in zip(sources, reports):
      log(f"[ptxas {src.name}]\n{report}".rstrip("\n"))
  os.replace(tmp, lib)
  return lib


def start_build(log=print) -> threading.Thread:
  """``build(force=True, verbose=True, log=log)`` on a thread of its own,
  started here, which holds the library's lock until the build ends: a
  kernel called meanwhile waits for it.  The thread's ``error`` is what
  the build raised, else None, and its ``seconds`` the build's wall time;
  join it before :func:`library`."""
  def run():
    t0 = time.perf_counter()
    try:
      with _lock:
        build(force=True, verbose=True, log=log)
    except BaseException as e:       # noqa: BLE001: re-raised by the joiner
      th.error = e
    th.seconds = time.perf_counter() - t0
  th = threading.Thread(target=run, name="kernel-build", daemon=True)
  th.error, th.seconds = None, float("nan")
  th.start()
  return th


def library() -> ctypes.CDLL:
  """The loaded kernel library (built on first use)."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(build()))
      for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      _lib = lib
  return _lib


def check(err: int, name: str) -> None:
  if err != 0:
    raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                       f"{err}")


def code_of(dtype) -> int:
  """C dtype code: 0 = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn."""
  import torch  # noqa: PLC0415
  return {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}[dtype]


def dtype_code(name: str, *tensors, allowed=None, views=()) -> int:
  """Check that the tensors lie on one CUDA device (or all on ``meta``),
  share one dtype and are contiguous; returns the C code of that dtype (0
  = float32, 1 = bfloat16, 2 = int8, 3 = float8_e4m3fn).  ``allowed``
  (default: float32, bfloat16 — the compute types) lists the dtypes the
  kernel was built for.  ``views`` share the device and dtype but may be strided (the
  kernel checks their strides itself)."""
  import torch  # noqa: PLC0415
  allowed = (torch.float32, torch.bfloat16) if allowed is None else allowed
  first = (tensors or views)[0]
  if first.device.type not in ("cuda", "meta"):
    raise ValueError(f"{name}: expected CUDA (or meta) tensors, got "
                     f"{first.device}")
  if first.dtype not in allowed:
    raise TypeError(f"{name}: dtype {first.dtype} not in {tuple(allowed)}")
  for i, t in enumerate((*tensors, *views)):
    if t.device != first.device or t.dtype != first.dtype:
      raise ValueError(f"{name}: tensors differ in device/dtype "
                       f"({t.device}, {t.dtype} vs {first.device}, "
                       f"{first.dtype})")
    if i < len(tensors) and not t.is_contiguous():
      raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not "
                       "contiguous")
  return code_of(first.dtype)


def storage_code(name: str, q, *tensors) -> int:
  """The code of the tables' storage dtype: the query ``q``'s own
  (unquantized) or int8 / float8_e4m3fn (quantized codes), on ``q``'s
  device."""
  import torch  # noqa: PLC0415
  code = dtype_code(name, *tensors, allowed=(q.dtype, torch.int8,
                                             torch.float8_e4m3fn))
  if tensors[0].device != q.device:
    raise ValueError(f"{name}: tensors lie on {tensors[0].device}, the "
                     f"query on {q.device}")
  return code


def scale_tensors(name: str, quantized: bool, shape, device, *scales):
  """The f32 scales of a quantized table or cache, one per row or cluster
  block (``shape``), contiguous on ``device``; None when unquantized.  A
  quantized table needs its scales, an unquantized one takes none."""
  import torch  # noqa: PLC0415
  given = [s is not None for s in scales]
  if quantized != all(given) or any(given) != all(given):
    raise ValueError(f"{name}: quantized tables take their scales and "
                     "unquantized ones none")
  if not quantized:
    return [None] * len(scales)
  out = []
  for s in scales:
    if tuple(s.shape) != tuple(shape) or s.device != device:
      raise ValueError(f"{name}: scale of shape {tuple(s.shape)} on "
                       f"{s.device}, expected {tuple(shape)} on {device}")
    out.append(s.to(torch.float32).contiguous())
  return out


def check_rows(name: str, D: int, G: int, *tensors) -> None:
  """The decode kernels (flash_decode, block_gather_attention,
  fused_synopsis_score_attention, synopsis_score) read a key row as whole
  16-byte vectors and keep G heads of state in registers: they are built
  for D in HEAD_DIMS and G <= GMAX, from 16-byte aligned tensors."""
  if D not in HEAD_DIMS or not 1 <= G <= GMAX:
    raise ValueError(f"{name}: head dim {D} / group {G} not built (D in "
                     f"{HEAD_DIMS}, G <= {GMAX})")
  check_aligned(name, *tensors)


def is_latent(D: int) -> bool:
  """Whether rows of width D go to the latent core."""
  return D in LATENT_HEAD_DIMS


def latent_codes(name: str, D: int, G: int, q, *tensors, views=(),
                 allowed=None) -> int:
  """The latent core's checks: D in LATENT_HEAD_DIMS, G <= LATENT_GMAX, an
  f32 query on the tensors' CUDA device, the tensors (and ``views``,
  whose strides the caller checks) of one type in ``allowed`` (default f32
  or bf16; a quantized arena's int8 / fp8 codes where the caller asks),
  all 16-byte aligned.  Returns their C dtype code."""
  import torch  # noqa: PLC0415
  if D not in LATENT_HEAD_DIMS or not 1 <= G <= LATENT_GMAX:
    raise ValueError(f"{name}: latent head dim {D} / group {G} not built (D "
                     f"in {LATENT_HEAD_DIMS}, G <= {LATENT_GMAX})")
  if q.dtype != torch.float32:
    raise TypeError(f"{name}: the latent core takes an f32 query, got "
                    f"{q.dtype}")
  code = dtype_code(name, *tensors, views=views, allowed=allowed)
  if q.device != (tensors or views)[0].device or not q.is_contiguous():
    raise ValueError(f"{name}: the query must be contiguous on "
                     f"{(tensors or views)[0].device}")
  check_aligned(name, q, *tensors, *views)
  return code


def latent_tiles(G: int) -> int:
  """Head tiles of the latent core (a grid dimension) for a group of G."""
  return -(-G // LATENT_HEAD_TILE)


def latent_chunk(S: int, blocks: int, sms: int) -> int:
  """Rows per block of a latent kernel's span of S rows, with ``blocks``
  blocks for each chunk: enough chunks for LATENT_BLOCKS_PER_SM blocks on
  each SM, whole tiles of LATENT_TILE_ROWS rows."""
  nsplit = max(1, min(-(-S // LATENT_TILE_ROWS),
                      -(-LATENT_BLOCKS_PER_SM * sms // blocks)))
  rows = -(-S // nsplit)
  return -(-rows // LATENT_TILE_ROWS) * LATENT_TILE_ROWS


def latent_mma(*tensors) -> bool:
  """Whether the latent core's rows (the K/V rows a kernel streams: the
  cache and the extras, None where absent) go to its tensor-core kernels:
  bf16 rows or a quantized arena's int8 / fp8 codes beside bf16 extras.
  f32 rows anywhere keep the CUDA-core kernels."""
  import torch  # noqa: PLC0415
  return all(t.dtype in (torch.bfloat16, torch.int8, torch.float8_e4m3fn)
             for t in tensors if t is not None)


def latent_mma_tiles(G: int) -> int:
  """Head tiles of the latent core's tensor-core kernels for a group of
  G."""
  return -(-G // LATENT_MMA_HEADS)


def latent_mma_chunk(S: int, groups: int, sms: int) -> int:
  """Rows per block of the tensor-core flash_decode over S rows, with
  ``groups`` blocks for each chunk (B * Hkv * head tiles): chunks of at
  least LATENT_MMA_MIN_CHUNK rows, at most one wave of one block an SM,
  whole tiles of LATENT_MMA_ROWS rows."""
  nsplit = max(1, min(-(-S // LATENT_MMA_MIN_CHUNK), sms // groups))
  rows = -(-S // nsplit)
  return -(-rows // LATENT_MMA_ROWS) * LATENT_MMA_ROWS


def check_aligned(name: str, *tensors) -> None:
  """16-byte vector loads and TMA copies need 16-byte aligned tensors."""
  for t in tensors:
    if t.data_ptr() % 16:
      raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not "
                       "16-byte aligned")


def partials(device, rows: int, parts: int, D: int):
  """Scratch of the decode kernels' chunk partials, one allocation: o
  (rows, parts, D), m and l (rows, parts) f32, and the tickets of their
  last-block merge (rows of (b, hkv) at most ``rows``)."""
  import torch  # noqa: PLC0415
  n = rows * parts
  buf = torch.empty(n * (D + 2), dtype=torch.float32, device=device)
  return (buf[:n * D], buf[n * D:n * (D + 1)], buf[n * (D + 1):],
          tickets(device, rows))


def tickets(device, n: int):
  """Zeroed int32 counters, at least ``n``, for the last-block merge of the
  decode kernels (one a (b, hkv) row), kept per device: the block that
  takes a row's last ticket resets it to 0, so the counters are zero
  between launches.  Launches that use them run one after another (one
  stream), as the port's do.

  A CUDA graph bakes in the address of the counters it was captured with,
  so a buffer that grows is replaced, never freed: the superseded one
  stays alive (and zero) for the graphs that still replay on it.  Growing
  while a graph is being captured would put the counters in the graph's
  pool, so it raises: allocate them at their largest row count first."""
  import torch  # noqa: PLC0415
  t = _tickets.get(device)
  if t is None or t.numel() < n:
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
      raise RuntimeError(
          f"merge tickets for {n} rows requested during a CUDA graph "
          "capture; allocate them before capturing")
    if t is not None:
      _tickets_superseded.append(t)
    t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    _tickets[device] = t
  return t


def stream_ptr(t) -> int:
  import torch  # noqa: PLC0415
  return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
  """Device pointer of a tensor, or NULL for None."""
  return ctypes.c_void_p(None if t is None else t.data_ptr())

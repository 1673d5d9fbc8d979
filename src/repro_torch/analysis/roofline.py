"""Three-term roofline of a dry-run cell on one NVIDIA H100 80GB HBM3,
700.00 W a rank (counterpart of ``repro.analysis.roofline``):

  compute    = FLOPs / PEAK_FLOPS    (989e12 bf16 dense FLOP/s)
  memory     = bytes / HBM_BW        (3.35e12 B/s HBM3)
  collective = collective bytes / COLL_BW (50e9 B/s)

per rank.  PEAK_FLOPS and HBM_BW are NVIDIA's H100 SXM data sheet's (the
numbers ``chip_smoke.py`` bounds its kernels by).  The production meshes
span 256 and 512 ranks, one card a rank, on nodes of 8 cards: a
collective over the `data` or `pod` axis, and over `model` as the mesh
lays ranks out row-major, crosses nodes, so COLL_BW is one card's NDR
InfiniBand link (400 Gb/s = 50e9 B/s).  Inside a node NVLink 4 would give
450e9 B/s a direction, but no collective of the production meshes stays
inside a node, so no term here reads it.

The FLOPs and bytes come from the analytic ``costmodel``; the collective
bytes from the tally of the mesh the rank's program ran on
(:func:`collective_bytes` of ``Mesh.stats`` / ``AbstractMesh.stats``);
the memory terms from the meta-device trace
(:func:`memory_summary` of an ``analysis.tracker.MemoryTracker``).  The
reference parses its collectives out of the compiled HLO text
(``_split_computations``, ``_trip_count``, ``_comp_multipliers``): the
port compiles nothing, its collectives are calls the mesh counts, so
those parsers have no counterpart here.

:func:`synopsis_traffic` and :func:`traffic_reduction` are the
reference's analytic per-stage synopsis bytes (DESIGN.md §15), unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.dist.sharding import COLLECTIVES

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # bf16 dense, tensor cores; H100 SXM data sheet
HBM_BW = 3.35e12           # B/s HBM3; H100 SXM data sheet
COLL_BW = 50e9             # B/s: one card's NDR InfiniBand link (400 Gb/s)


def collective_bytes(stats: Dict) -> Dict[str, int]:
  """Per-rank operand bytes of each kind of collective, and their
  ``total``, from a mesh's ``stats`` (the keys of the reference's)."""
  out = {k: int(stats.get(k, 0)) for k in COLLECTIVES}
  out["total"] = sum(out[k] for k in COLLECTIVES)
  return out


@dataclasses.dataclass
class Roofline:
  flops_per_device: float
  bytes_per_device: float
  coll_bytes_per_device: float
  chips: int
  model_flops: Optional[float] = None    # 6*N(active)*D for the cell

  @property
  def compute_s(self) -> float:
    return self.flops_per_device / PEAK_FLOPS

  @property
  def memory_s(self) -> float:
    return self.bytes_per_device / HBM_BW

  @property
  def collective_s(self) -> float:
    return self.coll_bytes_per_device / COLL_BW

  @property
  def dominant(self) -> str:
    terms = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
    return max(terms, key=terms.get)

  @property
  def bound_s(self) -> float:
    return max(self.compute_s, self.memory_s, self.collective_s)

  @property
  def useful_flops_ratio(self) -> Optional[float]:
    if self.model_flops is None:
      return None
    total = self.flops_per_device * self.chips
    return self.model_flops / total if total else None

  def to_dict(self) -> dict:
    return {
        "flops_per_device": self.flops_per_device,
        "bytes_per_device": self.bytes_per_device,
        "coll_bytes_per_device": self.coll_bytes_per_device,
        "chips": self.chips,
        "compute_s": self.compute_s,
        "memory_s": self.memory_s,
        "collective_s": self.collective_s,
        "dominant": self.dominant,
        "bound_s": self.bound_s,
        "model_flops": self.model_flops,
        "useful_flops_ratio": self.useful_flops_ratio,
    }


def memory_summary(tracker) -> dict:
  """The reference's ``memory_analysis`` keys from a finished
  ``MemoryTracker``: argument, output (every storage the step returns),
  temp (the peak of the step's own live storage beyond its new outputs),
  alias (returned storages that are arguments), generated code (0: no
  compiled module) and the peak a rank holds, argument + output + temp -
  alias."""
  out = {"argument_size_in_bytes": tracker.argument_bytes,
         "output_size_in_bytes": tracker.output_bytes,
         "temp_size_in_bytes": tracker.temp_bytes,
         "alias_size_in_bytes": tracker.alias_bytes,
         "generated_code_size_in_bytes": 0}
  out["peak_bytes_per_device"] = (
      out["argument_size_in_bytes"] + out["output_size_in_bytes"]
      + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
  return out


# -- analytic per-stage synopsis traffic (DESIGN.md §15) ---------------------
#
# The decode step's memory floor is what it must stream each token: stage
# 1 reads the whole synopsis (k_syn / v_syn + counts), stage 2 the I
# selected cluster blocks plus the decrement centroid rows.  Quantization
# shrinks exactly those streams; the per-row / per-block scales ride along
# as f32 and are charged here.

_QUANT_BYTES = {"none": None, "int8": 1, "fp8": 1}


def _quant_parts(quant: str):
  """(bytes an element of the quantized leaves or None, sorted_kv)."""
  q = quant or "none"
  kind, _, kv = q.partition("+")
  if kind not in _QUANT_BYTES or kv not in ("", "kv"):
    raise ValueError(f"unknown quant spec {quant!r}")
  return _QUANT_BYTES[kind], kv == "kv"


def synopsis_traffic(*, batch: int, kv_heads: int, m: int, d: int,
                     cluster_size: int, i_max: int, native_bytes: int = 4,
                     quant: str = "none") -> dict:
  """Per-decode-step bytes read by each synopsis stage.  ``native_bytes``
  is the element size of the unquantized arena (4 for f32, 2 for bf16);
  ``quant`` a spec of ``kernels.quant``.  Counts and scales are f32.  The
  query / output traffic, O(B H D), is left out of both arms."""
  qb, sorted_kv = _quant_parts(quant)
  syn_b = qb if qb is not None else native_bytes
  kv_b = qb if (qb is not None and sorted_kv) else native_bytes
  B, Hkv, M, D, C, I = batch, kv_heads, m, d, cluster_size, i_max

  s1 = {
      "k_syn": B * Hkv * M * D * syn_b,
      "v_syn": B * Hkv * M * D * syn_b,
      "counts": B * Hkv * M * 4,
  }
  if qb is not None:
    s1["scales"] = 2 * B * Hkv * M * 4          # k_syn_scale + v_syn_scale
  s2 = {
      "k_blocks": B * Hkv * I * C * D * kv_b,
      "v_blocks": B * Hkv * I * C * D * kv_b,
      "decrement_rows": 2 * B * Hkv * I * D * syn_b,
  }
  if qb is not None:
    s2["scales"] = 2 * B * Hkv * I * 4          # centroid-row scales
    if sorted_kv:
      s2["scales"] += 2 * B * Hkv * I * 4       # per-cluster k / v scales
  s1["total"] = sum(s1.values())
  s2["total"] = sum(s2.values())
  return {"stage1": s1, "stage2": s2,
          "total": s1["total"] + s2["total"]}


def traffic_reduction(quant: str, *, batch: int, kv_heads: int, m: int,
                      d: int, cluster_size: int, i_max: int,
                      native_bytes: int = 4) -> dict:
  """Bytes-read reduction of a quantized arm over the ``quant="none"`` arm
  of the same shapes: {"stage1": x, "stage2": x, "total": x}."""
  shape = dict(batch=batch, kv_heads=kv_heads, m=m, d=d,
               cluster_size=cluster_size, i_max=i_max,
               native_bytes=native_bytes)
  base = synopsis_traffic(quant="none", **shape)
  q = synopsis_traffic(quant=quant, **shape)
  return {k: base[k]["total"] / q[k]["total"] if isinstance(base[k], dict)
          else base[k] / q[k]
          for k in ("stage1", "stage2", "total")}

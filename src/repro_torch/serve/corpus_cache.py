"""Content-addressed synopsis cache: cross-request corpus sharing
(counterpart of ``repro.serve.corpus_cache``).

Requests that consult the same corpus (a shared index, a tenant's
documents, a system context) need the same prefill and synopsis build.
This module keys that work by corpus identity: the sha-256 of the token
ids plus a model and configuration fingerprint, so that the same tokens
under other weights, shapes, quant specs or devices are other corpora.

Each entry holds a refcounted, immutable arena: the B=1 synopsis cache
that the build produced (its shared half, ``kv_cache.ARENA_LEAVES``,
carries the data; its private half is zeros and ``pos``, and on a hybrid
the SSM state the publishing prefill left, as in the JAX arena, which is
the whole built dict) and the first token of the prefill.  The arena's
tensors live on the engine's device.  An admission that hits copies the
arena into its lane with ``kv_cache.write_slot`` (so a hybrid's lane
starts from the prompt's SSM state) and skips prefill and build: the
engine's graphs read the slot pool at fixed addresses, so a lane never
aliases an entry, and nothing ever writes to an entry.

A corpus that strictly extends a cached one replays only the extension:
a partial prefill of the extension tokens against the cached arena's
sorted KV (``prefill.make_extend_step``; softmax over the cached keys does
not depend on their order, and rope was applied at their true positions)
and an incremental build (``synopsis_kv.extend_synopsis``).

Eviction is LRU over entries nobody maps (refcount 0) only, so the cache
may exceed ``capacity`` while every entry is mapped.
``CacheConfig(capacity=0)`` is off: ``enabled`` is False and the engine
skips every cache branch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache as kvc

__all__ = ["CacheConfig", "CacheEntry", "CorpusCache", "corpus_key",
           "corpus_fingerprint", "supports_delta"]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
  """``capacity``: resident entries (0 = off); ``capacity_bytes``: an
  optional bound on the arenas' bytes too (0 = entries only);
  ``delta_unit`` > 0 allows prefix-extension lookups whose extension
  length is a multiple of it (the cluster size, so that the extension
  builds whole clusters), 0 exact hits only."""
  capacity: int = 0
  capacity_bytes: int = 0
  delta_unit: int = 0


@dataclasses.dataclass
class CacheEntry:
  """One published corpus: its immutable arena and admission outputs."""
  key: str
  tokens: np.ndarray              # (L,) int32, the corpus identity
  arena: Dict[str, torch.Tensor]  # B=1 synopsis cache on the device
  first_token: torch.Tensor       # (1,) from the prefill, on the device
  nbytes: int                     # bytes of the shared half
  refcount: int = 0               # live lane mappings
  last_use: int = 0               # LRU tick


def corpus_key(tokens, fingerprint: str = "") -> str:
  """Content address: sha-256 over the fingerprint and the token ids."""
  t = np.ascontiguousarray(np.asarray(tokens, np.int32))
  h = hashlib.sha256()
  h.update(fingerprint.encode())
  h.update(t.shape[0].to_bytes(8, "little"))
  h.update(t.tobytes())
  return h.hexdigest()


def corpus_fingerprint(cfg, device, prompt_len: int, seed: int) -> str:
  """Model and configuration identity folded into every key.  The port
  has no kernel ``impl``; the device type stands in its place, so that
  card arenas and CPU arenas never alias."""
  sc = cfg.synopsis
  dt = str(cfg.dtype).replace("torch.", "")
  return (f"{cfg.name}|dt={dt}|C={sc.cluster_size}|R={sc.recent}"
          f"|dev={torch.device(device).type}|S={prompt_len}|seed={seed}"
          f"|q={sc.quant}")


def supports_delta(cfg) -> bool:
  """Delta replay needs cached KV that is position-complete and
  order-free: global GQA attention with rope in every layer.  A sliding
  window (gemma2's local layers) couples the extension to the prefix's
  order; an encoder or cross blocks (whisper) and a frontend prefix
  (pixtral's patches) couple it to prefix inputs the arena does not hold,
  and a mamba layer (jamba) to the prefix's SSM state, and MLA (deepseek)
  caches a latent the extension's attention does not take; so such a
  config takes the full build on a prefix-extension miss, as in the JAX
  package.
  The FFN does not matter: arctic's MoE beside a dense MLP and command-r's
  parallel blocks replay deltas, as in the JAX package.
  (The engine also turns it off under a ``+kv`` quant spec, whose sorted
  cache holds int8 / fp8 blocks.)"""
  try:
    tf.check_supported(cfg)
  except NotImplementedError:
    return False
  return (cfg.encoder is None and cfg.frontend is None and cfg.mla is None
          and all(s.kind == "attn" and not s.local and not s.cross_attn
                  for s in cfg.block_pattern))


class CorpusCache:
  """Content-addressed, refcounted arena cache.

  Per admission: ``lookup`` classifies the corpus (hit / extend / miss)
  and counts it, ``acquire`` pins the mapped entry for the lane's
  residency, ``release`` unpins it at retirement, and a miss (or a
  finished delta replay) ``publish``-es its arena at refcount 1, held by
  the publishing lane.  Eviction runs at publish time."""

  def __init__(self, config: Optional[CacheConfig] = None,
               fingerprint: str = ""):
    self.config = config or CacheConfig()
    if self.config.capacity < 0:
      raise ValueError(f"capacity {self.config.capacity} < 0")
    self.fingerprint = fingerprint
    self.entries: Dict[str, CacheEntry] = {}
    self._tick = 0
    self.reset_stats()

  # -- introspection --------------------------------------------------------
  @property
  def enabled(self) -> bool:
    return self.config.capacity > 0

  @property
  def nbytes(self) -> int:
    return sum(e.nbytes for e in self.entries.values())

  def stats(self) -> Dict[str, float]:
    """Counters since the last ``reset_stats``."""
    looks = self._hits + self._delta_hits + self._misses
    return {"hits": self._hits, "misses": self._misses,
            "delta_hits": self._delta_hits, "evictions": self._evictions,
            "entries": len(self.entries), "bytes": self.nbytes,
            "hit_rate": (self._hits + self._delta_hits) / looks
            if looks else 0.0}

  def reset_stats(self) -> None:
    self._hits = self._misses = self._delta_hits = self._evictions = 0

  # -- lookup ---------------------------------------------------------------
  def _touch(self, e: CacheEntry) -> None:
    self._tick += 1
    e.last_use = self._tick

  def lookup(self, tokens, allow_extend: bool = True
             ) -> Tuple[str, Optional[CacheEntry]]:
    """("hit", entry) on an exact match; ("extend", entry) for the longest
    cached strict prefix whose extension length is a multiple of
    ``delta_unit``; ("miss", None) otherwise."""
    if not self.enabled:
      return "miss", None
    t = np.asarray(tokens, np.int32)
    e = self.entries.get(corpus_key(t, self.fingerprint))
    if e is not None:
      self._hits += 1
      self._touch(e)
      return "hit", e
    unit = self.config.delta_unit
    if allow_extend and unit > 0:
      best = None
      for cand in self.entries.values():
        L = cand.tokens.shape[0]
        if L < t.shape[0] and (t.shape[0] - L) % unit == 0 \
            and np.array_equal(cand.tokens, t[:L]) \
            and (best is None or L > best.tokens.shape[0]):
          best = cand
      if best is not None:
        self._delta_hits += 1
        self._touch(best)
        return "extend", best
    self._misses += 1
    return "miss", None

  # -- refcounts ------------------------------------------------------------
  def acquire(self, entry: CacheEntry, n: int = 1) -> CacheEntry:
    """Pin an entry for ``n`` mappings (a lookup does not pin)."""
    if n < 1:
      raise ValueError(f"acquire of {n} pins")
    entry.refcount += int(n)
    self._touch(entry)
    return entry

  def release(self, key: str, n: int = 1) -> None:
    """Unpin ``n`` mappings; the entry stays resident until capacity
    pressure evicts it.  Releasing more pins than are held raises."""
    if n < 1:
      raise ValueError(f"release of {n} pins")
    e = self.entries.get(key)
    if e is None:
      return
    if e.refcount < n:
      raise ValueError(
          f"release of {n} pins on entry {key[:12]} holding {e.refcount}")
    e.refcount -= int(n)

  # -- publish / evict ------------------------------------------------------
  def publish(self, tokens, arena: Dict[str, torch.Tensor],
              first_token) -> CacheEntry:
    """Insert a freshly built arena at refcount 1.  Publishing a corpus
    that is already cached pins the existing entry instead."""
    if not self.enabled:
      raise ValueError("publish on a disabled cache")
    t = np.ascontiguousarray(np.asarray(tokens, np.int32)).copy()
    key = corpus_key(t, self.fingerprint)
    e = self.entries.get(key)
    if e is not None:
      return self.acquire(e)
    e = CacheEntry(key=key, tokens=t, arena=arena, first_token=first_token,
                   nbytes=kvc.arena_nbytes(arena), refcount=1)
    self.entries[key] = e
    self._touch(e)
    self._evict()
    return e

  def _over_capacity(self) -> bool:
    cfg = self.config
    if len(self.entries) > cfg.capacity:
      return True
    return bool(cfg.capacity_bytes and self.nbytes > cfg.capacity_bytes)

  def _evict(self) -> None:
    """LRU over refcount-0 entries only: a mapped arena is never evicted."""
    while self._over_capacity():
      dead = [e for e in self.entries.values() if e.refcount == 0]
      if not dead:
        return
      victim = min(dead, key=lambda e: e.last_use)
      del self.entries[victim.key]
      self._evictions += 1

  def clear(self) -> None:
    """Drop every unpinned entry."""
    for key in [k for k, e in self.entries.items() if e.refcount == 0]:
      del self.entries[key]

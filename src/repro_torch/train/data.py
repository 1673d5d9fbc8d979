"""Deterministic, checkpointable data pipeline (the port's numpy-only copy
of ``repro.train.data``).

Synthetic but structured token streams (Zipf unigrams chained with a
bigram successor map, so that the loss can fall) generated from a PRNG
whose state is just (seed, step): restoring a checkpoint resumes the
stream exactly.  A byte-level corpus reader serves real text.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
  vocab: int
  seq_len: int
  global_batch: int
  seed: int = 0
  corpus_path: Optional[str] = None   # byte-level real text if set


class TokenStream:
  """Stateless per step: ``batch_at(step)`` is a pure function."""

  def __init__(self, cfg: DataConfig):
    self.cfg = cfg
    self.step = 0
    self._corpus = None
    if cfg.corpus_path:
      with open(cfg.corpus_path, "rb") as f:
        self._corpus = np.frombuffer(f.read(), dtype=np.uint8)

  def state_dict(self) -> dict:
    return {"step": self.step, "seed": self.cfg.seed}

  def load_state_dict(self, d: dict) -> None:
    self.step = int(d["step"])

  def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) (global_batch, seq_len) int32: labels are the
    tokens shifted by one."""
    cfg = self.cfg
    rng = np.random.default_rng((cfg.seed << 20) + step)
    B, S = cfg.global_batch, cfg.seq_len
    if self._corpus is not None:
      starts = rng.integers(0, len(self._corpus) - S - 1, size=B)
      tok = np.stack([self._corpus[s:s + S + 1] for s in starts]).astype(
          np.int32) % cfg.vocab
    else:
      base = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64) % cfg.vocab
      succ = (base[:, :-1] * 2654435761 % cfg.vocab).astype(np.int64)
      mix = rng.random((B, S)) < 0.5
      tok = np.concatenate(
          [base[:, :1], np.where(mix, succ, base[:, 1:])], axis=1
      ).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]

  def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    while True:
      yield self.batch_at(self.step)
      self.step += 1

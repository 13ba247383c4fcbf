"""Deterministic synthetic LM data pipeline, sharded per host (the port's
numpy-only copy of ``repro.data.pipeline``: the same batches bit for bit).

No external datasets ship offline, so the token stream is generated: a
mixture of per-sequence affine recurrences (``t_{i+1} = a·t_i + c (mod V)``)
with occasional noise tokens. The structure is learnable (loss drops well
below ``log V`` within tens of steps on a small model) yet has no files to
load — the pipeline still exercises the real at-scale concerns:

* determinism: batch ``k`` is a pure function of (seed, step, host) — a
  restart resumes bit-identically (tests/test_data.py);
* host sharding: each host generates a disjoint slice of the global batch
  (``host_id``/``n_hosts``), exactly how a 1000-node fleet feeds itself;
* prefetch: a depth-2 buffer overlaps generation with compute.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    n_patterns: int = 64


def _batch_rng(cfg: PipelineConfig, step: int, host_id: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id, 0xE1FC0DE]))


def synthetic_lm_batch(cfg: PipelineConfig, step: int, host_id: int = 0,
                       n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Returns {"tokens": [B_local, S], "labels": [B_local, S]} int32."""
    assert cfg.global_batch % n_hosts == 0
    b_local = cfg.global_batch // n_hosts
    rng = _batch_rng(cfg, step, host_id)
    v = cfg.vocab
    # per-sequence affine recurrence parameters from a small pattern pool
    pat = rng.integers(0, cfg.n_patterns, size=(b_local,))
    pool = np.random.default_rng(cfg.seed).integers(1, v, size=(cfg.n_patterns, 2))
    a, c = pool[pat, 0], pool[pat, 1]
    t0 = rng.integers(0, v, size=(b_local,))
    toks = np.empty((b_local, cfg.seq_len + 1), np.int64)
    toks[:, 0] = t0
    for i in range(cfg.seq_len):
        toks[:, i + 1] = (a * toks[:, i] + c) % v
    noise_mask = rng.random((b_local, cfg.seq_len + 1)) < cfg.noise
    toks = np.where(noise_mask, rng.integers(0, v, size=toks.shape), toks)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


class TokenPipeline:
    """Step-indexed iterator with a small prefetch buffer."""

    def __init__(self, cfg: PipelineConfig, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg, self.host_id, self.n_hosts = cfg, host_id, n_hosts
        self.step = start_step
        self._buf: collections.deque = collections.deque()
        self._prefetch = prefetch

    def _fill(self):
        while len(self._buf) < self._prefetch:
            self._buf.append(
                (self.step, synthetic_lm_batch(self.cfg, self.step,
                                               self.host_id, self.n_hosts)))
            self.step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        self._fill()
        return self._buf.popleft()

    def state(self) -> Dict[str, int]:
        """Checkpointable position (buffered batches are regenerated)."""
        return {"next_step": self.step - len(self._buf)}

    @staticmethod
    def restore(cfg: PipelineConfig, state: Dict[str, int], **kw) -> "TokenPipeline":
        return TokenPipeline(cfg, start_step=state["next_step"], **kw)

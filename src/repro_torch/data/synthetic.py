"""Deterministic synthetic data pipeline with sharded loading + exact resume.

Every batch is a pure function of (seed, step, host_shard), so:
  * each host materializes only its shard (no cross-host traffic),
  * restart-at-step-k reproduces the identical stream (checkpoint resume),
  * elastic re-sharding (N -> M hosts) replays the same global batches.

The token stream is a mixture of Zipf-distributed unigrams and shifted-copy
spans so the LM loss has learnable structure (quickstart shows it dropping).

A copy of ``src/repro/data/synthetic.py``: numpy only, so its batches are
bit-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_a: float = 1.2
    copy_prob: float = 0.5  # fraction of sequences containing a copy span


class SyntheticLM:
    """Sharded deterministic LM batches."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # Zipf-ish unigram distribution over the vocab (stable across hosts)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = (p / p.sum()).astype(np.float64)

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step``; rows are globally indexed so any host layout
        reproduces the same global batch."""
        c = self.cfg
        rows = range(self.host_id * self.local_batch,
                     (self.host_id + 1) * self.local_batch)
        toks = np.empty((self.local_batch, c.seq_len + 1), np.int32)
        for i, row in enumerate(rows):
            rng = self._rng(step, row)
            seq = rng.choice(c.vocab_size, size=c.seq_len + 1, p=self.p)
            if rng.random() < c.copy_prob and c.seq_len >= 32:
                span = c.seq_len // 4
                start = rng.integers(0, c.seq_len - 2 * span)
                seq[start + span : start + 2 * span] = seq[start : start + span]
            toks[i] = seq
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batches_for(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 1234,
                host_id: int = 0, num_hosts: int = 1):
    ds = SyntheticLM(
        DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                   global_batch=shape.global_batch),
        host_id=host_id, num_hosts=num_hosts)

    def gen(step: int) -> Dict[str, np.ndarray]:
        batch = ds.batch(step)
        extras = frontend_stub(cfg, shape, step)
        batch.update(extras)
        return batch

    return gen


def frontend_stub(cfg: ModelConfig, shape: ShapeConfig, step: int) -> dict:
    """Precomputed modality-frontend embeddings (assignment: stubs)."""
    out = {}
    rng = np.random.default_rng(np.random.SeedSequence([9, step]))
    if cfg.family == "vlm" and cfg.frontend:
        f = cfg.frontend
        out["patches"] = rng.standard_normal(
            (shape.global_batch, f.num_positions, f.embed_dim)).astype(np.float32) * 0.02
    if cfg.family == "audio" and cfg.frontend:
        src = max(1, shape.seq_len // cfg.encdec.src_ratio)
        out["frames"] = rng.standard_normal(
            (shape.global_batch, src, cfg.frontend.embed_dim)).astype(np.float32) * 0.02
    return out

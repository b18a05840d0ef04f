"""Synthetic data pipeline: deterministic, shardable token streams -- the
port's own copy of the reference's `repro.data.pipeline` (numpy alone; the
same generator streams, so the same tokens for the same seed, step and
shard), handing batches over as torch tensors on the requested device.

An infinite tokenized stream is defined by (seed, step) -> batch, so any
worker can materialize its own shard of any step independently (restart-
safe: the pipeline is a pure function of the step counter -- checkpointing
the step checkpoints the data position).  It mixes three synthetic
"domains" (uniform noise, Zipf unigram, copy-task spans) so training losses
move and MoE routers see non-uniform token statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_fraction: float = 0.3


class TokenPipeline:
    """`batch(step)` -> {"tokens": [B, S], "labels": [B, S]} (next-token),
    int32 tensors on `device` (the card unless the caller says otherwise);
    `numpy_batch` gives the same arrays in numpy."""

    def __init__(self, dc: DataConfig, device="cuda"):
        self.dc = dc
        self.device = device

    def _rng(self, step: int, shard: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step, shard]))

    def numpy_batch(self, step: int, shard: int = 0,
                    num_shards: int = 1) -> dict:
        dc = self.dc
        if dc.global_batch % num_shards:
            raise ValueError(f"global batch {dc.global_batch} does not "
                             f"split into {num_shards} shards")
        b = dc.global_batch // num_shards
        rng = self._rng(step, shard)
        s = dc.seq_len + 1
        zipf = rng.zipf(dc.zipf_a, size=(b, s)) % dc.vocab_size
        uniform = rng.integers(0, dc.vocab_size, size=(b, s))
        toks = np.where(rng.random((b, 1)) < 0.5, zipf, uniform)
        # copy-task spans: second half repeats the first (learnable structure)
        n_copy = int(b * dc.copy_fraction)
        if n_copy and s >= 4:
            half = s // 2
            toks[:n_copy, half:2 * half] = toks[:n_copy, :half]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.numpy_batch(step, shard,
                                             num_shards).items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pipeline_for(cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0, device="cuda") -> TokenPipeline:
    return TokenPipeline(DataConfig(seq_len, global_batch, cfg.vocab_size,
                                    seed), device)

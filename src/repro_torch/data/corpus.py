"""File-backed tokenized corpus reader (``repro/data/corpus.py``; a
nanoGPT-style .bin memmap).

Drop-in for :class:`repro_torch.data.synthetic.SyntheticLM`: the same
``batch(step, shard, num_shards)`` contract — deterministic in
(seed, step, shard), restart-safe, host-sharded — so
``train.loop.train(data=...)`` takes either one.  Numpy only: the same file
and seed give the reference's batches byte for byte.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np


class BinCorpus:
    """uint16/uint32 flat token file, sampled with a seeded rng per step."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 global_batch: int, seed: int = 0, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) <= seq_len + 1:
            raise ValueError(f"corpus of {len(self.tokens)} tokens is "
                             f"shorter than seq_len + 2 = {seq_len + 2}")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        if self.global_batch % num_shards:
            raise ValueError(f"global_batch {self.global_batch} not "
                             f"divisible by num_shards {num_shards}")
        b = self.global_batch // num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_521 + shard)
        starts = rng.integers(0, len(self.tokens) - self.seq_len - 1, size=b)
        rows = np.stack([np.asarray(self.tokens[s:s + self.seq_len + 1],
                                    dtype=np.int64) for s in starts])
        rows = np.clip(rows, 0, self.vocab_size - 1).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def stream(self, start_step: int = 0, shard: int = 0,
               num_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def write_corpus(path: str, tokens: np.ndarray, dtype=np.uint16):
    """Tokenizer-side helper: persist a flat token array."""
    arr = np.asarray(tokens).astype(dtype)
    with open(path, "wb") as f:
        arr.tofile(f)
    return os.path.getsize(path)

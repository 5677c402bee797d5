"""Deterministic synthetic LM data pipeline (the port's own copy of
``repro/data/synthetic.py``, numpy only: the same seed gives the same
batches bit for bit in both packages).

The container is offline, so OpenWebText is replaced by a seeded synthetic
token stream with real statistical structure (Zipfian unigrams + a noisy
order-k Markov chain), which gives losses that *decrease with training* —
required for the mixing-behavior experiments.  The stream is:

  * deterministic in (seed, step, host_shard): restart-safe — a resumed run
    sees exactly the continuation of the stream (checkpoint/restart tests
    rely on this);
  * host-shardable: each data-parallel host materializes only its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 2
    noise: float = 0.15              # fraction of uniform-random tokens


class SyntheticLM:
    """Zipf unigram + hashed Markov transitions; ~3.0-5.5 nats entropy."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1)
        self._unigram = (1.0 / ranks ** 1.1)
        self._unigram /= self._unigram.sum()
        # hashed transition structure: next ~ deterministic mix of context
        self._mix_a = rng.integers(1, 2**31 - 1)
        self._mix_b = rng.integers(1, 2**31 - 1)

    def _next_token(self, rng: np.random.Generator, ctx: np.ndarray) -> np.ndarray:
        V = self.cfg.vocab_size
        h = (ctx * self._mix_a).sum(-1) % (2**31)
        base = (h * self._mix_b) % V
        jitter = rng.choice(V, size=base.shape, p=self._unigram)
        noise = rng.random(base.shape) < self.cfg.noise
        step = rng.integers(0, 7, size=base.shape)
        nxt = (base + jitter * step) % V
        return np.where(noise, rng.integers(0, V, size=base.shape), nxt)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Batch for `step`, restricted to this host's shard."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_521 + shard)
        V, S, k = cfg.vocab_size, cfg.seq_len, cfg.markov_order
        toks = np.empty((b, S + 1), dtype=np.int32)
        toks[:, :k] = rng.choice(V, size=(b, k), p=self._unigram)
        for t in range(k, S + 1):
            toks[:, t] = self._next_token(rng, toks[:, t - k:t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def stream(self, start_step: int = 0, shard: int = 0,
               num_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def make_eval_batches(cfg: DataConfig, n: int, seed_offset: int = 10**9):
    """Fixed held-out batches (disjoint seeds from the training stream)."""
    ds = SyntheticLM(dataclasses.replace(cfg, seed=cfg.seed + seed_offset))
    return [ds.batch(i) for i in range(n)]

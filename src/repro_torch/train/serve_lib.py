"""Batched serving: the batch-to-completion wrapper over the serve engine
(``repro/train/serve_lib.py``).

``Generator`` keeps the reference's historical API (the pattern of
``loop.train`` over ``train/engine.ProgressiveTrainer``): it drives
``repro_torch.train.serve_engine.ServeEngine`` on one device, so the same
code path runs (one full-sequence prefill, then decode with fused
sampling).  The reference's ``mesh=`` argument becomes ``device=``: the
port serves from one card.

For real traffic shapes (staggered arrivals, ragged prompt and output
lengths) use ``ContinuousScheduler`` (re-exported here): iteration-level
scheduling over per-row cache cursors, admitting queued requests into freed
slots instead of stalling the batch on its longest request.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.train.serve_engine import GenerateResult, ServeEngine
from repro_torch.train.serve_scheduler import (ContinuousScheduler, Request,
                                               RequestResult)

__all__ = ["Generator", "GenerateResult", "ServeEngine",
           "ContinuousScheduler", "Request", "RequestResult"]


class Generator:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 cache_dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.max_len = max_len
        self.engine = ServeEngine(cfg, params, device=device, max_len=max_len,
                                  cache_dtype=cache_dtype)
        self.params = self.engine.params

    def generate(self, prompts: np.ndarray, num_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> GenerateResult:
        """prompts: (B, P) int32.  Greedy if temperature == 0."""
        return self.engine.generate(prompts, num_tokens,
                                    temperature=temperature, seed=seed)

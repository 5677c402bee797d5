"""Single-device serving engine: true prefill + a preallocated cache
(``repro/train/serve_engine.py``: ``GenerateResult`` and
``ServeEngine.generate``).

Prefill is one full-sequence forward through the train-path math that also
fills the cache; its attention runs the flash-attention kernel on the card.
Sampling runs inside both steps, so the decode loop is one step per token
with the sampled token, the cursor and the generator kept on the device;
nothing crosses to the host until the caller asks for the token matrix.
The engine runs on ``device`` (default ``cuda``); ``device="cpu"`` runs the
plain PyTorch path.  Continuous batching, paged KV and speculative decoding
come with ROADMAP queue A items 8-10; mesh sharding with item 13.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.train import steps as steps_lib


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray               # (B, prompt + generated)
    steps: int                       # generated tokens; the first comes out
                                     # of the one prefill call, so the decode
                                     # loop runs steps-1 invocations
    prefill_tokens: int = 0          # prompt tokens consumed by the prefill
    logits: Optional[np.ndarray] = None  # (B, generated, V) when requested
    prefill_s: float = 0.0           # wall time of the prefill
    decode_s: float = 0.0            # wall time of the decode loop


class ServeEngine:
    """Serving engine on one device (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params, device="cuda",
                 max_len: int = 512, cache_dtype=torch.float32):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Keep float32 matmuls around the kernel in full float32, as the
            # CPU reference computes them (cuDNN is off the path, stated
            # all the same).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.api = registry.get_model(cfg)
        if self.api.prefill is None:
            raise NotImplementedError(f"{cfg.name}: arch has no prefill path")
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.module = registry.ParamModule(params).to(self.device)
        self.params = self.module.tree()
        self._built = {}              # sample? -> (prefill, decode)

    def _steps(self, temperature: float):
        sample = temperature > 0
        if sample not in self._built:
            self._built[sample] = (
                steps_lib.make_prefill_step(self.cfg, sample=sample),
                steps_lib.make_serve_decode_step(self.cfg, sample=sample))
        return self._built[sample]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate_arrays(self, prompts, num_tokens: int,
                        temperature: float = 0.0, seed: int = 0,
                        collect_logits: bool = False):
        """Device-resident generation.  Returns ``(tokens (B, P+G) tensor,
        per-step logits list or None, (prefill_s, decode_s))``."""
        prompts = np.asarray(prompts, np.int32)
        B, P = prompts.shape
        if P + num_tokens > self.max_len:
            raise ValueError(f"prompt {P} + gen {num_tokens} exceeds "
                             f"max_len {self.max_len}")
        if self.cfg.position == "absolute" \
                and P + num_tokens - 1 > self.cfg.max_seq_len:
            # The last generated token is never fed back, so positions run
            # to P + G - 2.  The reference clamps past the table; torch
            # indexing cannot.
            raise ValueError(f"prompt {P} + gen {num_tokens} needs positions "
                             f"past max_seq_len {self.cfg.max_seq_len}")
        prefill, decode = self._steps(temperature)
        cache = self.api.init_cache(self.params, self.cfg, B, self.max_len,
                                    self.cache_dtype, device=self.device)
        toks = torch.from_numpy(prompts).long().to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        temp = temperature if temperature > 0 else None
        self._sync()
        t0 = time.perf_counter()
        nxt, logits, cache, index = prefill(self.params, toks, cache, temp,
                                            gen)
        self._sync()
        t1 = time.perf_counter()
        out: List[torch.Tensor] = [nxt]
        logs: Optional[List[torch.Tensor]] = \
            [logits] if collect_logits else None
        for _ in range(num_tokens - 1):
            nxt, logits, cache, index = decode(self.params, nxt, cache, index,
                                               temp, gen)
            out.append(nxt)
            if logs is not None:
                logs.append(logits)
        tokens = torch.cat([toks] + out, dim=1)
        self._sync()
        t2 = time.perf_counter()
        return tokens, logs, (t1 - t0, t2 - t1)

    def generate(self, prompts, num_tokens: int, temperature: float = 0.0,
                 seed: int = 0, return_logits: bool = False) -> GenerateResult:
        """prompts: (B, P) int32.  Greedy if temperature == 0."""
        prompts = np.asarray(prompts, np.int32)
        if num_tokens <= 0:
            return GenerateResult(prompts, steps=0,
                                  prefill_tokens=prompts.shape[1])
        tokens, logs, (pf_s, dec_s) = self.generate_arrays(
            prompts, num_tokens, temperature=temperature, seed=seed,
            collect_logits=return_logits)
        logits = (torch.cat(logs, dim=1).float().cpu().numpy()
                  if logs is not None else None)
        return GenerateResult(tokens.cpu().numpy().astype(np.int32),
                              steps=num_tokens,
                              prefill_tokens=prompts.shape[1], logits=logits,
                              prefill_s=pf_s, decode_s=dec_s)

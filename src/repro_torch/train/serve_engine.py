"""Single-device serving engine: true prefill + a preallocated cache, and
the continuous-batching primitives (``repro/train/serve_engine.py``:
``GenerateResult``, ``ContinuousState``, ``PrefillJob``, ``pow2_chunks``
and ``ServeEngine``).

Prefill is one full-sequence forward through the train-path math that also
fills the cache; on the card its attention runs the flash-attention kernel
and its RWKV6 layers the WKV kernel, and a cache of RWKV6 layers holds
their float32 recurrent state instead of K/V.
Sampling runs inside both steps, so the decode loop is one step per token
with the sampled token, the cursor and the generator kept on the device;
nothing crosses to the host until the caller asks for the token matrix.
The engine runs on ``device`` (default ``cuda``); ``device="cpu"`` runs the
plain PyTorch path.

Continuous batching (``continuous_state`` / ``prefill_request`` /
``admit_request`` / ``decode_masked``, driven by
``train.serve_scheduler.ContinuousScheduler``): each request is prefilled
alone at its exact length and scattered into a freed slot; one masked
decode step runs across all slots, and inactive rows are exact no-ops.
``paged=True`` replaces the per-slot cache rows with a block-paged pool
(``models.attention.init_paged_kv_cache`` + ``train.kv_pool.KVBlockPool``):
prompts are prefilled in power-of-two chunks straight into the pool
(``begin_prefill`` / ``prefill_chunk`` / ``admit_paged``), decode attends
through the block table with the paged-attention kernel on the card, and a
finished row's pages return to the pool at once (``free_slot``).  Greedy
tokens stay byte-identical to contiguous solo generation.  Continuous
batching serves attention layers only; recurrent carries come with ROADMAP
queue A item 17.  Speculative decoding, prefix sharing and quantized pages
come with items 9-10, fault injection with item 11, mesh sharding with
item 13.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.train import steps as steps_lib
from repro_torch.train.kv_pool import KVBlockPool
from repro_torch.tree import leaves_with_path

_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_QUANT = ("ROADMAP queue A item 10 (prefix sharing + quantized pages): "
          "{what} is not ported yet")


def resolve_kv_dtype(kv_dtype):
    """None, 'f32'/'bf16' or a float torch dtype -> torch dtype or None."""
    if kv_dtype is None:
        return None
    if isinstance(kv_dtype, str):
        if kv_dtype not in _KV_DTYPES:
            raise NotImplementedError(
                _QUANT.format(what=f"kv_dtype {kv_dtype!r}"))
        return _KV_DTYPES[kv_dtype]
    if not kv_dtype.is_floating_point or kv_dtype.itemsize < 2:
        raise NotImplementedError(_QUANT.format(what=f"kv_dtype {kv_dtype}"))
    return kv_dtype


@dataclasses.dataclass
class ContinuousState:
    """Device-resident continuous-batching decode state (one per run).

    ``tokens`` holds each row's next input token, ``index`` the per-row
    decode cursor, ``active`` which rows are live, ``limit`` each row's
    stop cursor (prompt_len + max_new - 1).  Everything stays on the device
    between iterations; the scheduler fetches (tokens, active) once per
    step.  Paged engines also carry the host page allocator (``pool``) and
    a persistent device block table, re-uploaded in stream order only when
    ``pool.version`` moved past ``table_version``."""
    tokens: torch.Tensor               # (B, 1) int64
    cache: dict                        # decode cache tree
    index: torch.Tensor                # (B,) int64 per-row cursor
    active: torch.Tensor               # (B,) bool
    limit: torch.Tensor                # (B,) int64
    generator: torch.Generator         # sampling stream (device)
    pool: Optional[KVBlockPool] = None
    block_table: Optional[torch.Tensor] = None   # (B, max_blocks) int32
    table_version: int = -1            # pool.version the device table holds
    table_host: Optional[np.ndarray] = None      # host copy last uploaded

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


@dataclasses.dataclass
class PrefillJob:
    """One request's in-flight chunked prefill (paged engines).

    The prompt runs as its binary decomposition into power-of-two chunks
    (largest first, optionally capped at the scheduler's ``chunk_len``),
    one chunk per scheduler iteration.  K/V lands directly in the shared
    pool through the row's block table; ``carry`` threads the B=1 per-row
    state between chunks."""
    row: int
    prompt: np.ndarray               # (P,) int32
    max_new_tokens: int
    chunks: list                     # chunk widths, consumed front to back
    carry: object                    # B=1 prefill carry
    ctx: int = 0                     # tokens prefilled so far
    first_token: object = None       # (1, 1) device token once sampled

    @property
    def done(self) -> bool:
        return not self.chunks


def pow2_chunks(n: int, cap: Optional[int] = None) -> list:
    """Binary decomposition of ``n`` into descending powers of two, each at
    most ``cap`` (rounded down to a power of two).  len(out) is O(log n +
    n / cap)."""
    if n < 1:
        raise ValueError(f"pow2_chunks({n})")
    cap2 = None
    if cap is not None:
        if cap < 1:
            raise ValueError(f"pow2_chunks cap {cap} < 1")
        cap2 = 1 << (cap.bit_length() - 1)
    out = []
    while n:
        c = 1 << (n.bit_length() - 1)
        if cap2 is not None:
            c = min(c, cap2)
        out.append(c)
        n -= c
    return out


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
                 max_len: int = 512, cache_dtype=torch.float32,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None, kv_dtype=None):
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
        self.paged = paged
        self.block_size = block_size
        self.num_blocks = num_blocks          # None: full provisioning
        # kv_dtype overrides the paged pool's storage dtype only (f32/bf16;
        # None keeps cache_dtype).
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.module = registry.ParamModule(params).to(self.device)
        self.params = self.module.tree()
        self._built = {}              # sample? -> (prefill, decode)
        self._cont_built = {}         # sample? -> (masked decode, admit)
        self._chunk_built = {}        # (final?, sample?) -> chunk step

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

    def check_lengths(self, prompt_len: int, num_tokens: int):
        """Raise if a request of ``prompt_len`` + ``num_tokens`` does not
        fit ``max_len``, or needs positions past ``max_seq_len``: the last
        generated token is never fed back, so positions run to P + G - 2.
        The reference clamps past the position table; torch indexing
        cannot (on the card it is a device-side assert)."""
        if prompt_len + num_tokens > self.max_len:
            raise ValueError(f"prompt {prompt_len} + gen {num_tokens} exceeds "
                             f"max_len {self.max_len}")
        if self.cfg.position == "absolute" \
                and prompt_len + num_tokens - 1 > self.cfg.max_seq_len:
            raise ValueError(f"prompt {prompt_len} + gen {num_tokens} needs "
                             f"positions past max_seq_len "
                             f"{self.cfg.max_seq_len}")

    def generate_arrays(self, prompts, num_tokens: int,
                        temperature: float = 0.0, seed: int = 0,
                        collect_logits: bool = False):
        """Device-resident generation.  Returns ``(tokens (B, P+G) tensor,
        per-step logits list or None, (prefill_s, decode_s))``."""
        prompts = np.asarray(prompts, np.int32)
        B, P = prompts.shape
        self.check_lengths(P, num_tokens)
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

    # -- continuous batching --------------------------------------------------

    def _cont_steps(self, temperature: float):
        """(masked decode, admit) for this engine's cache layout."""
        sample = temperature > 0
        if sample not in self._cont_built:
            admit = (steps_lib.make_paged_admit_step() if self.paged
                     else steps_lib.make_admit_step())
            self._cont_built[sample] = (
                steps_lib.make_serve_decode_step(self.cfg, sample=sample,
                                                 masked=True,
                                                 paged=self.paged), admit)
        return self._cont_built[sample]

    def _chunk_step(self, final: bool, temperature: float):
        key = (final, temperature > 0)
        if key not in self._chunk_built:
            self._chunk_built[key] = steps_lib.make_prefill_chunk_step(
                self.cfg, final=final, sample=temperature > 0)
        return self._chunk_built[key]

    def _resolved_num_blocks(self, batch: int) -> int:
        """Default pool size: full provisioning (batch * max_blocks pages,
        no overcommit).  A smaller ``num_blocks`` turns on block-granular
        admission."""
        if self.num_blocks is not None:
            return self.num_blocks
        return batch * self.max_blocks

    @property
    def max_blocks(self) -> int:
        return -(-self.max_len // self.block_size)

    def kv_bytes_per_token(self, kv_dtype="engine") -> float:
        """Device bytes ONE cached token costs in the paged pool, all
        layers.  ``kv_dtype='engine'`` prices this engine's pool; pass a
        dtype (or None for cache_dtype) to price another.  Shapes only:
        nothing is allocated."""
        if not self.paged:
            raise ValueError("kv_bytes_per_token is defined for paged "
                             "engines")
        kv = self.kv_dtype if kv_dtype == "engine" \
            else resolve_kv_dtype(kv_dtype)
        tree = self.api.init_paged_cache(
            self.params, self.cfg, 1, 1, self.block_size, self.max_len,
            self.cache_dtype, kv, device="meta")
        total = 0.0
        for path, leaf in leaves_with_path(tree):
            if steps_lib._is_paged_leaf(path):
                # num_blocks=1 pools hold 2 pages (1 + trash): halve.
                total += leaf.numel() * leaf.element_size() / 2
        return total / self.block_size

    def continuous_state(self, batch: int, temperature: float = 0.0,
                         seed: int = 0,
                         num_blocks: Optional[int] = None) -> ContinuousState:
        """Fresh all-slots-free decode state.  Paged engines also create
        the host page allocator (``num_blocks`` overrides the engine
        default), the pool and the device block table."""
        del temperature               # steps are built per call
        if transformer.has_recurrent_layers(self.cfg):
            raise NotImplementedError(transformer.CARRY_NOT_PORTED)
        dev = self.device
        pool = table = None
        if self.paged:
            nb = num_blocks if num_blocks is not None \
                else self._resolved_num_blocks(batch)
            pool = KVBlockPool(nb, self.block_size, batch, self.max_blocks)
            cache = self.api.init_paged_cache(
                self.params, self.cfg, batch, nb, self.block_size,
                self.max_len, self.cache_dtype, self.kv_dtype, device=dev)
            table = torch.empty((batch, self.max_blocks), dtype=torch.int32,
                                device=dev)
        else:
            cache = self.api.init_cache(self.params, self.cfg, batch,
                                        self.max_len, self.cache_dtype,
                                        device=dev)
        state = ContinuousState(
            tokens=torch.zeros((batch, 1), dtype=torch.long, device=dev),
            cache=cache,
            index=torch.zeros((batch,), dtype=torch.long, device=dev),
            active=torch.zeros((batch,), dtype=torch.bool, device=dev),
            limit=torch.zeros((batch,), dtype=torch.long, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
            pool=pool, block_table=table)
        return self._sync_table(state)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device, non_blocking=True)

    def prefill_request(self, state: ContinuousState, prompt,
                        temperature: float = 0.0):
        """ONE request's B=1 prefill at its exact prompt length (contiguous
        engines; paged engines use :meth:`begin_prefill` /
        :meth:`prefill_chunk`).  Returns ``(state, first_token (1,1) on the
        device, row_cache)``; nothing touches live batch rows."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        if prompt.shape[1] >= self.max_len:
            raise ValueError(f"prompt {prompt.shape[1]} exceeds max_len "
                             f"{self.max_len}")
        prefill, _ = self._steps(temperature)
        row_cache = self.api.init_cache(self.params, self.cfg, 1,
                                        self.max_len, self.cache_dtype,
                                        device=self.device)
        temp = temperature if temperature > 0 else None
        tok, _, row_cache, _ = prefill(self.params,
                                       self._upload(prompt.astype(np.int64)),
                                       row_cache, temp, state.generator)
        return state, tok, row_cache

    def admit_request(self, state: ContinuousState, row: int, first_token,
                      row_cache, prompt_len: int, max_new_tokens: int,
                      temperature: float = 0.0) -> ContinuousState:
        """Scatter a prefilled request into batch slot ``row`` (other rows
        untouched)."""
        _, admit = self._cont_steps(temperature)
        cache, tokens, index, active, limit = admit(
            state.cache, state.tokens, state.index, state.active,
            state.limit, row_cache, first_token, prompt_len,
            prompt_len + max_new_tokens - 1, row)
        return dataclasses.replace(state, cache=cache, tokens=tokens,
                                   index=index, active=active, limit=limit)

    def decode_masked(self, state: ContinuousState, temperature: float = 0.0,
                      eos_id: int = -1) -> ContinuousState:
        """One continuous-batching decode iteration over all slots.

        Active rows sample, write their cache at their own cursor and
        self-terminate on eos / per-row limit; inactive rows are no-ops.
        Paged engines read and write K/V through the block table,
        re-uploaded only when the pool changed it."""
        decode, _ = self._cont_steps(temperature)
        temp = temperature if temperature > 0 else None
        table = ()
        if self.paged:
            state = self._sync_table(state)
            table = (state.block_table,)
        tokens, _, cache, index, active = decode(
            self.params, state.tokens, state.cache, state.index,
            state.active, state.limit, eos_id, temp, state.generator, *table)
        return dataclasses.replace(state, tokens=tokens, cache=cache,
                                   index=index, active=active)

    # -- paged request lifecycle (chunked prefill through the pool) ---------

    def _sync_table(self, state: ContinuousState) -> ContinuousState:
        """Copy the host block table into the persistent device table iff
        the pool changed it.  The copy is queued on the current stream, so
        a decode already queued reads the old table and the next one the
        new.  A changed version whose bytes match the last upload copies
        nothing."""
        if state.pool is None or state.table_version == state.pool.version:
            return state
        host = state.pool.table
        if state.table_host is None or not np.array_equal(host,
                                                          state.table_host):
            host = host.copy()
            state.block_table.copy_(torch.from_numpy(host),
                                    non_blocking=True)
            state = dataclasses.replace(state, table_host=host)
        return dataclasses.replace(state, table_version=state.pool.version)

    def begin_prefill(self, state: ContinuousState, row: int, prompt,
                      max_new_tokens: int, chunk_len: Optional[int] = None,
                      temperature: float = 0.0, match=None):
        """Admit a request into the pool and start its chunked prefill.

        Commits the request's worst-case pages (``kv_pool``'s admission
        contract), assigns slot ``row`` and returns ``(state, job)``; drive
        the job with :meth:`prefill_chunk` once per scheduler iteration,
        then :meth:`admit_paged`.  A prefix-cache ``match`` comes with
        ROADMAP queue A item 10."""
        del temperature
        if match is not None:
            raise NotImplementedError(_QUANT.format(what="prefix sharing"))
        prompt = np.asarray(prompt, np.int32).ravel()
        P = len(prompt)
        if P >= self.max_len:
            raise ValueError(f"prompt {P} exceeds max_len {self.max_len}")
        state.pool.admit(row, P, max_new_tokens)
        carry = self.api.init_prefill_carry(self.params, self.cfg,
                                            self.max_len, self.cache_dtype,
                                            device=self.device)
        job = PrefillJob(row=row, prompt=prompt,
                         max_new_tokens=max_new_tokens,
                         chunks=pow2_chunks(P, chunk_len), carry=carry)
        return state, job

    def prefill_chunk(self, state: ContinuousState, job: PrefillJob,
                      temperature: float = 0.0):
        """Run the job's next prefill chunk (K/V into the pool through the
        row's block table).  Returns ``(state, first_token or None)``: the
        (1, 1) device token appears when the final chunk samples it."""
        C = job.chunks[0]
        final = len(job.chunks) == 1
        state.pool.advance(job.row, job.ctx + C)       # alloc-on-advance
        row_table = self._upload(state.pool.table[job.row:job.row + 1])
        toks = self._upload(job.prompt[None, job.ctx:job.ctx + C]
                            .astype(np.int64))
        temp = temperature if temperature > 0 else None
        out = self._chunk_step(final, temperature)(
            self.params, toks, state.cache, job.carry, row_table, job.ctx,
            temp, state.generator)
        tok = out[0] if final else None
        job.chunks.pop(0)
        job.carry = out[-1]
        job.ctx += C
        return dataclasses.replace(state, cache=out[-2]), tok

    def admit_paged(self, state: ContinuousState, job: PrefillJob,
                    first_token, temperature: float = 0.0) -> ContinuousState:
        """Activate a fully prefilled request in its slot: scatter its B=1
        carry (the pages are already in the pool) and arm
        tokens/cursor/active/limit."""
        _, admit = self._cont_steps(temperature)
        P = len(job.prompt)
        cache, tokens, index, active, limit = admit(
            state.cache, state.tokens, state.index, state.active,
            state.limit, job.carry, first_token, P,
            P + job.max_new_tokens - 1, job.row)
        return dataclasses.replace(state, cache=cache, tokens=tokens,
                                   index=index, active=active, limit=limit)

    def free_slot(self, state: ContinuousState, row: int) -> ContinuousState:
        """Free-on-EOS: return the finished row's pages to the pool at once
        (its table row points at the trash page until the slot is
        re-admitted; the device table refreshes at the next decode)."""
        state.pool.free(row)
        return state

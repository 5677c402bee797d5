"""Serving engine: true prefill + a preallocated cache, and
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
tokens stay byte-identical to contiguous solo generation.

``prefix_cache=True`` (paged only) adds a radix tree over the pool
(``train.radix_cache``): a prompt's full pages publish into it when its
prefill completes (``admit_paged``), and a later prompt that shares a
prefix maps the published pages into its block table (``prefix_match``,
``begin_prefill(match=...)``) and prefills only the tail; an exact-boundary
full match clones its last page first (copy-on-write) and reruns one token
at P-1.  Hits stay byte-identical to cold runs.  ``kv_dtype`` 'int8' or
'fp8' (paged only) stores the pool quantized per slot and head with
float32 scales (``core.quant``); greedy streams then agree with the f32
pool within a tolerance lane instead of byte for byte.

``spec_decode=True`` (paged only) runs self-speculative decoding: a draft
(the served model truncated to ``draft_depth`` layers, sharing its
embedding, final norm and tied head, or a shallower ``draft_params``)
proposes ``gamma`` tokens a round from its own contiguous cache, and the
target scores all γ+1 positions in one verify forward through the block
table (``decode_spec``).  Rejected tokens roll back by the cursor and
``KVBlockPool.truncate_row``; no page data moves, and a full-attention
draft rolls back by its cursor alone.  Greedy spec streams stay
byte-identical to non-speculative decode, and a ``copying_zeroL``
expansion's draft at its source depth accepts every proposal.

Continuous batching serves Mamba and RWKV6 layers too (``rwkv6-7b``,
Mamba stacks, jamba's hybrid): their O(1) state lives per row beside the
pool, a chunked prefill threads it through a B=1 carry, a masked decode
freezes inactive rows' state, a verify replays the chunk as decode steps
into a checkpoint ring from which each row keeps its accepted prefix, and
the draft rolls back the same way.  A prefix-cache hit on such a model
restores a copy of the carry its publisher snapshotted at a page
boundary.  Sliding-window layers (gemma2-9b, gemma3-12b) keep a ring per
row beside the pool in the same way: a chunked prefill advances the B=1
carry's ring, the verify defers each ring's advance to the accepted
prefix, the draft restores its rings from a pre-round copy (so γ + 1 may
not exceed a window), and a prefix hit restores the ring its publisher
snapshotted.

On a mesh (``mesh=``, one process per rank, every rank running the same
engine) the rows of a batch go over the DP axes, as ``cache_shardings``
puts a cache's batch dim, and tensor parallelism splits attention and
MLA heads, d_ff, experts, Mamba channels, RWKV6 heads and vocab over
'model' where they divide (``distributed.context.keeps_model_split``):
the engine slices each rank's shards at load, the other leaves held
whole (``wk``/``wv`` among them where 'model' ranks share a KV head:
the layer cuts its head's columns).  A rank's caches, contiguous rows,
pool pages and rings, hold the KV heads it computes: KV/model of them
where KV divides 'model', its one KV head where 'model' is a multiple
of KV, all of them where its attention computes whole;
its Mamba states hold its channels and its RWKV6 WKV states its heads;
MLA's latent caches have no head axis and are whole.  That is a
deliberate departure from ``cache_shardings``, which puts the longest
trailing dim on 'model' (ROADMAP queue C).  ``generate``'s tokens and
logits come back gathered to every rank.

Every continuous mode runs on a mesh too, each rank running the same
``ContinuousScheduler`` over the same host state: the page allocator,
the radix tree and the block table's host copy.  The slots go in blocks
over the DP axes where ``max_batch`` divides them (``_rows``), else
every rank serves every slot; a rank's device state holds its block
alone (tokens, cursors, the block table's rows, rings, recurrent rows,
the draft's cache), while the page pool and its scales are whole in the
page dim on every rank.  The B=1 work, a prompt's prefill, its chunks
and the draft's prefill, runs replicated on every rank (a batch of one
does not divide DP), so every rank writes the same prompt pages and
samples the same first token; admission scatters the row's carry, ring
and draft cache on the rank that owns the row.  A masked decode or a
verify writes the pool only at the rank's own rows' slots, which no row
of another rank reads: the pages the radix tree holds are prompt pages,
equal on every rank.  The scheduler's per-iteration ``exchange`` makes
the sampled tokens whole on every rank.

The reference's placement knobs (``fsdp``, ``layout``, ``moe_fsdp``, with
its defaults) place the served leaves by the trainer's rules
(``sharding.param_spec``).  Under the default ('tp' layout, no FSDP) a
rank holds the 'model' shards its layers compute on and every other leaf
whole, as above.  ``fsdp=True`` holds each leaf's FSDP shard over 'data'
too, ``moe_fsdp='ef'`` puts an expert stack's expert-ffn dim there, and
``layout='fsdp'`` holds every leaf split over ('data', 'model'), computes
it whole (no tensor parallelism) and puts the rows over every axis.  The
steps then run under a context with the held specs, and
``context.materialize`` gathers a super-block's leaves before its layers
run, as training gathers them; a placement with nothing to gather runs
the held leaves as they are.  The draft of a speculative engine is placed
alike.

A fault plane on a mesh is agreed (``collectives.AgreedPlane``): each
site's outcome is all-reduced before the operation runs, so every rank
retries, contains or unwinds the same faults, and a crash on one rank is
a crash on every rank.  The ``faults`` attribute wraps any plane set on
a mesh engine.

Fault injection (``faults``, a ``train.faults`` plane; the NULL plane by
default): the engine fires ``engine.prefill_chunk``, ``engine.decode``,
``engine.table_upload`` and ``engine.draft_prefill`` and hands the plane
to its page pool (``pool.alloc``, ``pool.evict``) and radix tree
(``radix.match``, ``radix.publish``).  Each step here writes caches,
carries or the device table in place, so every site fires before the
first write, upload or copy: a faulted call leaves the state as it was
and can simply be retried.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import expansion, quant
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models import transformer
from repro_torch.distributed.context import (MeshContext, dp_axes,
                                            keeps_model_split, mesh_scope)
from repro_torch.distributed.sharding import dim_axes
from repro_torch.models.common import resolve_device
from repro_torch.train import faults as faults_lib
from repro_torch.train import steps as steps_lib
from repro_torch.train.kv_pool import KVBlockPool
from repro_torch.train.radix_cache import RadixCache
from repro_torch.tree import leaves_with_path, tree_map, tree_map_with_path


def resolve_kv_dtype(kv_dtype):
    """None, a ``--kv-dtype`` name ('f32', 'bf16', 'int8', 'fp8') or a
    torch dtype (float, int8 or fp8) -> torch dtype or None."""
    if kv_dtype is None or isinstance(kv_dtype, str):
        return quant.resolve_kv_dtype(kv_dtype)
    if not (quant.is_quantized(kv_dtype) or (kv_dtype.is_floating_point
                                              and kv_dtype.itemsize >= 2)):
        raise ValueError(f"kv_dtype {kv_dtype}: not a pool storage dtype")
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
    ``pool.version`` moved past ``table_version``; prefix-cache engines the
    radix tree over the pool (``radix``)."""
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
    radix: Optional[RadixCache] = None           # prefix_cache engines
    draft_cache: Optional[dict] = None           # spec engines: the draft's
                                                 # contiguous cache
    row0: int = 0                      # on a mesh: the first slot of the
    slots: Optional[int] = None        # rank's block, and every rank's

    @property
    def batch(self) -> int:
        """Slots in the whole batch (on a mesh, every rank's blocks)."""
        return self.slots if self.slots is not None else self.tokens.shape[0]

    def local(self, row: int) -> Optional[int]:
        """Slot ``row``'s index in this rank's block (None: another rank
        owns it)."""
        r = row - self.row0
        return r if 0 <= r < self.tokens.shape[0] else None


@dataclasses.dataclass
class PrefillJob:
    """One request's in-flight chunked prefill (paged engines).

    The prompt runs as its binary decomposition into power-of-two chunks
    (largest first, optionally capped at the scheduler's ``chunk_len``),
    one chunk per scheduler iteration.  K/V lands directly in the shared
    pool through the row's block table; ``carry`` threads the B=1 per-row
    state between chunks, written in place.  A prefix-cache hit starts at
    ``ctx = prefix_tokens``.  On a prefix-cache engine whose carry is not
    empty, ``snap_at`` is the page boundary where a chunk edge is forced
    and ``snapshot`` the copy of the carry taken there (published with the
    prompt's pages)."""
    row: int
    prompt: np.ndarray               # (P,) int32
    max_new_tokens: int
    chunks: list                     # chunk widths, consumed front to back
    carry: object                    # B=1 prefill carry
    ctx: int = 0                     # tokens prefilled so far
    prefix_tokens: int = 0           # prompt tokens served from shared pages
    first_token: object = None       # (1, 1) device token once sampled
    snap_at: int = 0                 # carry snapshot boundary (0: none)
    snapshot: object = None          # device copy of the carry at snap_at

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


def refuse_unservable(cfg: ModelConfig):
    """Raise, with the reference's message, for an architecture without a
    prefill path (the encoder-decoder): the engine serves decoder-only
    models."""
    if registry.get_model(cfg).prefill is None:
        raise NotImplementedError(
            f"{cfg.name}: arch has no prefill path; ServeEngine supports "
            "decoder-only archs (transformer / ssm / rwkv6)")


class ServeEngine:
    """Serving engine on one device or a mesh (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params, device="cuda",
                 max_len: int = 512, cache_dtype=torch.float32,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None, kv_dtype=None,
                 prefix_cache: bool = False, spec_decode: bool = False,
                 gamma: int = 4, draft_depth: Optional[int] = None,
                 draft_params=None, faults=None, mesh=None,
                 fsdp: bool = False, layout: str = "tp",
                 moe_fsdp: str = "auto"):
        if layout not in ("tp", "fsdp"):
            raise ValueError(f"layout {layout!r} (tp or fsdp)")
        if isinstance(mesh, str):
            from repro_torch.launch import mesh as mesh_lib
            mesh = mesh_lib.make_train_mesh(mesh, device=str(device))
        self.mesh = mesh
        self.fsdp, self.layout, self.moe_fsdp = fsdp, layout, moe_fsdp
        self._ctx = None
        if mesh is not None:
            device = mesh.device
            params, self._ctx = self._place(cfg, params)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Keep float32 matmuls around the kernel in full float32, as the
            # CPU reference computes them (cuDNN is off the path, stated
            # all the same).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.api = registry.get_model(cfg)
        refuse_unservable(cfg)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.paged = paged
        self.block_size = block_size
        self.num_blocks = num_blocks          # None: full provisioning
        # kv_dtype overrides the paged pool's storage dtype only ('f32'/
        # 'bf16'/'int8'/'fp8' or a dtype; None keeps cache_dtype).  int8/fp8
        # store quantized pages plus per-slot f32 scales.
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        if self.kv_dtype is not None and quant.is_quantized(self.kv_dtype) \
                and not paged:
            raise ValueError("quantized kv_dtype requires paged=True (scales "
                             "are per-pool-page state; the contiguous cache "
                             "has no page machinery to carry them)")
        self.prefix_cache = prefix_cache
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True (shared "
                             "prefixes are shared pool pages mapped through "
                             "block tables)")
        # One no-op call per site when off (the NULL plane); agreed over
        # the mesh on a mesh (the ``faults`` setter).
        self.faults = faults
        self.module = registry.ParamModule(params).to(self.device)
        self.params = self.module.tree()
        self._built = {}              # sample? -> (prefill, decode)
        self._cont_built = {}         # sample? -> (masked decode, admit)
        self._chunk_built = {}        # (final?, sample?) -> chunk step
        self._page_copy = steps_lib.make_page_copy_step()
        # Carryless configs (every layer paged global attention) restore no
        # state on a prefix hit and may match at any page depth; recurrent
        # configs clamp their matches to carry snapshots.
        self._carry_empty = all(
            cfg.layer_kind(i) == "attn" and cfg.layer_window(i) == 0
            for i in range(cfg.pattern_period))
        self.spec_decode = spec_decode
        self.gamma = gamma
        if spec_decode:
            self._init_spec(draft_depth, draft_params)

    @property
    def faults(self):
        """The engine's fault plane (the pool and the radix tree take it
        at ``continuous_state``)."""
        return self._faults

    @faults.setter
    def faults(self, plane):
        # On a mesh every plane set here is agreed over the ranks.
        self._faults = coll.agreed_plane(faults_lib.resolve(plane),
                                         self.mesh)

    def _place(self, cfg: ModelConfig, params):
        """(the params as this rank holds them, the context the steps run
        under): ``place_params`` under the engine's knobs."""
        return place_params(cfg, params, self.mesh, self.layout, self.fsdp,
                            self.moe_fsdp)

    def _rows(self, batch: int):
        """(DP axes, ranks over them) this batch's rows go over: the layout's
        DP axes (every axis under 'fsdp', the reference's
        ``batch_shardings``) where the batch divides them, else every rank
        serves every row."""
        axes = dp_axes(self.mesh, self.layout)
        n = self.mesh.axes_size(axes)
        if n > 1 and batch % n == 0:
            return axes, n
        return (), 1

    def _init_spec(self, draft_depth, draft_params):
        """Resolve the draft of self-speculative decoding: the target
        truncated to ``draft_depth`` layers (its leaves are views of the
        target's: no copy), or ``draft_params`` (a shallower checkpoint,
        at the depth of its block stack)."""
        if not self.paged:
            raise ValueError("spec_decode requires paged=True (rollback of "
                             "rejected drafts is block-table cursor rewind)")
        if self.gamma < 1:
            raise ValueError(f"gamma {self.gamma} < 1")
        cfg = self.cfg
        w = steps_lib.narrowest_window_below(cfg, self.gamma + 1)
        if w:
            raise ValueError(
                f"gamma {self.gamma} + 1 draft writes exceed sliding window "
                f"{w}: a speculation round may not overwrite a draft ring "
                "slot twice")
        if draft_params is not None:
            depth = transformer.num_superblocks(draft_params) \
                * cfg.pattern_period
            self.draft_cfg = cfg.with_depth(depth)
            if self.mesh is not None:
                # Placed as the target: a leaf's spec does not depend on
                # the depth, so the target's context gathers it.
                draft_params, _ = self._place(self.draft_cfg, draft_params)
            self.draft_params = registry.ParamModule(draft_params).to(
                self.device).tree()
        else:
            if draft_depth is None:
                raise ValueError("spec_decode needs draft_depth (layers to "
                                 "truncate the target to) or draft_params")
            self.draft_cfg = cfg.with_depth(draft_depth)
            self.draft_params = expansion.truncate_params(self.params, cfg,
                                                          draft_depth)
        self.draft_api = registry.get_model(self.draft_cfg)
        self._spec_built = {}         # sample? -> (draft loop, verify)
        # The draft's sliding-window rings roll back from a pre-round copy,
        # its Mamba/RWKV6 layers from the draft loop's checkpoint ring, its
        # global attention layers by the cursor alone.
        dcfg = self.draft_cfg
        self._draft_ring = tuple(
            f"layer{i}" for i in range(dcfg.pattern_period)
            if dcfg.num_layers and dcfg.layer_kind(i) == "attn"
            and dcfg.layer_window(i) > 0)
        self._draft_rec = tuple(
            f"layer{i}" for i in range(dcfg.pattern_period)
            if dcfg.num_layers and dcfg.layer_kind(i) != "attn")
        self._draft_rollback = steps_lib.make_draft_rollback_step(
            dcfg, self.gamma, ring_layers=self._draft_ring,
            rec_layers=self._draft_rec)
        self._draft_prefill = steps_lib.make_prefill_step(self.draft_cfg)
        self._row_scatter = steps_lib.make_row_scatter_step()

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
        fit ``max_len``, or needs learned positions past ``max_seq_len``:
        the last generated token is never fed back, so positions run to
        P + G - 2.  The reference clamps a position past the learned table
        and so serves it wrongly without a word; the port refuses the
        request.  Rotary positions are served up to ``max_len``, as the
        reference rotates any position."""
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
        per-step logits list or None, (prefill_s, decode_s))``.  On a mesh
        each rank generates its rows and the tokens and logits come back
        gathered over the DP axes."""
        prompts = np.asarray(prompts, np.int32)
        if self.mesh is not None:
            return self._generate_on_mesh(prompts, num_tokens, temperature,
                                          seed, collect_logits)
        return self._generate_local(prompts, num_tokens, temperature, seed,
                                    collect_logits)

    def _generate_local(self, prompts, num_tokens, temperature, seed,
                        collect_logits):
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

    def _generate_on_mesh(self, prompts, num_tokens, temperature, seed,
                          collect_logits):
        axes, n = self._rows(prompts.shape[0])
        if n > 1:
            size = prompts.shape[0] // n
            i = self.mesh.axes_index(axes)
            prompts = prompts[i * size:(i + 1) * size]
        with mesh_scope(self._ctx):
            tokens, logs, times = self._generate_local(
                prompts, num_tokens, temperature, seed, collect_logits)
        group = self.mesh.group(axes) if n > 1 else None
        tokens = coll.all_gather(tokens, group, 0)
        if logs is not None:
            logs = [coll.all_gather(torch.cat(logs, dim=1), group, 0)]
        return tokens, logs, times

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
        layers, scale leaves included: quantization changes no page count,
        so the ratio to an f32 pool is the quantized mode's capacity win.
        ``kv_dtype='engine'`` prices this engine's pool; pass a dtype (or
        None for cache_dtype) to price another.  On a mesh, the pool this
        rank holds (its KV heads under tensor parallelism).  Shapes only:
        nothing is allocated."""
        if not self.paged:
            raise ValueError("kv_bytes_per_token is defined for paged "
                             "engines")
        kv = self.kv_dtype if kv_dtype == "engine" \
            else resolve_kv_dtype(kv_dtype)
        with mesh_scope(self._ctx):
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
        default), the pool and the device block table; prefix-cache engines
        the radix tree over the pool.  On a mesh the device state holds
        the rank's block of slots (``_rows``) and the whole pool; the host
        state covers every slot."""
        del temperature               # steps are built per call
        dev = self.device
        local, row0 = batch, 0
        if self.mesh is not None:
            axes, n = self._rows(batch)
            local = batch // n
            row0 = self.mesh.axes_index(axes) * local if n > 1 else 0
        pool = table = radix = None
        with mesh_scope(self._ctx):
            if self.paged:
                nb = num_blocks if num_blocks is not None \
                    else self._resolved_num_blocks(batch)
                pool = KVBlockPool(nb, self.block_size, batch,
                                   self.max_blocks, faults=self.faults)
                cache = self.api.init_paged_cache(
                    self.params, self.cfg, local, nb, self.block_size,
                    self.max_len, self.cache_dtype, self.kv_dtype,
                    device=dev)
                table = torch.empty((local, self.max_blocks),
                                    dtype=torch.int32, device=dev)
                if self.prefix_cache:
                    radix = RadixCache(pool)
            else:
                cache = self.api.init_cache(self.params, self.cfg, local,
                                            self.max_len, self.cache_dtype,
                                            device=dev)
            draft_cache = None
            if self.spec_decode:
                draft_cache = self.draft_api.init_cache(
                    self.draft_params, self.draft_cfg, local, self.max_len,
                    self.cache_dtype, device=dev)
        state = ContinuousState(
            tokens=torch.zeros((local, 1), dtype=torch.long, device=dev),
            cache=cache, draft_cache=draft_cache,
            index=torch.zeros((local,), dtype=torch.long, device=dev),
            active=torch.zeros((local,), dtype=torch.bool, device=dev),
            limit=torch.zeros((local,), dtype=torch.long, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
            pool=pool, block_table=table, radix=radix, row0=row0,
            slots=batch)
        return self._sync_table(state, fire=False)

    def exchange(self, state: ContinuousState, blocks=(),
                 clock: Optional[float] = None, words=()):
        """The scheduler's per-iteration exchange (``collectives.
        exchange``): this rank's row blocks (a step's sampled tokens,
        active flags and accepted counts over the rank's slots) made
        whole-batch tensors, and rank 0's ``clock`` reading and ``words``
        (its pending cancels), in one all-gather over every rank of the
        mesh (each DP block taken from its first 'model' rank).  Returns
        (blocks, clock, words).  Off a mesh, or on a mesh of one rank, the
        blocks, the clock and the words as given."""
        if self.mesh is None:
            return list(blocks), clock, [int(w) for w in words]
        m = self.mesh
        _, n = self._rows(state.batch)
        take = [i * (m.world_size // n) for i in range(n)]
        return coll.exchange(blocks, clock, m.group(m.axis_names), take,
                             m.device, words)

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
        temp = temperature if temperature > 0 else None
        with mesh_scope(self._ctx):
            row_cache = self.api.init_cache(self.params, self.cfg, 1,
                                            self.max_len, self.cache_dtype,
                                            device=self.device)
            tok, _, row_cache, _ = prefill(
                self.params, self._upload(prompt.astype(np.int64)),
                row_cache, temp, state.generator)
        return state, tok, row_cache

    def admit_request(self, state: ContinuousState, row: int, first_token,
                      row_cache, prompt_len: int, max_new_tokens: int,
                      temperature: float = 0.0) -> ContinuousState:
        """Scatter a prefilled request into batch slot ``row`` (other rows
        untouched; on a mesh, on the rank that owns the slot)."""
        _, admit = self._cont_steps(temperature)
        r = state.local(row)
        if r is None:
            return state
        cache, tokens, index, active, limit = admit(
            state.cache, state.tokens, state.index, state.active,
            state.limit, row_cache, first_token, prompt_len,
            prompt_len + max_new_tokens - 1, r)
        return dataclasses.replace(state, cache=cache, tokens=tokens,
                                   index=index, active=active, limit=limit)

    def decode_masked(self, state: ContinuousState, temperature: float = 0.0,
                      eos_id: int = -1) -> ContinuousState:
        """One continuous-batching decode iteration over all slots.

        Active rows sample, write their cache at their own cursor and
        self-terminate on eos / per-row limit; inactive rows are no-ops.
        Paged engines read and write K/V through the block table,
        re-uploaded only when the pool changed it.  On a mesh the step
        runs over the rank's block of slots."""
        self.faults.fire("engine.decode")
        decode, _ = self._cont_steps(temperature)
        temp = temperature if temperature > 0 else None
        table = ()
        if self.paged:
            state = self._sync_table(state)
            table = (state.block_table,)
        with mesh_scope(self._ctx):
            tokens, _, cache, index, active = decode(
                self.params, state.tokens, state.cache, state.index,
                state.active, state.limit, eos_id, temp, state.generator,
                *table)
        return dataclasses.replace(state, tokens=tokens, cache=cache,
                                   index=index, active=active)

    # -- self-speculative decoding -------------------------------------------

    def _spec_steps(self, temperature: float):
        """(draft loop, verify) of ``steps_lib.make_draft_loop_step`` and
        ``make_verify_step`` for this sampling mode."""
        sample = temperature > 0
        if sample not in self._spec_built:
            self._spec_built[sample] = (
                steps_lib.make_draft_loop_step(self.draft_cfg, self.gamma,
                                               sample=sample,
                                               ring_layers=self._draft_ring,
                                               rec_layers=self._draft_rec),
                steps_lib.make_verify_step(self.cfg, self.gamma,
                                           sample=sample))
        return self._spec_built[sample]

    def _admit_draft(self, state: ContinuousState, row: int,
                     prompt) -> ContinuousState:
        """The speculative half of a paged admission: one B=1 draft
        prefill at the exact prompt length (flash attention on the card),
        scattered into the draft cache's slot ``row``.  The draft's
        greedy first token is dropped: the target's chunked prefill owns
        the first token, and no sampling draw is spent.  On a mesh the
        prefill runs on every rank and the scatter on the slot's owner."""
        if not state.draft_cache:
            return state              # zero-layer draft: nothing to cache
        self.faults.fire("engine.draft_prefill")
        prompt = np.asarray(prompt, np.int64).reshape(1, -1)
        with mesh_scope(self._ctx):
            row_cache = self.draft_api.init_cache(
                self.draft_params, self.draft_cfg, 1, self.max_len,
                self.cache_dtype, device=self.device)
            _, _, row_cache, _ = self._draft_prefill(
                self.draft_params, self._upload(prompt), row_cache, None,
                state.generator)
        r = state.local(row)
        if r is not None:
            self._row_scatter(state.draft_cache, row_cache, r)
        return state

    def decode_spec(self, state: ContinuousState, temperature: float = 0.0,
                    eos_id: int = -1):
        """One speculation round over all slots: γ+1 masked draft steps
        propose, one target verify forward scores, accepts and commits.

        Returns ``(state, out_tokens (B, γ+1), acc (B,))`` on the device:
        row b emitted ``out_tokens[b, :acc[b]]`` (inactive rows none).  The
        caller moves its host cursors by ``acc`` and releases pages past
        them (``state.pool.truncate_row``); neither the pool nor the
        full-attention draft cache needs a device rollback.  The target's
        ring and recurrent layers keep their accepted prefix in the
        verify's commit; the draft's are rolled back here, from the draft
        loop's copies."""
        self.faults.fire("engine.decode")
        state = self._sync_table(state)
        draft, verify = self._spec_steps(temperature)
        with mesh_scope(self._ctx):
            if temperature > 0:
                vt, probs, dcache, ring = draft(
                    self.draft_params, state.tokens, state.draft_cache,
                    state.index, state.active, temperature, state.generator)
                extra = (probs, temperature)
            else:
                vt, dcache, ring = draft(self.draft_params, state.tokens,
                                         state.draft_cache, state.index,
                                         state.active, state.generator)
                extra = ()
            out, acc, nxt, cache, index, active = verify(
                self.params, vt, state.cache, state.index, state.active,
                state.limit, state.block_table, eos_id, *extra,
                state.generator)
        if self._draft_rec or self._draft_ring:
            dcache = self._draft_rollback(dcache, ring, state.index, acc)
        state = dataclasses.replace(state, tokens=nxt, cache=cache,
                                    draft_cache=dcache, index=index,
                                    active=active)
        return state, out, acc

    # -- paged request lifecycle (chunked prefill through the pool) ---------

    def _sync_table(self, state: ContinuousState,
                    fire: bool = True) -> ContinuousState:
        """Copy the host block table into the persistent device table iff
        the pool changed it.  The copy is queued on the current stream, so
        a decode already queued reads the old table and the next one the
        new.  A changed version whose bytes match the last upload copies
        nothing.  The ``engine.table_upload`` site fires before the copy:
        a faulted upload leaves the device table at its last version,
        consistent with the last dispatched step, and the caller
        retries."""
        if state.pool is None or state.table_version == state.pool.version:
            return state
        host = state.pool.table
        if state.table_host is None or not np.array_equal(host,
                                                          state.table_host):
            if fire:
                self.faults.fire("engine.table_upload")
            host = host.copy()
            rows = host[state.row0:state.row0 + state.block_table.shape[0]]
            state.block_table.copy_(torch.from_numpy(rows),
                                    non_blocking=True)
            state = dataclasses.replace(state, table_host=host)
        return dataclasses.replace(state, table_version=state.pool.version)

    def prefix_match(self, state: ContinuousState, prompt, max_pages=None):
        """Radix-tree lookup for an arriving prompt (None off a prefix-
        cache engine, or on a miss).  The result feeds
        ``pool.can_admit_prefix`` (the scheduler's preflight) and
        :meth:`begin_prefill`; between those two host calls nothing can
        evict the matched pages (eviction only runs inside allocation).
        ``max_pages`` caps the match depth: the scheduler re-clamps an
        inadmissible hit shallower until it fits.  A carryless config
        matches at any page depth; a config with Mamba or RWKV6 layers
        clamps to the deepest carry snapshot strictly below the prompt's
        length (``RadixCache.match``)."""
        if state.radix is None:
            return None
        prompt = np.asarray(prompt, np.int32).ravel()
        return state.radix.match(prompt, self._carry_empty,
                                 max_pages=max_pages)

    def begin_prefill(self, state: ContinuousState, row: int, prompt,
                      max_new_tokens: int, chunk_len: Optional[int] = None,
                      temperature: float = 0.0, match=None):
        """Admit a request into the pool and start its chunked prefill.

        Commits the request's worst-case pages (``kv_pool``'s admission
        contract), assigns slot ``row`` and returns ``(state, job)``; drive
        the job with :meth:`prefill_chunk` once per scheduler iteration,
        then :meth:`admit_paged`.

        ``match`` (a ``radix_cache.PrefixMatch`` from :meth:`prefix_match`)
        maps the matched shared pages straight into the row's table and
        starts the chunked prefill at the unmatched tail; an exact-boundary
        full match clones its last page first (copy-on-write: a shared
        page is never written) and reruns one token at P-1 for the
        first-token logits.  Greedy tokens stay byte-identical to a cold
        run: shared-page K/V depends only on the token prefix and the
        position, and the tail attends over it through the block table
        exactly as the request's own prefill would have.  A hit on a
        recurrent config starts from a copy of the matched node's carry
        snapshot (the chunks write the carry in place; the node serves
        later hits too).  Its publishers force a chunk edge onto the last
        page boundary at or below P-1 and snapshot the carry there, where
        matches clamp (the tail always reruns at least one real token)."""
        del temperature
        prompt = np.asarray(prompt, np.int32).ravel()
        P = len(prompt)
        if P >= self.max_len:
            raise ValueError(f"prompt {P} exceeds max_len {self.max_len}")
        skip, carry = 0, None
        if match is None:
            state.pool.admit(row, P, max_new_tokens)
        else:
            cow = state.pool.admit_prefix(row, P, max_new_tokens,
                                          match.pages, match.cow_last)
            if cow is not None:
                state = dataclasses.replace(
                    state, cache=self._page_copy(state.cache, *cow))
            skip = match.skip
            if match.carry is not None:
                carry = tree_map(torch.clone, match.carry)
        if carry is None:
            with mesh_scope(self._ctx):
                carry = self.api.init_prefill_carry(
                    self.params, self.cfg, self.max_len, self.cache_dtype,
                    device=self.device)
        snap_at = 0
        if state.radix is not None and not self._carry_empty:
            boundary = ((P - 1) // self.block_size) * self.block_size
            if boundary > skip:
                snap_at = boundary
        if snap_at:
            chunks = (pow2_chunks(snap_at - skip, chunk_len)
                      + pow2_chunks(P - snap_at, chunk_len))
        else:
            chunks = pow2_chunks(P - skip, chunk_len)
        job = PrefillJob(row=row, prompt=prompt,
                         max_new_tokens=max_new_tokens, chunks=chunks,
                         carry=carry, ctx=skip, prefix_tokens=skip,
                         snap_at=snap_at)
        return state, job

    def prefill_chunk(self, state: ContinuousState, job: PrefillJob,
                      temperature: float = 0.0):
        """Run the job's next prefill chunk (K/V into the pool through the
        row's block table).  Returns ``(state, first_token or None)``: the
        (1, 1) device token appears when the final chunk samples it.

        Transactional under injected faults: the site fires first and the
        pool's alloc/evict sites fire before the free list moves (and
        ``advance`` resumes where it stopped), all before the chunk writes
        the pool or the carry in place; the job's ``chunks``/``carry``/
        ``ctx`` move only after the chunk ran.  A faulted call can simply
        be retried."""
        self.faults.fire("engine.prefill_chunk")
        C = job.chunks[0]
        final = len(job.chunks) == 1
        state.pool.advance(job.row, job.ctx + C)       # alloc-on-advance
        row_table = self._upload(state.pool.table[job.row:job.row + 1])
        toks = self._upload(job.prompt[None, job.ctx:job.ctx + C]
                            .astype(np.int64))
        temp = temperature if temperature > 0 else None
        with mesh_scope(self._ctx):
            out = self._chunk_step(final, temperature)(
                self.params, toks, state.cache, job.carry, row_table,
                job.ctx, temp, state.generator)
        tok = out[0] if final else None
        job.chunks.pop(0)
        job.carry = out[-1]
        job.ctx += C
        if job.snap_at and job.ctx == job.snap_at and job.snapshot is None:
            # A copy, not the carry itself: the next chunk writes it.
            job.snapshot = tree_map(torch.clone, job.carry)
        return dataclasses.replace(state, cache=out[-2]), tok

    def admit_paged(self, state: ContinuousState, job: PrefillJob,
                    first_token, temperature: float = 0.0) -> ContinuousState:
        """Activate a fully prefilled request in its slot: scatter its B=1
        carry (the pages are already in the pool) and arm
        tokens/cursor/active/limit.  A prefix-cache engine first publishes
        the prompt's full pages: every slot of them now holds prompt K/V
        and is never written again (decode writes positions >= P).  The
        first publisher of a path wins; a recurrent config's carry
        snapshot attaches at its page boundary.

        The fault-prone host steps (the draft prefill, the radix publish)
        run BEFORE the scatter flips the row active, so a fault here leaves
        the slot inert and the whole call retryable (the draft's slot is
        rewritten whole by the retry).  On a mesh every rank publishes and
        the slot's owner scatters."""
        _, admit = self._cont_steps(temperature)
        if self.spec_decode:
            state = self._admit_draft(state, job.row, job.prompt)
        P = len(job.prompt)
        if state.radix is not None:
            n_pub = P // self.block_size
            if n_pub:
                state.radix.publish(
                    job.prompt, state.pool.row_pages(job.row)[:n_pub], n_pub,
                    carry=job.snapshot, carry_tokens=job.snap_at)
        r = state.local(job.row)
        if r is None:
            return state
        cache, tokens, index, active, limit = admit(
            state.cache, state.tokens, state.index, state.active,
            state.limit, job.carry, first_token, P,
            P + job.max_new_tokens - 1, r)
        return dataclasses.replace(state, cache=cache, tokens=tokens,
                                   index=index, active=active, limit=limit)

    def deactivate_row(self, state: ContinuousState,
                       row: int) -> ContinuousState:
        """Force one row inactive on the device (the scheduler fails a
        faulted row and keeps the batch serving).  Only ``active`` changes,
        as a new tensor: a step already queued that still holds the old one
        may land the row's write, on pages the pool frees after this call
        and before any new owner's prefill is queued (in-order execution
        on one stream, as ``KVBlockPool.truncate_row``'s rollback)."""
        r = state.local(row)
        if r is None:
            return state
        active = state.active.clone()
        active[r] = False
        return dataclasses.replace(state, active=active)

    def free_slot(self, state: ContinuousState, row: int) -> ContinuousState:
        """Free-on-EOS: return the finished row's pages to the pool at once
        (its table row points at the trash page until the slot is
        re-admitted; the device table refreshes at the next decode)."""
        state.pool.free(row)
        return state


def place_params(cfg: ModelConfig, params, mesh, layout: str = "tp",
                 fsdp: bool = False, moe_fsdp: str = "auto"):
    """(the params as a serving rank of ``mesh`` holds them, the context
    its steps run under).  Each leaf is split as ``sharding.param_spec``
    places it under ``fsdp``, ``layout`` and ``moe_fsdp``, except that
    under the 'tp' layout a leaf stays whole over 'model' where its layer
    computes it whole (``keeps_model_split``).  The context holds the
    specs where some leaf is split over an axis its layer does not compute
    on (``materialize`` gathers it per super-block), else none."""
    specs = {}
    gather = False
    with mesh_scope(MeshContext(mesh, layout, serving=True)):
        for path, x in leaves_with_path(params):
            spec = shd.param_spec(path, x.shape, mesh, fsdp=fsdp,
                                  moe_fsdp=moe_fsdp, layout=layout)
            keep = keeps_model_split(path, cfg)
            if layout == "tp" and not keep:
                spec = tuple(
                    tuple(a for a in dim_axes(e) if a != "model")
                    or None for e in spec)
            specs[path] = spec
            gather = gather or any(
                mesh.axes_size(tuple(a for a in dim_axes(e)
                                     if not (keep and a == "model"))) > 1
                for e in spec)

        def one(path, x):
            y = coll.shard_leaf(x, specs[path], mesh, path)
            return x if y is x else y.clone()
        held = tree_map_with_path(one, params)
    return held, MeshContext(mesh, layout, specs if gather else None,
                             serving=True)

"""Serving CLI of the port over ``repro_torch.train.serve_engine.ServeEngine``
(``repro/launch/serve.py``): batched generation with one prefill and a
per-token decode, or continuous batching over a paged KV pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-12l \
        --batch 8 --prompt-len 512 --gen 64            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-12l \
        --smoke --device cpu                           # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --batch 4 --prompt-len 1024 --gen 32           # RWKV6, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --smoke --device cpu     # jamba, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-12l \
        --continuous --paged --max-batch 8 --requests 32 --prompt-len 512 \
        --gen 64 --rate 1000                           # paged, on the card

``--arch`` takes ``gpt2-*``, the paper's testbeds ``llama3-0.3b``,
``qwen3-0.3b``, ``mixtral-0.3b`` and ``deepseekv3-0.3b`` (MLA: its pool
pages hold latent rows), ``yi-34b``, ``starcoder2-3b``,
``deepseek-moe-16b``, ``moonshot-v1-16b-a3b``, ``rwkv6-7b``,
``jamba-v0.1-52b``, ``gemma2-9b``, ``gemma3-12b`` and ``qwen2-vl-2b``
(M-RoPE, served text-only as the reference serves it; ``--smoke`` for the
reduced config).  ``whisper-base`` exits before any weight is drawn, with
the reference's message: the engine serves decoder-only models.  The gemmas'
sliding-window layers keep a ring per row beside the pool in every mode
(hd 256 in the flash and paged kernels on the card), and
``--spec-depth``'s ``--gamma`` + 1 may not exceed their window.  RWKV6 and
jamba serve in every mode
below, their prefill (and each chunk of a chunked prefill, from the
carried state) through the WKV and selective-scan kernels on the card and
their decode stepping the recurrent state.  Random weights
that the card cannot hold are refused before they are drawn: ``yi-34b``
(60 layers, ~138 GB of float32 weights) and ``jamba`` (32 layers, 206 GB)
at full depth do not fit one card; serve a checkpoint of fewer layers.
``--checkpoint DIR`` serves a checkpoint the JAX ``ProgressiveTrainer``
wrote: the params subtree is restored at the depth its manifest records.
Without it the weights are random, drawn from ``--seed``.  Prompts are drawn
from ``numpy.random.default_rng(--seed)`` exactly as the reference draws
them.  Prefill and decode throughput are reported separately.

``--mesh SPEC`` (with ``--nproc N`` local ranks, or under ``torchrun``)
serves on a device mesh: rows over the DP axes, heads, d_ff and vocab over
'model'; rank 0 prints.  Every mode below takes it (``--continuous``,
``--paged``, ``--prefix-cache``, ``--kv-dtype``, ``--spec-depth``): every
rank runs the scheduler, the page pool is whole on every rank and the
slots go in blocks over the DP axes.  ``--faults`` and
``--snapshot-every`` take it too: every rank's fault plane agrees on each
site's outcome, and every rank snapshots at the same boundary.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh host --nproc 2 --continuous --paged --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mesh host --nproc 2 --continuous --paged --faults storm:0.05:0 \
        --snapshot-every 1

``--continuous`` switches to the continuous-batching scheduler
(``train/serve_scheduler``): ``--requests`` synthetic requests with varied
prompt and generation lengths and Poisson arrivals (``--rate`` req/s) are
admitted into ``--max-batch`` cache slots as rows free up; aggregate
throughput and p50/p95 time to first token are reported.  ``--paged``
serves through the block-paged KV pool: ``--num-blocks`` pages of
``--block-size`` tokens (default: full provisioning), prompts prefilled
``--chunk-len`` tokens per iteration straight into the pool, pages freed
on EOS, decode attention in the paged-attention kernel on the card.
``--no-overlap`` turns off the scheduler's dispatch-then-fetch double
buffering.

``--prefix-cache`` (with ``--paged``) turns on the prefix-sharing radix
cache (``train/radix_cache``): finished prompts publish their full KV pages
into a radix tree keyed by token content, later requests whose prompts
share that prefix map the pages straight into their block tables and
prefill only the unmatched tail (copy-on-write on an exact page boundary;
LRU-leaf eviction under pool pressure).  The synthetic requests then share
a system prefix of ``max(prompt_len // 2, block_size)`` tokens, and the run
reports its hit rate and skipped tokens.  ``--no-prefix-cache`` (the
default) serves every prompt cold.

``--kv-dtype {f32,bf16,int8,fp8}`` sets the pool's storage dtype.  int8
and fp8 (with ``--paged``) store quantized pages plus per-slot-per-head f32
scales, dequantized inside the paged-attention kernel on the card: the
pool's bytes per token fall to (hd + 4) / (4 hd) of f32.  Quantized greedy
streams agree with the f32 pool's within a tolerance lane (>= 0.9 of
tokens for int8, >= 0.8 for fp8), not byte for byte; prefix hits on a
quantized pool stay byte-identical to quantized cold runs.

``--spec-depth N`` (with ``--paged``) serves self-speculatively: the draft
is the served model truncated to its first N layers, or with
``--draft-checkpoint DIR`` a shallower checkpoint restored at its
manifest depth; it proposes ``--gamma`` tokens a round (default 4) and the
target verifies them in one forward through the block table.  Greedy
streams equal non-speculative ones; the run reports its rounds, the
acceptance rate and the mean accepted length.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --continuous --paged --spec-depth 1 --gamma 3 --max-batch 2 \
        --requests 6 --block-size 4 --chunk-len 4 --rate 1000
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --smoke --device cpu --continuous --paged --prefix-cache \
        --spec-depth 1                                 # RWKV6, every mode

The request lifecycle (with ``--continuous``) is the reference's:
``--deadline-s`` finishes a request ``deadline`` past it, ``--queue-limit``
sheds arrivals past a bounded queue, ``--retries`` bounds the retries of a
transient fault before the one request it hit fails, ``--faults TAPE``
injects faults (``site:nth[:kind]`` entries or ``storm:rate[:seed]``) and
``--snapshot-every N`` snapshots the host state for crash recovery.  A run
that sheds, fails or retries anything, or runs under ``--faults``, prints
a ``lifecycle:`` line with its finish reasons and goodput.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --continuous --paged --max-batch 2 --requests 6 --block-size 4 \
        --chunk-len 4 --rate 1000 --faults storm:0.05:0 --snapshot-every 1
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.train import faults as faults_lib
from repro_torch.train.serve_engine import ServeEngine, refuse_unservable
from repro_torch.train.serve_scheduler import (ContinuousScheduler, Request,
                                               summarize)
from repro_torch.tree import tree_leaves

def load_params(checkpoint_dir: str, cfg, step=None):
    """(params as CPU tensors, cfg at the checkpoint's depth) from a
    ``ProgressiveTrainer`` checkpoint."""
    if step is None:
        step = ckpt.latest_step(checkpoint_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    meta = ckpt.load_metadata(checkpoint_dir, step)
    cfg = cfg.with_depth(int(meta["num_layers"]))
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    params = ckpt.restore_subtree(checkpoint_dir, step, like, "params")
    return bridge.params_from_jax(params), cfg


def _check_fits(cfg, device: str):
    """Refuse, before drawing them, weights that the card cannot hold."""
    if device != "cuda" or not torch.cuda.is_available():
        return
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    need = sum(t.numel() * t.element_size() for t in tree_leaves(like))
    have = torch.cuda.get_device_properties(0).total_memory
    if need > have:
        raise SystemExit(
            f"{cfg.name} at {cfg.num_layers} layers holds {need / 1e9:.1f} "
            f"GB of weights, more than the card's {have / 1e9:.1f} GB: serve "
            "a checkpoint of fewer layers (--checkpoint)")


def main(argv=None):
    """Run the CLI; returns the timed run's ``GenerateResult``, or with
    ``--continuous`` the list of ``RequestResult``s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-12l", help=cfglib.ARCH_HELP)
    ap.add_argument("--smoke", action="store_true")
    mesh_lib.add_mesh_args(ap)
    ap.add_argument("--checkpoint", default=None,
                    help="ProgressiveTrainer checkpoint dir to serve")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: admit staggered requests "
                         "into freed cache slots")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots for --continuous")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic requests for --continuous")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate (req/s) for --continuous")
    ap.add_argument("--eos", type=int, default=-1,
                    help="stop token id for --continuous (-1: disabled)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV pool + chunked prefill (with "
                         "--continuous)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page for --paged")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="page pool size (default: full provisioning)")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="paged-pool storage dtype; int8/fp8 (require "
                         "--paged) quantize pages with per-slot f32 scales")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="max prefill chunk width per iteration for --paged")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable dispatch-then-fetch double buffering")
    ap.add_argument("--age-limit", type=float, default=None,
                    help="admission aging threshold in seconds (paged "
                         "first-fit blocks for the oldest request past it)")
    ap.add_argument("--invariant-every", type=int, default=0,
                    help="audit pool refcounts/commitments and radix pins "
                         "every N scheduler iterations (0: off)")
    ap.add_argument("--prefix-cache", action="store_true", default=False,
                    help="prefix-sharing radix cache over the page pool "
                         "(with --paged); synthetic requests then share a "
                         "common system prefix")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="serve every prompt cold (default)")
    ap.add_argument("--spec-depth", type=int, default=None,
                    help="self-speculative decoding: draft = the served "
                         "model truncated to this many layers (with "
                         "--paged)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens proposed per speculation round")
    ap.add_argument("--draft-checkpoint", default=None,
                    help="draft from this checkpoint (restored at its "
                         "manifest depth) instead of depth truncation")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline from arrival (finish reason "
                         "'deadline' past it — queued, prefilling, or "
                         "mid-decode; partial tokens are returned)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound on the arrived-but-unadmitted queue; "
                         "overflow requests are shed with a structured "
                         "rejection instead of queueing unboundedly")
    ap.add_argument("--retries", type=int, default=2,
                    help="bounded retry-with-backoff for transient "
                         "admission/prefill/decode faults before failing "
                         "the one affected request")
    ap.add_argument("--faults", default=None, metavar="TAPE",
                    help="deterministic fault injection: 'site:nth[:kind]' "
                         "entries joined by commas (kind: fault|crash; "
                         "sites: " + ", ".join(faults_lib.SITES)
                         + ") or 'storm:rate[:seed]' for a seeded "
                         "Bernoulli fault storm")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot host-side in-flight serving state every "
                         "N iteration boundaries (crash recovery: restore "
                         "re-prefills prompt+emitted for byte-identical "
                         "resumed greedy streams; 0: off)")
    args = ap.parse_args(argv)
    if args.nproc > 1:
        mesh_lib.run_ranks("repro_torch.launch.serve",
                           sys.argv[1:] if argv is None else argv,
                           args.nproc, args.device)
        return None
    mesh = (mesh_lib.make_train_mesh(args.mesh, device=args.device)
            if args.mesh else None)
    say = print if mesh is None or mesh.rank == 0 else \
        (lambda *a, **k: None)
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous")
    spec = args.spec_depth is not None or args.draft_checkpoint is not None
    if spec and not args.paged:
        raise SystemExit("--spec-depth/--draft-checkpoint require --paged")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache requires --paged")
    if args.kv_dtype in ("int8", "fp8") and not args.paged:
        raise SystemExit("--kv-dtype int8/fp8 requires --paged (scales are "
                         "per-pool-page state)")

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    refuse_unservable(cfg)
    if args.checkpoint:
        params, cfg = load_params(args.checkpoint, cfg, step=args.step)
    else:
        _check_fits(cfg, args.device)
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(args.seed)
        params = registry.get_model(cfg).init(gen, cfg, device="cpu")
        say(f"init: {time.perf_counter() - t0:.1f} s for "
            f"{sum(t.numel() for t in tree_leaves(params))} params")
    draft_params = None
    if args.draft_checkpoint:          # its own latest step, manifest depth
        draft_params, _ = load_params(args.draft_checkpoint, cfg)
    rng = np.random.default_rng(args.seed)
    # With the prefix cache on, continuous requests share a system prefix
    # (half the prompt budget, but at least one full page: only full pages
    # publish into the radix tree) so that the cache has traffic to hit.
    shared_len = (max(args.prompt_len // 2, args.block_size)
                  if args.prefix_cache else 0)
    engine = ServeEngine(cfg, params, device=args.device,
                         max_len=shared_len + args.prompt_len
                         + max(args.gen, 1) + 1,
                         paged=args.paged, block_size=args.block_size,
                         num_blocks=args.num_blocks, kv_dtype=args.kv_dtype,
                         prefix_cache=args.prefix_cache, spec_decode=spec,
                         gamma=args.gamma, draft_depth=args.spec_depth,
                         draft_params=draft_params, faults=args.faults,
                         mesh=mesh)

    if args.continuous:
        return _serve_continuous(args, cfg, engine, rng, shared_len, say)

    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    warmup = min(2, max(args.gen, 1))
    engine.generate(prompts, warmup, temperature=args.temperature)
    res = engine.generate(prompts, max(args.gen, 1),
                          temperature=args.temperature, seed=args.seed)
    pf = args.batch * res.prefill_tokens / max(res.prefill_s, 1e-9)
    dec = args.batch * max(res.steps - 1, 0) / max(res.decode_s, 1e-9)
    say(f"arch={cfg.name} layers={cfg.num_layers} "
        f"mesh={args.mesh or 'single'} batch={args.batch} "
        f"decode_steps={res.steps} device={args.device}"
        + (f" ({mesh.spec()} ranks, {mesh.backend})" if mesh else ""))
    say(f"prefill tokens/s={pf:.1f}  decode tokens/s={dec:.1f}")
    say("sample:", res.tokens[0, :24].tolist())
    return res


def _serve_continuous(args, cfg, engine, rng, shared_len: int, say=print):
    """The synthetic open-loop workload, drawn from ``rng`` in the
    reference's order (the shared prefix, then lengths, budgets, arrivals
    and each prompt), so both packages build the same requests; ``say``
    prints (rank 0's on a mesh)."""
    shared = rng.integers(0, cfg.vocab_size, (shared_len,)).astype(np.int32)
    lens = rng.integers(max(2, args.prompt_len // 4), args.prompt_len + 1,
                        args.requests)
    gens = rng.integers(max(2, args.gen // 4), max(args.gen, 2) + 1,
                        args.requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    reqs = [Request(prompt=np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size,
                                      (int(p),)).astype(np.int32)]),
                    max_new_tokens=int(g), arrival_s=float(a))
            for p, g, a in zip(lens, gens, arrivals)]
    sched = ContinuousScheduler(engine, max_batch=args.max_batch,
                                temperature=args.temperature,
                                eos_id=args.eos, seed=args.seed,
                                chunk_len=args.chunk_len,
                                overlap=not args.no_overlap,
                                admission_age_s=args.age_limit,
                                deadline_s=args.deadline_s,
                                queue_limit=args.queue_limit,
                                max_retries=args.retries,
                                invariant_every=args.invariant_every,
                                snapshot_every=args.snapshot_every)
    sched.warmup(reqs)                 # build and warm outside the timed run
    t0 = time.perf_counter()
    results = sched.run(reqs, on_finish=lambda r: say(
        f"  req {r.uid}: +{len(r.new_tokens)} tok ({r.finish_reason}) "
        f"ttft={r.ttft_s * 1e3:.1f}ms"))
    stats = summarize(results, time.perf_counter() - t0)
    mode = "paged" if args.paged else "continuous"
    say(f"arch={cfg.name} layers={cfg.num_layers} mesh={args.mesh or 'single'} "
        f"{mode} max_batch={args.max_batch} requests={args.requests} "
        f"peak_concurrency={sched.peak_concurrency} device={args.device}")
    say(f"aggregate tokens/s={stats['tokens_per_s']:.1f}  "
        f"ttft p50={stats['ttft_p50_s'] * 1e3:.1f}ms "
        f"p95={stats['ttft_p95_s'] * 1e3:.1f}ms")
    fs = sched.fault_stats()
    if stats["completed"] < stats["requests"] or fs["retries"] \
            or args.faults:
        reasons = " ".join(f"{k}={v}" for k, v in
                           sorted(stats["finish_reasons"].items()))
        say(f"lifecycle: {reasons} retries={fs['retries']} "
            f"goodput tokens/s={stats['goodput']:.1f} "
            f"(all: {stats['tokens_per_s_all']:.1f})")
    if args.paged:
        ks = sched.kv_stats()
        say(f"kv storage: dtype={ks['kv_dtype']} "
            f"bytes/token={ks['kv_bytes_per_token']:.1f} "
            f"(f32: {ks['kv_bytes_per_token_f32']:.1f}, "
            f"ratio={ks['kv_bytes_ratio']:.3f})")
    if args.prefix_cache:
        ps = sched.prefix_stats()
        say(f"prefix cache: hits={ps['prefix_hits']}/"
            f"{ps['prefix_requests']} "
            f"(rate={ps['prefix_hit_rate']:.2%}) "
            f"skipped_tokens={ps['prefix_skipped_tokens']}")
    if engine.spec_decode:
        ss = sched.spec_stats()
        mal = [r.mean_accepted_len for r in results if r.spec_rounds]
        say(f"speculative: draft_layers={engine.draft_cfg.num_layers} "
            f"gamma={engine.gamma} rounds={ss['spec_rounds']} "
            f"acceptance={ss['acceptance_rate']:.2%} "
            f"mean_accepted_len={np.mean(mal) if mal else 0.0:.2f}")
    return results


if __name__ == "__main__":
    main()

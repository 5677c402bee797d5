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

``--arch`` takes ``gpt2-*``, ``rwkv6-7b`` and ``jamba-v0.1-52b``
(``--smoke`` for the reduced config); RWKV6 and jamba serve batch to
completion, their prefill through the WKV and selective-scan kernels on
the card and their decode stepping the recurrent state.  ``jamba`` at
full depth (32 layers, 206 GB of float32 weights) does not fit one card:
serve a checkpoint of fewer layers.
``--checkpoint DIR`` serves a checkpoint the JAX ``ProgressiveTrainer``
wrote: the params subtree is restored at the depth its manifest records.
Without it the weights are random, drawn from ``--seed``.  Prompts are drawn
from ``numpy.random.default_rng(--seed)`` exactly as the reference draws
them.  Prefill and decode throughput are reported separately.

``--continuous`` switches to the continuous-batching scheduler
(``train/serve_scheduler``): ``--requests`` synthetic requests with varied
prompt and generation lengths and Poisson arrivals (``--rate`` req/s) are
admitted into ``--max-batch`` cache slots as rows free up; aggregate
throughput and p50/p95 time to first token are reported.  ``--paged``
serves through the block-paged KV pool: ``--num-blocks`` pages of
``--block-size`` tokens (default: full provisioning), prompts prefilled
``--chunk-len`` tokens per iteration straight into the pool, pages freed
on EOS, decode attention in the paged-attention kernel on the card.
``--kv-dtype {f32,bf16}`` sets the pool's storage dtype.  ``--no-overlap``
turns off the scheduler's dispatch-then-fetch double buffering.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.models import registry, transformer
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import (ContinuousScheduler, Request,
                                               summarize)
from repro_torch.tree import tree_leaves

# Flags of the reference CLI whose paths come with later slices.
_LATER = {
    "spec_depth": "ROADMAP queue A item 9 (self-speculative decoding)",
    "draft_checkpoint": "ROADMAP queue A item 9 (self-speculative decoding)",
    "prefix_cache": "ROADMAP queue A item 10 (prefix sharing)",
    "deadline_s": "ROADMAP queue A item 11 (fault tolerance)",
    "queue_limit": "ROADMAP queue A item 11 (fault tolerance)",
    "faults": "ROADMAP queue A item 11 (fault tolerance)",
    "snapshot_every": "ROADMAP queue A item 11 (fault tolerance)",
}


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
    ap.add_argument("--arch", default="gpt2-12l")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="single",
                    help="only 'single' (mesh sharding: ROADMAP queue A "
                         "item 13)")
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
                    help="paged-pool storage dtype (int8/fp8: ROADMAP "
                         "queue A item 10)")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="max prefill chunk width per iteration for --paged")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable dispatch-then-fetch double buffering")
    ap.add_argument("--age-limit", type=float, default=None,
                    help="admission aging threshold in seconds (paged "
                         "first-fit blocks for the oldest request past it)")
    ap.add_argument("--invariant-every", type=int, default=0,
                    help="audit the page pool every N scheduler iterations "
                         "(0: off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help=_LATER["prefix_cache"])
    ap.add_argument("--spec-depth", type=int, default=None,
                    help=_LATER["spec_depth"])
    ap.add_argument("--draft-checkpoint", default=None,
                    help=_LATER["draft_checkpoint"])
    ap.add_argument("--deadline-s", type=float, default=None,
                    help=_LATER["deadline_s"])
    ap.add_argument("--queue-limit", type=int, default=None,
                    help=_LATER["queue_limit"])
    ap.add_argument("--faults", default=None, help=_LATER["faults"])
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help=_LATER["snapshot_every"])
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise SystemExit(f"--mesh {args.mesh}: the port serves on one device "
                         "(mesh sharding: ROADMAP queue A item 13)")
    for flag, item in _LATER.items():
        if getattr(args, flag) not in (None, False, 0):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"{item}")
    if args.kv_dtype in ("int8", "fp8"):
        raise SystemExit(f"--kv-dtype {args.kv_dtype} is not ported yet: "
                         "ROADMAP queue A item 10 (quantized pages)")
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous")

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.continuous and transformer.has_recurrent_layers(cfg):
        raise SystemExit(f"--continuous with {cfg.name}: "
                         f"{transformer.CARRY_NOT_PORTED}")
    if args.checkpoint:
        params, cfg = load_params(args.checkpoint, cfg, step=args.step)
    else:
        _check_fits(cfg, args.device)
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(args.seed)
        params = registry.get_model(cfg).init(gen, cfg, device="cpu")
        print(f"init: {time.perf_counter() - t0:.1f} s for "
              f"{sum(t.numel() for t in tree_leaves(params))} params")
    rng = np.random.default_rng(args.seed)
    engine = ServeEngine(cfg, params, device=args.device,
                         max_len=args.prompt_len + max(args.gen, 1) + 1,
                         paged=args.paged, block_size=args.block_size,
                         num_blocks=args.num_blocks, kv_dtype=args.kv_dtype)

    if args.continuous:
        return _serve_continuous(args, cfg, engine, rng)

    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    warmup = min(2, max(args.gen, 1))
    engine.generate(prompts, warmup, temperature=args.temperature)
    res = engine.generate(prompts, max(args.gen, 1),
                          temperature=args.temperature, seed=args.seed)
    pf = args.batch * res.prefill_tokens / max(res.prefill_s, 1e-9)
    dec = args.batch * max(res.steps - 1, 0) / max(res.decode_s, 1e-9)
    print(f"arch={cfg.name} layers={cfg.num_layers} mesh={args.mesh} "
          f"batch={args.batch} decode_steps={res.steps} device={args.device}")
    print(f"prefill tokens/s={pf:.1f}  decode tokens/s={dec:.1f}")
    print("sample:", res.tokens[0, :24].tolist())
    return res


def _serve_continuous(args, cfg, engine, rng):
    """The synthetic open-loop workload, drawn from ``rng`` in the
    reference's order (an empty shared prefix, then lengths, budgets,
    arrivals and each prompt), so both packages build the same requests."""
    shared = rng.integers(0, cfg.vocab_size, (0,)).astype(np.int32)
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
                                invariant_every=args.invariant_every)
    sched.warmup(reqs)                 # build and warm outside the timed run
    t0 = time.perf_counter()
    results = sched.run(reqs, on_finish=lambda r: print(
        f"  req {r.uid}: +{len(r.new_tokens)} tok ({r.finish_reason}) "
        f"ttft={r.ttft_s * 1e3:.1f}ms"))
    stats = summarize(results, time.perf_counter() - t0)
    mode = "paged" if args.paged else "continuous"
    print(f"arch={cfg.name} layers={cfg.num_layers} mesh={args.mesh} "
          f"{mode} max_batch={args.max_batch} requests={args.requests} "
          f"peak_concurrency={sched.peak_concurrency} device={args.device}")
    print(f"aggregate tokens/s={stats['tokens_per_s']:.1f}  "
          f"ttft p50={stats['ttft_p50_s'] * 1e3:.1f}ms "
          f"p95={stats['ttft_p95_s'] * 1e3:.1f}ms")
    if args.paged:
        ks = sched.kv_stats()
        print(f"kv storage: dtype={ks['kv_dtype']} "
              f"bytes/token={ks['kv_bytes_per_token']:.1f} "
              f"(f32: {ks['kv_bytes_per_token_f32']:.1f}, "
              f"ratio={ks['kv_bytes_ratio']:.3f})")
    return results


if __name__ == "__main__":
    main()

"""Serving CLI of the port: batched generation with one prefill and a
per-token decode over ``repro_torch.train.serve_engine.ServeEngine``
(``repro/launch/serve.py`` without ``--continuous``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-12l \
        --batch 8 --prompt-len 512 --gen 64            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-12l \
        --smoke --device cpu                           # plain path, CPU

``--checkpoint DIR`` serves a checkpoint the JAX ``ProgressiveTrainer``
wrote: the params subtree is restored at the depth its manifest records.
Without it the weights are random, drawn from ``--seed``.  Prompts are drawn
from ``numpy.random.default_rng(--seed)`` exactly as the reference draws
them.  Prefill and decode throughput are reported separately.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.models import registry
from repro_torch.train.serve_engine import ServeEngine

# Flags of the reference CLI whose paths come with later slices.
_LATER = {
    "continuous": "ROADMAP queue A item 8 (continuous batching + paged KV)",
    "paged": "ROADMAP queue A item 8 (continuous batching + paged KV)",
    "spec_depth": "ROADMAP queue A item 9 (self-speculative decoding)",
    "prefix_cache": "ROADMAP queue A item 10 (prefix sharing)",
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


def main(argv=None):
    """Run the CLI; returns the timed run's ``GenerateResult``."""
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
                    help=_LATER["continuous"])
    ap.add_argument("--paged", action="store_true", help=_LATER["paged"])
    ap.add_argument("--spec-depth", type=int, default=None,
                    help=_LATER["spec_depth"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help=_LATER["prefix_cache"])
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise SystemExit(f"--mesh {args.mesh}: the port serves on one device "
                         "(mesh sharding: ROADMAP queue A item 13)")
    for flag, item in _LATER.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"{item}")

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.checkpoint:
        params, cfg = load_params(args.checkpoint, cfg, step=args.step)
    else:
        gen = torch.Generator().manual_seed(args.seed)
        params = registry.get_model(cfg).init(gen, cfg, device="cpu")
    rng = np.random.default_rng(args.seed)
    engine = ServeEngine(cfg, params, device=args.device,
                         max_len=args.prompt_len + max(args.gen, 1) + 1)

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


if __name__ == "__main__":
    main()

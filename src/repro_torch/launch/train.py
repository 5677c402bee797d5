"""Training CLI of the port (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gpt2-12l --source-layers 1 --tau 0.8 --init random \\
        --steps 1000 --seq-len 256 --batch 16 --schedule wsd \\
        --optimizer muon_nsgd --lr 0.01 --ckpt-dir /tmp/run1   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --steps 6 --tau 0.5 --seq-len 32 --batch 8 # CPU

Runs the paper's progressive recipe end to end: train a ``--source-layers``
source, expand to the architecture's depth at τ = ``--tau``·steps, keep
training, checkpoint every expansion boundary.  Prints ``[expand] step=N
-> L layers``, ``final loss: ... (layers L)`` and, per depth, the training
throughput: batch·seq_len tokens per step over the synchronized step time,
leaving out the first step at each depth (it builds the kernels and sizes
the allocator).  The reference's flags that select paths not ported yet
exit, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs as cfglib
from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                      ScheduleConfig, TrainConfig)
from repro_torch.train import loop

_A11 = "ROADMAP queue A item 11 (fault tolerance)"


def _refuse_later(args):
    later = []
    if args.mesh != "single":
        later.append(("--mesh", "ROADMAP queue A item 13 (distributed)"))
    if args.remat != "off":
        later.append(("--remat",
                      "ROADMAP queue A item 15 (activation checkpointing)"))
    for flag, value, off in (("--faults", args.faults, None),
                             ("--nan-policy", args.nan_policy, "off"),
                             ("--nan-inject", args.nan_inject, None),
                             ("--expansion-guard", args.expansion_guard,
                              False),
                             ("--hang-deadline-s", args.hang_deadline_s,
                              None)):
        if value != off:
            later.append((flag, _A11))
    if later:
        raise SystemExit("not ported yet: " + "; ".join(
            f"{flag} ({item})" for flag, item in later))


def throughput_lines(step_times, tokens_per_step: int):
    """One line per depth: tokens/s over that depth's steps after its
    first."""
    lines = []
    depths = []
    for layers, _ in step_times:
        if layers not in depths:
            depths.append(layers)
    for layers in depths:
        dts = [dt for L, dt in step_times if L == layers][1:]
        if not dts:
            lines.append(f"train tokens/s layers={layers}: not measured "
                         "(one step at this depth)")
            continue
        rate = tokens_per_step * len(dts) / sum(dts)
        lines.append(f"train tokens/s layers={layers}: {rate:.1f} "
                     f"({len(dts)} steps of {tokens_per_step} tokens, "
                     f"{1e3 * sum(dts) / len(dts):.2f} ms per step)")
    return lines


def main(argv=None):
    """Run the CLI; returns the ``TrainResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-12l")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--source-layers", type=int, default=1)
    ap.add_argument("--tau", type=float, default=0.8,
                    help="expansion point as fraction of total steps; "
                    "<=0 disables expansion (fixed-size training)")
    ap.add_argument("--init", default="random",
                    choices=["random", "zero", "copying_stack",
                             "copying_inter", "copying_last",
                             "copying_zeroL", "copying_zeroN"])
    ap.add_argument("--os-policy", default="inherit",
                    choices=["inherit", "copy", "reset"])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine",
                                                          "constant"])
    ap.add_argument("--optimizer", default="muon_nsgd",
                    choices=["muon_nsgd", "adamw", "nsgd", "sgd"],
                    help="only muon_nsgd is ported (the others: ROADMAP "
                    "queue A item 5)")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--remat", nargs="?", const="auto", default="off",
                    choices=["off", "auto", "nothing", "dots"],
                    help="only 'off' (activation checkpointing: ROADMAP "
                    "queue A item 15)")
    ap.add_argument("--mesh", default="single",
                    help="only 'single' (mesh sharding: ROADMAP queue A "
                    "item 13)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step (gradient accumulation); "
                    "must divide --batch")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help=f"not ported ({_A11})")
    ap.add_argument("--nan-policy", default="off",
                    choices=["off", "warn", "skip", "rollback"],
                    help=f"only 'off' ({_A11})")
    ap.add_argument("--nan-inject", default=None, metavar="SPEC",
                    help=f"not ported ({_A11})")
    ap.add_argument("--expansion-guard", action="store_true",
                    help=f"not ported ({_A11})")
    ap.add_argument("--retries", type=int, default=2,
                    help="max retries per transient fault site (no effect "
                    "without the fault plane)")
    ap.add_argument("--hang-deadline-s", type=float, default=None,
                    help=f"not ported ({_A11})")
    args = ap.parse_args(argv)
    _refuse_later(args)

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    period = cfg.pattern_period
    src = args.source_layers - args.source_layers % period \
        if args.source_layers >= period else 0
    expansions = ()
    if args.tau > 0:
        expansions = (ExpansionConfig(at_frac=args.tau,
                                      target_layers=cfg.num_layers,
                                      init=args.init,
                                      opt_state_policy=args.os_policy),)
    else:
        src = cfg.num_layers
    tcfg = TrainConfig(
        total_steps=args.steps, seq_len=args.seq_len, global_batch=args.batch,
        grad_accum=args.grad_accum, source_layers=src, expansions=expansions,
        optimizer=OptimizerConfig(name=args.optimizer, learning_rate=args.lr),
        schedule=ScheduleConfig(name=args.schedule), seed=args.seed)
    res = loop.train(cfg, tcfg, checkpoint_dir=args.ckpt_dir,
                     device=args.device)
    print(f"final loss: {res.history['loss'][-1]:.4f} "
          f"(layers {res.final_layers})")
    for line in throughput_lines(res.step_times, args.batch * args.seq_len):
        print(line)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(res.history, f)
    return res


if __name__ == "__main__":
    main()

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
the allocator).  ``--optimizer`` takes the reference's four optimizers and
``--remat`` its activation checkpointing (a bare ``--remat`` picks the
architecture's policy from ``configs.REMAT_DEFAULTS``).  The fault-tolerance flags (``--faults``,
``--nan-policy``, ``--nan-inject``, ``--expansion-guard``,
``--hang-deadline-s``) are the reference's and print its ``faults:``
line.  ``--mesh SPEC`` trains on a device mesh (FSDP over 'data', tensor
parallelism over 'model') with ``--nproc N`` local ranks or under
``torchrun``:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --mesh 2x2 --nproc 4 --steps 6 --tau 0.5  # CPU, gloo
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x2 \
        --nproc 2 --steps 8 --tau 0.5 --seq-len 256 --batch 16  # one card

Two ranks on one card talk over gloo (NCCL takes one rank a device).
``whisper-base`` exits too: the trainer's synthetic batches carry no
encoder ``frames`` (the reference's trainer fails on them with a
``KeyError``); ``train.steps.make_train_step`` trains it on batches that
carry them.
"""
from __future__ import annotations

import argparse
import json
import sys

FAULT_GRAMMAR = """\
fault spec grammar (shared with launch/serve.py — one FaultPlane.parse):
  site:nth[:kind],...   the nth (1-based) hit of a named site raises; kind
                        is 'fault' (transient, retried/contained) or 'crash'
                        (process death — resume from --ckpt-dir to recover)
  storm:rate[:seed]     seeded Bernoulli fault storm over all non-iteration
                        sites
train-side sites: train.batch train.step train.eval train.expand train.iter
                  ckpt.write ckpt.restore   (train.iter = scheduled-crash
                  point, e.g. train.iter:40:crash)
example: --faults ckpt.write:1,train.iter:120:crash --nan-policy skip
"""

from repro_torch import configs as cfglib
from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                      ScheduleConfig, TrainConfig)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import loop


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
    ap = argparse.ArgumentParser(
        epilog=FAULT_GRAMMAR,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gpt2-12l", help=cfglib.ARCH_HELP)
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
                    choices=["muon_nsgd", "adamw", "nsgd", "sgd"])
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--remat", nargs="?", const="auto", default="off",
                    choices=["off", "auto", "nothing", "dots"],
                    help="activation checkpointing: bare --remat picks the "
                    "arch's measured policy (configs.REMAT_DEFAULTS); "
                    "'nothing' recomputes everything, 'dots' saves matmul "
                    "outputs")
    mesh_lib.add_mesh_args(ap)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step (gradient accumulation); "
                    "must divide --batch")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault injection (see grammar below)")
    ap.add_argument("--nan-policy", default="off",
                    choices=["off", "warn", "skip", "rollback"],
                    help="bad-step sentinel ladder: warn logs, skip discards "
                    "the update, rollback also restores the latest "
                    "checkpoint after repeated bad steps")
    ap.add_argument("--nan-inject", default=None, metavar="SPEC",
                    help="numerical fault injection 'kind:step[@attempt],...'"
                    " with kind nan|spike (testing the sentinels)")
    ap.add_argument("--expansion-guard", action="store_true",
                    help="post-expansion divergence watchdog: auto-rollback "
                    "to the boundary checkpoint and retry with a "
                    "function-preserving init / deferred tau")
    ap.add_argument("--retries", type=int, default=2,
                    help="max retries per transient fault site")
    ap.add_argument("--hang-deadline-s", type=float, default=None,
                    help="fail a train step as a train.step fault if it "
                    "exceeds this wall time instead of stalling")
    args = ap.parse_args(argv)
    if args.nproc > 1:
        mesh_lib.run_ranks(__name__ if __name__ != "__main__"
                           else "repro_torch.launch.train",
                           sys.argv[1:] if argv is None else argv,
                           args.nproc, args.device)
        return None
    mesh = (mesh_lib.make_train_mesh(args.mesh, device=args.device)
            if args.mesh else None)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if cfg.is_encoder_decoder:
        raise SystemExit(
            f"{cfg.name}: the trainer's synthetic batches carry no encoder "
            "'frames' (the reference's trainer fails on them with a "
            "KeyError); train an encoder-decoder with "
            "train.steps.make_train_step on batches that carry them")
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
        schedule=ScheduleConfig(name=args.schedule), seed=args.seed,
        remat=(False if args.remat == "off"
               else cfglib.default_remat(args.arch) if args.remat == "auto"
               else args.remat))
    res = loop.train(cfg, tcfg, checkpoint_dir=args.ckpt_dir,
                     device=args.device, mesh=mesh, log_fn=say,
                     faults=args.faults,
                     nan_policy=args.nan_policy, nan_inject=args.nan_inject,
                     expansion_guard=args.expansion_guard,
                     max_retries=args.retries,
                     hang_deadline_s=args.hang_deadline_s)
    say(f"final loss: {res.history['loss'][-1]:.4f} "
        f"(layers {res.final_layers})"
        + (f" mesh={args.mesh} ({mesh.spec()}, {mesh.backend})"
           if mesh is not None else ""))
    fs = res.fault_stats
    if (args.faults or args.nan_policy != "off" or args.nan_inject
            or args.expansion_guard or args.hang_deadline_s is not None):
        say(f"faults: retries={fs['retries']} "
              f"ckpt_failures={fs['ckpt_failures']} "
              f"skipped={fs['skipped_steps']} "
              f"nan_rollbacks={fs['nan_rollbacks']} "
              f"guard_events={fs['guard_events']} hangs={fs['hangs']} "
              f"site_hits={fs['fault_counts']} fired={fs['fired']}")
    for line in throughput_lines(res.step_times, args.batch * args.seq_len):
        say(line)
    if args.history_out and rank0:
        with open(args.history_out, "w") as f:
            json.dump(res.history, f)
    return res


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: the paper's recipe in ~40 lines.

Trains a ZERO-layer GPT2-style model for 60% of the horizon, expands to the
4-layer target with random initialization during the WSD stable phase, and
shows (i) the loss spike at expansion, (ii) mixing back toward the
fixed-size run, (iii) the compute savings of eq (1.1).  The same recipe as
``examples/quickstart.py``, through ``repro_torch`` on the card (or the
CPU with ``--device cpu``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import (ExpansionConfig, ModelConfig,  # noqa: E402
                                      OptimizerConfig, ScheduleConfig,
                                      TrainConfig)
from repro_torch.core.mixing import compute_savings  # noqa: E402
from repro_torch.train import loop  # noqa: E402

MODEL = ModelConfig(name="quickstart", family="dense", num_layers=4,
                    d_model=128, num_heads=4, num_kv_heads=4, d_ff=512,
                    vocab_size=512, attention="mha", activation="gelu",
                    norm="layernorm", position="absolute", tie_embeddings=True,
                    max_seq_len=128)
STEPS, TAU, SEQ, BATCH = 150, 0.6, 64, 8


def savings_line(model, total_steps: int, tau: int, batch_tokens: int,
                 source_layers: int = 0) -> str:
    """The eq (1.1) line: compute saved by growing ``model`` from
    ``source_layers`` at step ``tau`` of ``total_steps``."""
    sav = compute_savings(total_steps, tau,
                          model.with_depth(source_layers).param_count(),
                          model.param_count(), batch_tokens)
    return (f"compute: {sav['savings']:.1%} saved vs fixed-size "
            f"({sav['speedup']:.2f}x speedup) — eq (1.1)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_cfg = TrainConfig(
        total_steps=STEPS, seq_len=SEQ, global_batch=BATCH,
        source_layers=0,                                # zero-layer source!
        expansions=(ExpansionConfig(at_frac=TAU, target_layers=4,
                                    init="random"),),
        optimizer=OptimizerConfig(name="muon_nsgd", learning_rate=0.02),
        schedule=ScheduleConfig(name="wsd", decay_frac=0.2),
        eval_every=10**9, log_every=5, checkpoint_every=10**9)

    print("=== zero-layer progressive training (paper recipe, §7) ===")
    result = loop.train(MODEL, train_cfg, device=args.device)

    h = result.history
    print(f"\nexpansion at step {h['expansion_steps']}; "
          f"final loss {h['loss'][-1]:.4f} at depth {result.final_layers}")
    print(savings_line(MODEL, STEPS, int(TAU * STEPS), SEQ * BATCH))
    return result


if __name__ == "__main__":
    main()

"""Progressive vs fixed-size training on the SAME data stream (the
paper's Figure 7 comparison) on the PyTorch port, several hundred steps:
the recipe of ``examples/progressive_vs_fixed.py`` through ``repro_torch``.

By default runs a ~5M-param GPT2-style model for 300 steps on the card
(``--device cpu`` for the CPU); pass --big for the 12-layer 124M
configuration.

    PYTHONPATH=src python examples/progressive_vs_fixed_torch.py \
        [--big] [--steps N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.configs.base import (ExpansionConfig, ModelConfig,  # noqa: E402
                                      OptimizerConfig, ScheduleConfig,
                                      TrainConfig)
from repro_torch.core.mixing import detect_mixing  # noqa: E402
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,  # noqa: E402
                                        make_eval_batches)
from repro_torch.train import loop  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true",
                    help="paper-scale gpt2-12l (124M)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.big:
        model = cfglib.get_config("gpt2-12l")
        seq, batch = 1024, 64
    else:
        model = ModelConfig(name="gpt2-mini", family="dense", num_layers=4,
                            d_model=128, num_heads=4, num_kv_heads=4,
                            d_ff=512, vocab_size=1024, attention="mha",
                            activation="gelu", norm="layernorm",
                            position="absolute", tie_embeddings=True,
                            max_seq_len=128)
        seq, batch = 64, 16

    dcfg = DataConfig(vocab_size=model.vocab_size, seq_len=seq,
                      global_batch=batch, seed=0)
    evals = make_eval_batches(dcfg, 2)

    def tcfg(source_layers, expansions):
        return TrainConfig(total_steps=args.steps, seq_len=seq,
                           global_batch=batch, source_layers=source_layers,
                           expansions=expansions,
                           optimizer=OptimizerConfig(name="muon_nsgd",
                                                     learning_rate=0.01),
                           schedule=ScheduleConfig(name="wsd"),
                           eval_every=10**9, log_every=5,
                           checkpoint_every=10**9)

    print("=== fixed-size baseline ===")
    fixed = loop.train(model, tcfg(model.num_layers, ()),
                       data=SyntheticLM(dcfg), eval_batches=evals,
                       device=args.device)
    print("\n=== zero-layer progressive (tau = 0.6T, random init, WSD) ===")
    prog = loop.train(model, tcfg(0, (ExpansionConfig(
        at_frac=0.6, target_layers=model.num_layers, init="random"),)),
        data=SyntheticLM(dcfg), eval_batches=evals, device=args.device)

    rep = detect_mixing(prog.history["loss"], fixed.history["loss"],
                        expansion_step=prog.history["expansion_steps"][0]
                        // max(1, tcfg(0, ()).log_every),
                        tokens_per_step=seq * batch, tolerance=0.05,
                        patience=2)
    lf, lp = fixed.history["loss"][-1], prog.history["loss"][-1]
    print(f"\nfixed final {lf:.4f} | progressive final {lp:.4f} "
          f"(delta {abs(lp - lf) / lf:.2%})")
    print(f"mixing detected: {rep.mixed} (step {rep.mix_step}, "
          f"~{rep.mix_tokens} tokens after expansion)" if rep.mixed else
          "no mixing within horizon (increase --steps)")


if __name__ == "__main__":
    main()

"""Recipe automation (``repro/core/recipe.py``) — paper §7 step 4, end to
end.

"The timing of depth expansion τ (or equivalently the mixing time t_mix) can
be determined by two small-scale runs: one fixed-size training and one
progressive training (τ at the end of warmup), both early stopped when their
losses mix."

``calibrate_tau`` runs exactly those two probe runs on the target
architecture (optionally at reduced width — mixing time transfers, §C.1)
through the port's ``train.loop.train`` on ``device``, detects mixing,
transfers t_mix by token count (§C.4), and returns the production
:class:`TrainConfig` with τ = stable_end − t_mix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ExpansionConfig, ModelConfig, TrainConfig
from repro_torch.core.mixing import (MixingReport, detect_mixing,
                                     plan_expansion_step, transfer_mix_steps)
from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                        make_eval_batches)
from repro_torch.train import loop


@dataclasses.dataclass
class CalibrationResult:
    mixing: MixingReport
    probe_steps: int
    tau: int
    train_config: TrainConfig


def calibrate_tau(model_cfg: ModelConfig, base: TrainConfig,
                  probe_steps: Optional[int] = None,
                  probe_batch: Optional[int] = None,
                  tolerance: float = 0.02,
                  log_fn=print, device="cuda") -> CalibrationResult:
    """Run the two early-stopped probe runs on ``device`` and emit the
    production config.

    The probes share the data stream; the progressive probe expands right
    after warmup (the earliest admissible τ).  If the probes do not mix
    within `probe_steps`, τ falls back to the end of warmup (conservative).
    """
    probe_steps = probe_steps or max(50, base.total_steps // 10)
    probe_batch = probe_batch or base.global_batch
    warmup = max(1, int(base.schedule.warmup_frac * probe_steps))

    dcfg = DataConfig(vocab_size=model_cfg.vocab_size, seq_len=base.seq_len,
                      global_batch=probe_batch, seed=base.seed)
    evals = make_eval_batches(dcfg, 2)

    def probe(source_layers, expansions):
        tcfg = dataclasses.replace(
            base, total_steps=probe_steps, global_batch=probe_batch,
            source_layers=source_layers, expansions=expansions,
            checkpoint_every=10**9, eval_every=10**9, log_every=1)
        return loop.train(model_cfg, tcfg, data=SyntheticLM(dcfg),
                          eval_batches=evals, log_fn=lambda *a: None,
                          device=device)

    log_fn(f"[recipe] probe 1/2: fixed-size {model_cfg.num_layers}L, "
           f"{probe_steps} steps")
    fixed = probe(model_cfg.num_layers, ())
    log_fn(f"[recipe] probe 2/2: progressive {base.source_layers}L -> "
           f"{model_cfg.num_layers}L at end of warmup")
    prog = probe(base.source_layers, (ExpansionConfig(
        at_frac=(warmup + 1) / probe_steps,
        target_layers=model_cfg.num_layers, init="random"),))

    tokens_per_step = base.seq_len * probe_batch
    exp_step = prog.history["expansion_steps"][0]
    # histories are logged every step (log_every=1 above)
    rep = detect_mixing(prog.history["loss"], fixed.history["loss"],
                        expansion_step=exp_step,
                        tokens_per_step=tokens_per_step,
                        tolerance=tolerance, patience=3)
    if rep.mixed:
        mix_steps = transfer_mix_steps(
            rep.mix_tokens, base.seq_len * base.global_batch)
        log_fn(f"[recipe] mixed after {rep.mix_tokens} tokens "
               f"(~{mix_steps} production steps)")
    else:
        mix_steps = base.total_steps - int(
            base.schedule.warmup_frac * base.total_steps) - 1
        log_fn("[recipe] probes did not mix — falling back to earliest τ")

    tau = plan_expansion_step(base.schedule, base.total_steps, mix_steps)
    final = dataclasses.replace(base, expansions=(ExpansionConfig(
        at_frac=tau / base.total_steps, target_layers=model_cfg.num_layers,
        init="random" if base.source_layers == 0 else "copying_stack"),))
    log_fn(f"[recipe] production τ = step {tau} "
           f"({tau / base.total_steps:.0%} of horizon)")
    return CalibrationResult(mixing=rep, probe_steps=probe_steps, tau=tau,
                             train_config=final)

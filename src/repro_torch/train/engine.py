"""Progressive training engine (``repro/train/engine.py``, the clean path).

``ProgressiveTrainer`` runs the paper's recipe: source-model training, depth
expansion at τ, grown-model training under one schedule and one optimizer,
on one device.

  * Fresh init draws the params from ``torch.Generator().manual_seed(
    tcfg.seed)`` on the host, so a seed gives the same weights on the card
    and on the CPU (not the reference's threefry weights).  A run with a
    ``checkpoint_dir`` that holds checkpoints resumes from the latest:
    labels count completed steps, so resume replays nothing.
  * Every expansion boundary is checkpointed with label τ before the
    expansion mutates anything; ``random`` inits draw from a generator
    seeded ``seed + 17 + τ``, as the reference keys them.
  * Eval every ``eval_every`` steps, periodic saves every
    ``checkpoint_every``, a final save; the history keys are the
    reference's.

On a CUDA device TF32 is switched off for matmuls and cuDNN, so float32
means float32 on the card as on the CPU.  The reference's mesh, fault
plane, NaN sentinels, expansion guard and straggler monitor are not
ported: each argument that would turn one on raises, naming its ROADMAP
item.  Checkpoints are written synchronously (the reference's
asynchronous checkpointer: ROADMAP queue A item 6).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import expansion as exp
from repro_torch.core.schedules import make_schedule
from repro_torch.data.synthetic import DataConfig, SyntheticLM, make_eval_batches
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.optim.base import make_optimizer
from repro_torch.train import steps as steps_lib
from repro_torch.tree import tree_map

_A11 = "ROADMAP queue A item 11 (fault tolerance)"
_NOT_PORTED = {
    "mesh": "ROADMAP queue A item 13 (distributed): the port trains on one "
            "device",
    "faults": f"{_A11}: the train-side fault plane",
    "nan_policy": f"{_A11}: the NaN/spike sentinels",
    "nan_inject": f"{_A11}: the NaN/spike sentinels",
    "expansion_guard": f"{_A11}: the post-expansion divergence guard",
    "hang_deadline_s": f"{_A11}: the straggler monitor's hang deadline",
}
_OFF = {"mesh": None, "faults": None, "nan_policy": "off", "nan_inject": None,
        "expansion_guard": False, "hang_deadline_s": None}


@dataclasses.dataclass
class TrainResult:
    history: Dict[str, List]
    params: object
    opt_state: object
    final_layers: int
    # (layers, seconds) of every step this run took, each ending in a
    # device synchronize: the launcher's tokens/s per depth.
    step_times: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)


class ProgressiveTrainer:
    """Progressive-training engine on one device (see module docstring)."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainConfig,
                 checkpoint_dir: Optional[str] = None,
                 data: Optional[SyntheticLM] = None, eval_batches=None,
                 dtype=torch.float32, log_fn: Callable = print,
                 device="cuda", mesh=None, faults=None,
                 nan_policy: str = "off", nan_inject=None,
                 expansion_guard: bool = False,
                 hang_deadline_s: Optional[float] = None):
        given = dict(mesh=mesh, faults=faults, nan_policy=nan_policy,
                     nan_inject=nan_inject, expansion_guard=expansion_guard,
                     hang_deadline_s=hang_deadline_s)
        for name, value in given.items():
            if value != _OFF[name]:
                raise NotImplementedError(f"{name}={value!r}: "
                                          f"{_NOT_PORTED[name]}")
        if tcfg.global_batch % max(tcfg.grad_accum, 1):
            raise ValueError(f"global_batch {tcfg.global_batch} not divisible "
                             f"by grad_accum {tcfg.grad_accum}")
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.checkpoint_dir = checkpoint_dir
        self.dtype = dtype
        self.log_fn = log_fn
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        dcfg = DataConfig(vocab_size=model_cfg.vocab_size,
                          seq_len=tcfg.seq_len,
                          global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.data = data or SyntheticLM(dcfg)
        self.eval_batches = (eval_batches if eval_batches is not None
                             else make_eval_batches(dcfg, tcfg.eval_batches))
        self.opt = make_optimizer(tcfg.optimizer)
        self.schedule = make_schedule(tcfg.schedule,
                                      tcfg.optimizer.learning_rate,
                                      tcfg.total_steps)

    def _build_steps(self, cfg: ModelConfig):
        train_step = steps_lib.make_train_step(
            cfg, self.opt, self.schedule, remat=self.tcfg.remat,
            grad_accum=self.tcfg.grad_accum)
        return train_step, steps_lib.make_eval_step(cfg)

    def _restore_state(self, step: int):
        """Load checkpoint label ``step``: (metadata, layers, cfg, params,
        opt_state), the leaves on this run's device."""
        meta = ckpt.load_metadata(self.checkpoint_dir, step)
        layers = int(meta["num_layers"])
        cfg = self.model_cfg.with_depth(layers)
        like_p = registry.get_model(cfg).init(None, cfg, dtype=self.dtype,
                                              device="meta")
        like = {"params": like_p, "opt_state": self.opt.init(like_p)}
        tree = ckpt.restore(self.checkpoint_dir, step, like)
        state = tree_map(lambda t: t.to(self.device),
                         bridge.params_from_jax(tree))
        return meta, layers, cfg, state["params"], state["opt_state"]

    def _init_state(self, cfg: ModelConfig):
        api = registry.get_model(cfg)
        params = api.init(torch.Generator().manual_seed(self.tcfg.seed), cfg,
                          dtype=self.dtype, device=self.device)
        return params, self.opt.init(params)

    def _place_batch(self, host_batch):
        return {k: torch.from_numpy(np.asarray(v)).to(self.device).long()
                for k, v in host_batch.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> TrainResult:
        tcfg, model_cfg = self.tcfg, self.model_cfg
        exp_steps = {max(1, int(e.at_frac * tcfg.total_steps)): e
                     for e in sorted(tcfg.expansions, key=lambda e: e.at_frac)}
        history = {"step": [], "loss": [], "lr": [], "eval_step": [],
                   "eval_loss": [], "layers": [], "expansion_steps": [],
                   "step_time": [], "sentinel": [], "skipped_steps": [],
                   "expansion_guard": [], "hangs": []}
        step_times: List[Tuple[int, float]] = []

        # Labels mean "steps completed": resume replays nothing.
        start_step = 0
        cur_layers = tcfg.source_layers
        meta = None
        if self.checkpoint_dir:
            latest = ckpt.latest_step(self.checkpoint_dir)
            if latest is not None:
                (meta, cur_layers, cur_cfg, params,
                 opt_state) = self._restore_state(latest)
                start_step = latest
                for k, v in meta.get("history", {}).items():
                    history[k] = list(v)
                self.log_fn(f"[resume] step={start_step} layers={cur_layers}")
        if meta is None:
            cur_cfg = model_cfg.with_depth(cur_layers)
            params, opt_state = self._init_state(cur_cfg)
        train_step, eval_step = self._build_steps(cur_cfg)

        def save(done):
            """Checkpoint with label = completed steps.  The metadata keeps
            the reference's keys (its sentinel and guard state at their
            idle values), so the JAX engine resumes from it."""
            if not self.checkpoint_dir:
                return
            m = {"num_layers": cur_layers, "name": model_cfg.name,
                 "data_step": done, "gnorm_ema": 0.0, "loss_ema": None,
                 "guard": {"boundary": -1, "until": -1, "baseline": None,
                           "attempt": 0, "retries": 0},
                 "history": {k: v for k, v in history.items()
                             if k != "step_time"}}
            ckpt.save(self.checkpoint_dir, done,
                      {"params": params, "opt_state": opt_state},
                      metadata=json.loads(json.dumps(m)),
                      keep=tcfg.keep_checkpoints)

        step = start_step
        while step < tcfg.total_steps:
            # ---- depth expansion at τ (paper's technique) ----------------
            if step in exp_steps and cur_layers < exp_steps[step].target_layers:
                e = exp_steps[step]
                save(step)                   # expansion boundary checkpoint
                expand_fn = exp.make_expand_fn(
                    cur_cfg, e.target_layers, e.init, insert_at=e.insert_at,
                    opt_state_policy=e.opt_state_policy, dtype=self.dtype)
                params, opt_state = expand_fn(
                    params, opt_state,
                    torch.Generator().manual_seed(tcfg.seed + 17 + step))
                cur_layers = e.target_layers
                cur_cfg = model_cfg.with_depth(cur_layers)
                train_step, eval_step = self._build_steps(cur_cfg)
                history["expansion_steps"].append(step)
                self.log_fn(f"[expand] step={step} -> {cur_layers} layers "
                            f"({e.init}, OS={e.opt_state_policy})")

            batch = self._place_batch(self.data.batch(step))
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            self._sync()
            dt = time.perf_counter() - t0
            step_times.append((cur_layers, dt))

            if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
                loss = float(metrics["loss"])
                history["step"].append(step)
                history["loss"].append(loss)
                history["lr"].append(float(metrics["lr"]))
                history["layers"].append(cur_layers)
                history["step_time"].append(dt)
                if step % (tcfg.log_every * 10) == 0:
                    self.log_fn(f"step {step:6d} layers {cur_layers:3d} "
                                f"loss {loss:.4f} "
                                f"lr {float(metrics['lr']):.2e}")

            if step and step % tcfg.eval_every == 0:
                history["eval_step"].append(step)
                history["eval_loss"].append(float(np.mean(
                    [float(eval_step(params, self._place_batch(b)))
                     for b in self.eval_batches])))

            done = step + 1
            if (self.checkpoint_dir and done % tcfg.checkpoint_every == 0
                    and done < tcfg.total_steps):
                save(done)
            step += 1

        save(tcfg.total_steps)
        return TrainResult(history=history, params=params,
                           opt_state=opt_state, final_layers=cur_layers,
                           step_times=step_times)


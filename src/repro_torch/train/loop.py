"""Progressive training loop (``repro/train/loop.py``): a thin wrapper over
``repro_torch.train.engine.ProgressiveTrainer`` on one device or, with
``mesh=``, on every rank of a mesh."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.engine import ProgressiveTrainer, TrainResult

__all__ = ["train", "TrainResult", "ProgressiveTrainer"]


def train(model_cfg: ModelConfig, tcfg: TrainConfig,
          checkpoint_dir: Optional[str] = None,
          data: Optional[SyntheticLM] = None,
          eval_batches=None,
          dtype=torch.float32,
          log_fn: Callable = print,
          device="cuda", **engine_kwargs) -> TrainResult:
    """Run (possibly progressive) training.  ``model_cfg.num_layers`` is the
    target depth; training starts at ``tcfg.source_layers`` and follows
    ``tcfg.expansions``.  Extra keyword arguments (``faults``,
    ``nan_policy``, ``expansion_guard``, ...) pass through to
    ``ProgressiveTrainer``."""
    return ProgressiveTrainer(model_cfg, tcfg, checkpoint_dir=checkpoint_dir,
                              data=data, eval_batches=eval_batches,
                              dtype=dtype, log_fn=log_fn, device=device,
                              **engine_kwargs).run()

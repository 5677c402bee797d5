#!/usr/bin/env python3
"""The asynchronous checkpoint save around 12-layer ``gpt2-12l`` train
steps on one card, three ways, beside the synchronous save.

    python3 tools/async_save_variants.py   # on a machine with an H100

Random weights from seed 0 and phase 13's batch (16 x 256); the tree is
params and Muon momenta, ~1 GB.  For each way: three steps alone, a
synchronous ``checkpointer.save``, then ``AsyncCheckpointer.save`` (its
hold on the caller), the three steps after it and the rest of the write.

* ``device-wide sync``: steps timed to ``torch.cuda.synchronize()``,
  which also waits for the worker's copy on its side stream;
* ``stream sync``: steps timed to the compute stream, as the trainer
  waits for a step;
* ``stream sync, pinned``: the worker copies into pinned host buffers
  with ``non_blocking`` copies and one side-stream synchronize;
* ``stream sync again``: the second way repeated, for the spread.
"""
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs as cfglib  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.core.schedules import make_schedule  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.base import make_optimizer  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


class PinnedCheckpointer(ckpt.AsyncCheckpointer):
    """``AsyncCheckpointer`` whose worker copies into pinned buffers."""

    def save(self, directory, step, tree, metadata=None, keep=3,
             faults=None):
        self.wait()
        snap = tree_map(lambda x: x.detach().clone(), tree)
        ready = torch.cuda.Event()
        ready.record()
        side = torch.cuda.Stream()

        def run():
            try:
                ready.synchronize()
                with torch.cuda.stream(side):
                    host = tree_map(lambda x: torch.empty(
                        x.shape, dtype=x.dtype, pin_memory=True).copy_(
                            x, non_blocking=True), snap)
                side.synchronize()
                ckpt.save(directory, step, host, metadata, keep,
                          faults=faults)
            except BaseException as e:
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("async_save_variants: needs a CUDA device")
    print(cs.card_line())
    _build.build_all()
    cfg = cfglib.get_config("gpt2-12l")
    tc = cs._fault_tcfg()
    opt = make_optimizer(tc.optimizer)
    p = registry.get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                     device="cuda")
    o = opt.init(p)
    step = steps_lib.make_train_step(
        cfg, opt, make_schedule(tc.schedule, tc.optimizer.learning_rate,
                                tc.total_steps))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tc.seq_len,
                                  global_batch=tc.global_batch, seed=0))
    batch = {k: torch.from_numpy(np.asarray(v)).cuda().long()
             for k, v in data.batch(0).items()}
    tree = {"params": p, "opt_state": o}

    def timed(fn, device_wide):
        sync = torch.cuda.synchronize if device_wide \
            else torch.cuda.current_stream().synchronize
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def ms(xs):
        return [round(1e3 * x, 1) for x in xs]
    for _ in range(3):
        step(p, o, batch, 11)
    for label, cls, wide in (
            ("device-wide sync", ckpt.AsyncCheckpointer, True),
            ("stream sync", ckpt.AsyncCheckpointer, False),
            ("stream sync, pinned", PinnedCheckpointer, False),
            ("stream sync again", ckpt.AsyncCheckpointer, False)):
        alone = [timed(lambda: step(p, o, batch, 11), wide)
                 for _ in range(3)]
        with tempfile.TemporaryDirectory() as tmp:
            sync = timed(lambda: ckpt.save(tmp, 1, tree), wide)
            ac = cls()
            call = timed(lambda: ac.save(tmp, 2, tree), wide)
            during = [timed(lambda: step(p, o, batch, 11), wide)
                      for _ in range(3)]
            t0 = time.perf_counter()
            ac.wait()
            rest = time.perf_counter() - t0
            if ckpt.latest_step(tmp) != 2:
                raise SystemExit(f"{label}: the async save did not land")
        print(f"{label}: alone {ms(alone)} ms; sync save "
              f"{sync * 1e3:.1f}; async call {call * 1e3:.1f}, next 3 "
              f"steps {ms(during)}, rest of the write {rest * 1e3:.1f} ms")


if __name__ == "__main__":
    main()

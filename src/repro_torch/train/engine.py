"""Progressive training engine (``repro/train/engine.py``).

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
    reference's.  With ``async_ckpt=True`` (default) the device-to-host
    copy and the file write overlap the next step
    (``checkpoint.AsyncCheckpointer``, which clones on the card first: the
    step writes params and momenta in place).

The reference's fault plane (``train.faults``): every train site fires
before the operation mutates anything, transient faults are retried with
backoff, a failed checkpoint write is contained and counted, and a
``CrashError`` unwinds the run, which a restarted trainer resumes byte for
byte.  While a crash unwinds, the trainer joins the checkpoint write in
flight (dropping any error of the writer in the crash's favor), so the
latest checkpoint on disk is the one the run had started to write.  The
NaN/spike sentinel ladder (``warn``/``skip``/``rollback``), the
post-expansion divergence guard and the hang deadline
(``distributed.collectives.StragglerMonitor`` over a synchronized step
time) are the reference's.

On a CUDA device TF32 is switched off for matmuls and cuDNN, so float32
means float32 on the card as on the CPU.

On a mesh (``mesh=``, a ``launch.mesh.Mesh`` or a spec string; one
process per rank, every rank running this trainer) each rank holds its
shards of params and moments under ``distributed.sharding``'s rules
(``fsdp``, ``layout``, ``moe_fsdp``, the reference's defaults) and its
rows of every global batch.  Every rank draws the same full initial
weights (and fresh expansion blocks) from one generator and keeps its
slice, so sharded init equals single-device init.  Checkpoints are
written whole by rank 0 and restore under any mesh.  ``history`` is the
same on every rank (rank 0 logs): losses are means over the DP ranks, the
fault plane's decisions, the checkpoint outcome and the step time are
all-reduced, so every rank takes the same branch.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import StragglerMonitor
from repro_torch.distributed.context import MeshContext
from repro_torch.models import registry
from repro_torch.models.common import resolve_device
from repro_torch.optim.base import make_optimizer
from repro_torch.train import faults as faults_lib
from repro_torch.train import steps as steps_lib
from repro_torch.tree import leaves_with_path, tree_map, tree_map_with_path


@dataclasses.dataclass
class TrainResult:
    history: Dict[str, List]
    params: object
    opt_state: object
    final_layers: int
    # (layers, seconds) of every step this run took, each ending in a
    # synchronize of the compute stream: the launcher's tokens/s per depth.
    step_times: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)
    # Retry/containment counters plus the fault plane's coverage receipts.
    fault_stats: Dict = dataclasses.field(default_factory=dict)


class ProgressiveTrainer:
    """Progressive-training engine on one device or a mesh (see module
    docstring).

    Robustness knobs, all off by default (the clean path runs the plain
    step): ``faults`` (a plane or spec string, ``faults.resolve``) with
    ``max_retries`` and ``retry_backoff_s``; ``nan_policy`` 'off' | 'warn'
    | 'skip' | 'rollback' with ``spike_factor`` and ``nan_rollback_after``
    (rollback restores the latest checkpoint once per run, then degrades
    to skip); ``nan_inject`` ('kind:step[@attempt],...'); the
    ``expansion_guard`` with ``guard_window``, ``guard_tol``,
    ``guard_defer`` and ``guard_max_retries`` (retry with
    ``copying_zeroL``, then defer τ, then give up); ``hang_deadline_s``."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainConfig,
                 checkpoint_dir: Optional[str] = None,
                 data: Optional[SyntheticLM] = None, eval_batches=None,
                 dtype=torch.float32, log_fn: Callable = print,
                 device="cuda", mesh=None, async_ckpt: bool = True,
                 faults=None, nan_policy: str = "off",
                 spike_factor: float = 10.0, nan_inject=None,
                 expansion_guard: bool = False, guard_window: int = 20,
                 guard_tol: float = 1.5, guard_defer: Optional[int] = None,
                 guard_max_retries: int = 2, nan_rollback_after: int = 3,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 hang_deadline_s: Optional[float] = None, fsdp: bool = True,
                 layout: str = "tp", moe_fsdp: str = "auto"):
        if tcfg.global_batch % max(tcfg.grad_accum, 1):
            raise ValueError(f"global_batch {tcfg.global_batch} not divisible "
                             f"by grad_accum {tcfg.grad_accum}")
        if nan_policy not in ("off", "warn", "skip", "rollback"):
            raise ValueError(f"unknown nan_policy {nan_policy!r}")
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.checkpoint_dir = checkpoint_dir
        self.dtype = dtype
        if isinstance(mesh, str):
            from repro_torch.launch import mesh as mesh_lib
            mesh = mesh_lib.make_train_mesh(mesh, device=str(device))
        self.mesh = mesh
        self.fsdp, self.layout, self.moe_fsdp = fsdp, layout, moe_fsdp
        if mesh is not None and mesh.rank != 0:
            log_fn = lambda *a, **k: None          # noqa: E731 (rank 0 logs)
        self.log_fn = log_fn
        self.device = resolve_device(device if mesh is None else mesh.device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._ckptr = ckpt.AsyncCheckpointer() if async_ckpt else None

        self.faults = faults_lib.resolve(faults)
        # ckpt.write fires in rank 0's writer alone: it keeps the raw plane.
        self._write_plane = self.faults
        self.faults = coll.agreed_plane(self.faults, mesh)
        self.nan_policy = nan_policy
        self.spike_factor = spike_factor
        self.nan_inject = faults_lib.parse_nan_inject(nan_inject)
        self.expansion_guard = expansion_guard
        self.guard_window = guard_window
        self.guard_tol = guard_tol
        self.guard_defer = guard_defer if guard_defer is not None \
            else guard_window
        self.guard_max_retries = guard_max_retries
        self.nan_rollback_after = nan_rollback_after
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.hang_deadline_s = hang_deadline_s
        # Sentinel metrics ride the step only when something consumes them.
        self._sentinels = (nan_policy != "off" or bool(self.nan_inject)
                           or expansion_guard)
        self._guard_attempt = 0       # scopes @attempt nan-injections
        self.retries = 0
        self.ckpt_failures = 0
        self.nan_rollbacks = 0

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

    # -- sharding ------------------------------------------------------------

    def _specs(self, cfg: ModelConfig):
        """{path: spec} of the params at ``cfg``'s depth (None off a mesh)."""
        if self.mesh is None:
            return None
        like = registry.get_model(cfg).init(None, cfg, dtype=self.dtype,
                                            device="meta")
        return dict(leaves_with_path(shd.params_shardings(
            like, self.mesh, fsdp=self.fsdp, moe_fsdp=self.moe_fsdp,
            layout=self.layout)))

    def _ctx(self, cfg: ModelConfig) -> Optional[MeshContext]:
        if self.mesh is None:
            return None
        return MeshContext(self.mesh, self.layout, self._specs(cfg))

    def _state_shardings(self, cfg: ModelConfig, opt_state):
        """Spec tree of {"params", "opt_state"} (moments mirror the params;
        'step' and other scalars are replicated)."""
        like = registry.get_model(cfg).init(None, cfg, dtype=self.dtype,
                                            device="meta")
        p = shd.params_shardings(like, self.mesh, fsdp=self.fsdp,
                                 moe_fsdp=self.moe_fsdp, layout=self.layout)
        os_ = {k: (p if k in ("m", "v") else shd.replicated())
               for k in opt_state}
        return {"params": p, "opt_state": os_}

    def _shard(self, cfg: ModelConfig, params):
        """This rank's shards of whole params, each a new tensor on the
        rank's device."""
        specs = self._specs(cfg)
        return tree_map_with_path(
            lambda path, x: coll.shard_leaf(x, specs[path], self.mesh,
                                            path).to(self.device, copy=True),
            params)

    def _rows(self, x):
        """This rank's rows of a global batch leaf (``batch_axes``)."""
        axes = shd.batch_axes(x.shape[0], self.mesh, self.layout)
        n = self.mesh.axes_size(axes)
        if n == 1:
            return x
        size = x.shape[0] // n
        i = self.mesh.axes_index(axes)
        return x[i * size:(i + 1) * size]

    def _build_steps(self, cfg: ModelConfig):
        ctx = self._ctx(cfg)
        train_step = steps_lib.make_train_step(
            cfg, self.opt, self.schedule, remat=self.tcfg.remat,
            grad_accum=self.tcfg.grad_accum, sentinels=self._sentinels,
            nan_policy=self.nan_policy if self.nan_policy != "off" else "warn",
            spike_factor=self.spike_factor,
            inject=faults_lib.active_inject(self.nan_inject,
                                           self._guard_attempt), mesh=ctx)
        return train_step, steps_lib.make_eval_step(cfg, mesh=ctx)

    def _retry(self, site: str, fn):
        """Run ``fn`` containing transient ``FaultError``s with bounded
        exponential backoff.  ``CrashError`` is never caught (it models
        process death); exhaustion re-raises the last fault."""
        attempt = 0
        while True:
            try:
                return fn()
            except faults_lib.CrashError:
                raise
            except faults_lib.FaultError as e:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                self.retries += 1
                self.log_fn(f"[fault] {site}: {e} — retry "
                            f"{attempt}/{self.max_retries}")
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _restore_state(self, step: int):
        """Load checkpoint label ``step``: (metadata, layers, cfg, params,
        opt_state), the leaves on this run's device.  A ``ckpt.restore``
        fault is retried."""
        meta = ckpt.load_metadata(self.checkpoint_dir, step)
        layers = int(meta["num_layers"])
        cfg = self.model_cfg.with_depth(layers)
        like_p = registry.get_model(cfg).init(None, cfg, dtype=self.dtype,
                                              device="meta")
        like = {"params": like_p, "opt_state": self.opt.init(like_p)}
        kw = {} if self.mesh is None else dict(
            mesh=self.mesh,
            shardings=self._state_shardings(cfg, like["opt_state"]))
        tree = self._retry("ckpt.restore", lambda: ckpt.restore(
            self.checkpoint_dir, step, like, faults=self.faults, **kw))
        state = tree_map(lambda t: t.to(self.device),
                         bridge.params_from_jax(tree))
        return meta, layers, cfg, state["params"], state["opt_state"]

    def _init_state(self, cfg: ModelConfig):
        api = registry.get_model(cfg)
        gen = torch.Generator().manual_seed(self.tcfg.seed)
        if self.mesh is None:
            params = api.init(gen, cfg, dtype=self.dtype, device=self.device)
        else:
            # Drawn whole in host memory (the generator's draws are made on
            # the CPU on one device too), then each leaf's slice alone moves
            # to the device: no rank holds the whole model there.
            params = self._shard(cfg, api.init(gen, cfg, dtype=self.dtype,
                                               device="cpu"))
        return params, self.opt.init(params)

    def _place_batch(self, host_batch):
        """The batch on the device: this rank's rows on a mesh."""
        rows = (lambda a: a) if self.mesh is None else self._rows
        return {k: torch.from_numpy(np.ascontiguousarray(rows(np.asarray(v))))
                .to(self.device).long() for k, v in host_batch.items()}

    def _barrier(self):
        if self.mesh is not None:
            coll.agree_code(self.mesh, 0)

    def _settle(self):
        """On a mesh: rank 0's write in flight lands before any rank reads
        the checkpoint directory."""
        if self.mesh is None:
            return
        if self._ckptr is not None:
            try:
                self._ckptr.wait()
            except faults_lib.FaultError:
                self.ckpt_failures += 1
        self._barrier()

    def _sync(self):
        """Wait for the step's work on the compute stream, not the whole
        device: an asynchronous checkpoint copies to the host on a side
        stream, and that copy must not hold the step (or its measured
        time) back."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run(self) -> TrainResult:
        try:
            return self._run()
        except faults_lib.CrashError:
            # The process "dies" here: let the write in flight land first,
            # so what a restart finds does not race the unwinding crash.
            if self._ckptr is not None:
                try:
                    self._ckptr.wait()
                except BaseException:     # the crash wins over its error
                    pass
            raise

    def _run(self) -> TrainResult:
        tcfg, model_cfg = self.tcfg, self.model_cfg
        plane = self.faults
        exp_steps = {max(1, int(e.at_frac * tcfg.total_steps)): e
                     for e in sorted(tcfg.expansions, key=lambda e: e.at_frac)}
        history = {"step": [], "loss": [], "lr": [], "eval_step": [],
                   "eval_loss": [], "layers": [], "expansion_steps": [],
                   "step_time": [], "sentinel": [], "skipped_steps": [],
                   "expansion_guard": [], "hangs": []}
        step_times: List[Tuple[int, float]] = []
        # Host-side sentinel and guard state.  The EMAs ride the checkpoint
        # metadata, so a resumed run's spike and divergence tests see the
        # same baselines.
        gnorm_ema = 0.0
        loss_ema = None
        bad_streak = 0
        guard = {"boundary": -1, "until": -1, "baseline": None,
                 "attempt": 0, "retries": 0}
        guard_events: List[dict] = []

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
                guard_events = list(history["expansion_guard"])
                gnorm_ema = float(meta.get("gnorm_ema", 0.0))
                loss_ema = meta.get("loss_ema")
                g = meta.get("guard")
                if g:
                    guard.update(g)
                    self._guard_attempt = int(guard["attempt"])
                self.log_fn(f"[resume] step={start_step} layers={cur_layers}")
        if meta is None:
            cur_cfg = model_cfg.with_depth(cur_layers)
            params, opt_state = self._init_state(cur_cfg)
        train_step, eval_step = self._build_steps(cur_cfg)
        agree_dt = None
        if self.mesh is not None:
            def agree_dt(dt):
                return float(coll.all_reduce(
                    torch.tensor([dt], dtype=torch.float64),
                    self.mesh.group(self.mesh.axis_names), "max")[0])
        monitor = StragglerMonitor(hang_deadline_s=self.hang_deadline_s,
                                   agree=agree_dt)

        def save(done):
            """Checkpoint with label = completed steps.  A write that fails
            past its retries is contained and counted: training goes on
            from the device state."""
            if not self.checkpoint_dir:
                return
            # A deep copy now: an async write serializes it later.
            # step_time is left out: wall-clock noise must not make two
            # otherwise identical checkpoints differ.
            m = json.loads(json.dumps({
                "num_layers": cur_layers, "name": model_cfg.name,
                "data_step": done, "gnorm_ema": gnorm_ema,
                "loss_ema": loss_ema, "guard": dict(guard),
                "history": {k: v for k, v in history.items()
                            if k != "step_time"}}))
            saver = self._ckptr.save if self._ckptr else ckpt.save
            kw = {} if self.mesh is None else dict(
                mesh=self.mesh,
                shardings=self._state_shardings(cur_cfg, opt_state))

            def write_here():
                saver(self.checkpoint_dir, done,
                      {"params": params, "opt_state": opt_state},
                      metadata=m, keep=tcfg.keep_checkpoints,
                      faults=self._write_plane, **kw)

            def write():
                # On a mesh rank 0 writes and every rank takes its outcome.
                if self.mesh is None:
                    return write_here()
                coll.agreed(self.mesh, "ckpt.write", write_here)

            try:
                self._retry("ckpt.write", write)
            except faults_lib.FaultError as e:
                self.ckpt_failures += 1
                self.log_fn(f"[ckpt] save({done}) failed after retries: {e}")

        def reload(at, why):
            """Roll the state back to checkpoint label ``at`` (resume
            semantics: history and EMAs come back from its metadata; the
            guard's events recorded since are re-applied on top)."""
            nonlocal params, opt_state, cur_layers, cur_cfg
            nonlocal train_step, eval_step, gnorm_ema, loss_ema
            if self._ckptr is not None:
                try:
                    self._ckptr.wait()      # do not race a write in flight
                except faults_lib.FaultError:
                    self.ckpt_failures += 1
            self._barrier()                 # rank 0's write has landed
            (m, cur_layers, cur_cfg, params,
             opt_state) = self._restore_state(at)
            for k, v in m.get("history", {}).items():
                history[k] = list(v)
            history["expansion_guard"] = list(guard_events)
            gnorm_ema = float(m.get("gnorm_ema", 0.0))
            loss_ema = m.get("loss_ema")
            train_step, eval_step = self._build_steps(cur_cfg)
            self.log_fn(f"[rollback] {why}: restored checkpoint {at} "
                        f"({cur_layers} layers)")

        step = start_step
        while step < tcfg.total_steps:
            plane.fire("train.iter")        # scheduled-crash point

            # ---- depth expansion at τ (paper's technique) ----------------
            if step in exp_steps and cur_layers < exp_steps[step].target_layers:
                e = exp_steps[step]
                save(step)                   # expansion boundary checkpoint

                def expand():
                    plane.fire("train.expand")
                    expand_fn = exp.make_expand_fn(
                        cur_cfg, e.target_layers, e.init,
                        insert_at=e.insert_at,
                        opt_state_policy=e.opt_state_policy, dtype=self.dtype,
                        mesh=self.mesh, fsdp=self.fsdp, layout=self.layout,
                        moe_fsdp=self.moe_fsdp)
                    return expand_fn(params, opt_state, torch.Generator()
                                     .manual_seed(tcfg.seed + 17 + step))

                params, opt_state = self._retry("train.expand", expand)
                cur_layers = e.target_layers
                cur_cfg = model_cfg.with_depth(cur_layers)
                train_step, eval_step = self._build_steps(cur_cfg)
                history["expansion_steps"].append(step)
                self.log_fn(f"[expand] step={step} -> {cur_layers} layers "
                            f"({e.init}, OS={e.opt_state_policy})")
                if self.expansion_guard:
                    guard.update(boundary=step,
                                 until=step + self.guard_window,
                                 baseline=loss_ema)

            def fetch_batch():
                plane.fire("train.batch")
                return self._place_batch(self.data.batch(step))

            batch = self._retry("train.batch", fetch_batch)
            monitor.start()

            def dispatch():
                plane.fire("train.step")
                if self._sentinels:
                    return train_step(params, opt_state, batch, step,
                                      gnorm_ema)
                return train_step(params, opt_state, batch, step)

            params, opt_state, metrics = self._retry("train.step", dispatch)
            self._sync()
            try:
                dt, slow = monitor.stop()
            except faults_lib.FaultError as e:
                # The hung step HAS run (params updated): record, move on.
                history["hangs"].append(step)
                dt, slow = monitor.last_dt, True
                self.log_fn(f"[hang] step {step}: {e}")
            step_times.append((cur_layers, dt))

            # ---- numerical sentinels (device-computed, host-policied) ----
            if self._sentinels:
                loss_v = float(metrics["loss"])
                gnorm_ema = float(metrics["gnorm_ema"])
                if not float(metrics["bad"]):
                    bad_streak = 0
                    loss_ema = loss_v if loss_ema is None \
                        else 0.8 * loss_ema + 0.2 * loss_v
                else:
                    bad_streak += 1
                    policy = self.nan_policy if self.nan_policy != "off" \
                        else "warn"
                    gn = float(metrics["grad_norm"])
                    history["sentinel"].append(
                        {"step": step, "policy": policy, "loss": loss_v,
                         "grad_norm": gn})
                    if policy in ("skip", "rollback"):
                        history["skipped_steps"].append(step)
                    self.log_fn(f"[sentinel] step {step} bad (loss "
                                f"{loss_v:.4g}, |g| {gn:.4g}) -> {policy}")
                    if (policy == "rollback" and self.checkpoint_dir
                            and bad_streak >= self.nan_rollback_after
                            and self.nan_rollbacks < 1):
                        self._settle()
                        at = ckpt.latest_step(self.checkpoint_dir)
                        if at is not None and at <= step:
                            # Once per run: injections are deterministic and
                            # a replay meets them again, so after one
                            # rollback the policy degrades to skip.
                            self.nan_rollbacks += 1
                            reload(at, f"{bad_streak} consecutive bad steps")
                            bad_streak = 0
                            step = at
                            continue

            # ---- expansion guard: post-τ divergence watchdog -------------
            if self.expansion_guard and guard["boundary"] >= 0:
                base = guard["baseline"]
                diverged = (not math.isfinite(loss_v)) or (
                    base is not None and loss_ema is not None
                    and loss_ema > self.guard_tol * max(base, 1e-8))
                if step < guard["until"] and diverged \
                        and self.checkpoint_dir:
                    btau = guard["boundary"]
                    guard["retries"] += 1
                    if guard["retries"] > self.guard_max_retries:
                        guard_events.append({"step": step, "boundary": btau,
                                             "attempt": guard["attempt"],
                                             "action": "give_up"})
                        history["expansion_guard"] = list(guard_events)
                        guard.update(boundary=-1, until=-1)
                        self.log_fn(f"[guard] give up after "
                                    f"{self.guard_max_retries} retries")
                    else:
                        e0 = exp_steps[btau]
                        if e0.init != "copying_zeroL":
                            # A function-preserving retry first.
                            exp_steps[btau] = dataclasses.replace(
                                e0, init="copying_zeroL")
                            action = "retry_zeroL"
                        else:
                            ntau = min(btau + self.guard_defer,
                                       tcfg.total_steps - 1)
                            exp_steps[ntau] = e0
                            del exp_steps[btau]
                            action = f"defer_to_{ntau}"
                        guard["attempt"] += 1
                        self._guard_attempt = guard["attempt"]
                        guard_events.append({
                            "step": step, "boundary": btau,
                            "attempt": guard["attempt"], "action": action,
                            "loss_ema": loss_ema, "baseline": base})
                        reload(btau, "post-expansion divergence "
                                     f"(loss {loss_v:.4g}, loss_ema "
                                     f"{loss_ema} vs baseline {base})")
                        history["expansion_guard"] = list(guard_events)
                        guard.update(boundary=-1, until=-1, baseline=None)
                        self.log_fn(f"[guard] {action} at boundary {btau}")
                        bad_streak = 0
                        step = btau
                        continue
                elif step + 1 >= guard["until"]:
                    guard_events.append({"step": step,
                                         "boundary": guard["boundary"],
                                         "attempt": guard["attempt"],
                                         "action": "pass"})
                    history["expansion_guard"] = list(guard_events)
                    guard.update(boundary=-1, until=-1, baseline=None)
                    self.log_fn(f"[guard] probation passed at step {step}")

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
                                f"lr {float(metrics['lr']):.2e}"
                                + ("  [straggler]" if slow else ""))

            if step and step % tcfg.eval_every == 0:
                def evaluate():
                    plane.fire("train.eval")
                    return float(np.mean(
                        [float(eval_step(params, self._place_batch(b)))
                         for b in self.eval_batches]))

                history["eval_step"].append(step)
                history["eval_loss"].append(self._retry("train.eval",
                                                        evaluate))

            done = step + 1
            if (self.checkpoint_dir and done % tcfg.checkpoint_every == 0
                    and done < tcfg.total_steps):
                save(done)
            step += 1

        save(tcfg.total_steps)
        if self._ckptr is not None:     # drain (and surface) the last write
            try:
                self._ckptr.wait()
            except faults_lib.FaultError as e:
                self.ckpt_failures += 1
                self.log_fn(f"[ckpt] final save failed: {e}")
        self._barrier()                 # rank 0's last write has landed
        stats = {"retries": self.retries,
                 "ckpt_failures": self.ckpt_failures,
                 "nan_rollbacks": self.nan_rollbacks,
                 "skipped_steps": len(history["skipped_steps"]),
                 "hangs": len(history["hangs"]),
                 "guard_events": len(history["expansion_guard"]),
                 "fault_counts": dict(getattr(plane, "counts", {}) or {}),
                 "fired": list(getattr(plane, "fired", []))}
        return TrainResult(history=history, params=params,
                           opt_state=opt_state, final_layers=cur_layers,
                           step_times=step_times, fault_stats=stats)

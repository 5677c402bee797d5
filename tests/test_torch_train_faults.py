"""Fault injection and recovery in the port's trainer (``train/engine.py``'s
fault plane, ``train/steps.py``'s sentinels, ``checkpoint/checkpointer.py``'s
``AsyncCheckpointer`` and ``distributed/collectives.py``'s
``StragglerMonitor``), on the CPU.

In-port, every contract of ``tests/test_train_faults.py`` at its ``tfault``
config (with Muon-NSGD, the optimizer the port trains with, where the
reference's tests use AdamW), exact: transient faults at every train site
and the checkpointer retried to byte parity; exhausted retries raise; a
fault storm reaches parity; crash-resume byte parity for every crash point
k in 4..8 around τ (deterministic here: a crash joins the checkpoint write
in flight), mid-expansion and mid-async-checkpoint; the restore fault
retried; label = steps completed; the NaN/spike sentinel ladder
(skip/warn/spike/rollback, clean runs silent); the expansion guard (retry
with copying_zeroL, defer τ, no false positive); the async torn write; the
hang deadline.

Cross-framework, against the JAX package: ``parse_nan_inject`` and
``active_inject`` give the same outputs, and one sentinel step of
``repro.train.steps.make_train_step(sentinels=True)`` with Muon-NSGD on
bridged params gives the same ``bad`` and, within 1e-5 relative, the same
``loss``, ``grad_norm``, ``update_norm`` and ``gnorm_ema``, clean and with
``nan``/``spike`` injected (NaN where JAX has NaN).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import (ExpansionConfig, ModelConfig,
                                      OptimizerConfig, ScheduleConfig,
                                      TrainConfig)
from repro_torch.core.schedules import make_schedule
from repro_torch.distributed.collectives import StragglerMonitor
from repro_torch.optim.base import make_optimizer
from repro_torch.train import steps
from repro_torch.train.engine import ProgressiveTrainer
from repro_torch.train.faults import (ITER_SITES, SITES, CrashError,
                                      FaultError, FaultPlane, HangError,
                                      active_inject, parse_nan_inject)
from repro_torch.tree import tree_leaves

_CFG_KW = dict(name="tfault", family="dense", num_layers=2, d_model=32,
               num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
               max_seq_len=16)
CFG = ModelConfig(**_CFG_KW)

TAU = 6          # expansion lands at 0.5 * 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these ops are tiny, and on a shared CPU many
    threads make them several times slower.  Every comparison here is
    between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(**kw):
    base = dict(total_steps=12, seq_len=16, global_batch=4, source_layers=1,
                expansions=(ExpansionConfig(at_frac=0.5, target_layers=2,
                                            init="copying_zeroL"),),
                optimizer=OptimizerConfig(name="muon_nsgd",
                                          learning_rate=1e-2),
                schedule=ScheduleConfig(name="constant"),
                eval_every=10_000, eval_batches=1, seed=0, log_every=1,
                checkpoint_every=3, keep_checkpoints=100)
    base.update(kw)
    return TrainConfig(**base)


def run(tc=None, ckpt_dir=None, **kw):
    return ProgressiveTrainer(CFG, tc if tc is not None else tcfg(),
                              checkpoint_dir=ckpt_dir, device="cpu",
                              log_fn=lambda *a: None, **kw)


def leaves_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(x.numpy(), y.numpy(), equal_nan=True)
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# FaultPlane units (the train sites), and the injection grammar vs JAX
# ---------------------------------------------------------------------------


def test_train_sites_registered():
    for s in ("train.batch", "train.step", "train.eval", "train.expand",
              "train.iter", "ckpt.restore"):
        assert s in SITES
    assert ITER_SITES == {"sched.iter", "train.iter"}


def test_parse_train_crash_spec():
    plane = FaultPlane.parse("train.iter:3:crash,train.step:1")
    with pytest.raises(FaultError):
        plane.fire("train.step")
    plane.fire("train.iter")
    plane.fire("train.iter")
    with pytest.raises(CrashError):
        plane.fire("train.iter")


def test_storm_never_hits_iteration_sites():
    plane = FaultPlane.seeded(1.0, seed=0)
    for _ in range(50):
        plane.fire("train.iter")        # rate 1.0 would fault every hit
        plane.fire("sched.iter")
    assert plane.counts["train.iter"] == 50 and not plane.fired


def test_parse_nan_inject_grammar():
    assert parse_nan_inject(None) == ()
    assert parse_nan_inject("nan:5") == (("nan", 5, None),)
    assert parse_nan_inject("spike:7@0,nan:9@2") == \
        (("spike", 7, 0), ("nan", 9, 2))
    assert active_inject("spike:7@0,nan:9@2,nan:3", 0) == \
        {7: "spike", 3: "nan"}
    assert active_inject("spike:7@0,nan:9@2,nan:3", 2) == \
        {9: "nan", 3: "nan"}
    with pytest.raises(ValueError):
        parse_nan_inject("explode:5")
    with pytest.raises(ValueError):
        parse_nan_inject("nan")


@pytest.mark.parametrize("spec", [None, "", "nan:5", "spike:7@0,nan:9@2",
                                  " nan:3 , spike:4@1,", "explode:5", "nan",
                                  (("spike", 2, None), ("nan", 8, 1))])
def test_nan_inject_matches_jax(spec):
    from repro.train import faults as jax_faults

    def outcome(mod):
        try:
            return (mod.parse_nan_inject(spec),
                    [mod.active_inject(spec, a) for a in (0, 1, 2)])
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(jax_faults) == outcome(
        __import__("repro_torch.train.faults", fromlist=["x"]))


# ---------------------------------------------------------------------------
# One sentinel step against the JAX package's
# ---------------------------------------------------------------------------


INJECT = {2: "nan", 3: "spike"}


@pytest.fixture(scope="module")
def sentinel_pair():
    """(JAX step, JAX params, port params, JAX opt, port opt, port
    schedule): one JAX sentinel step under 'skip' with ``INJECT`` baked
    in, built once for the three cases."""
    import jax
    from repro.configs import base as jbase
    from repro.core.schedules import make_schedule as jmake_schedule
    from repro.models import transformer as jtr
    from repro.optim.base import make_optimizer as jmake_optimizer
    from repro.train import steps as jsteps
    jcfg = jbase.ModelConfig(**_CFG_KW)
    jp = jtr.lm_init(jax.random.PRNGKey(2), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp))
    jopt = jmake_optimizer(jbase.OptimizerConfig(name="muon_nsgd"))
    jstep = jsteps.make_train_step(
        jcfg, jopt, jmake_schedule(jbase.ScheduleConfig(), 0.01, 10),
        donate=False, sentinels=True, nan_policy="skip", inject=INJECT)
    return (jstep, jp, tp, jopt, make_optimizer(OptimizerConfig(
        name="muon_nsgd")), make_schedule(ScheduleConfig(), 0.01, 10))


@pytest.mark.parametrize("inject", [None, "nan", "spike"])
def test_sentinel_step_matches_jax(sentinel_pair, inject):
    """Sentinel steps under 'skip' from the same params and batches: two
    clean ones (the second with the EMA the first returned, so the spike
    test is live), then the ``nan`` step, then the ``spike`` step.  Same
    ``bad``; loss, grad_norm, update_norm, gnorm_ema within 1e-5
    relative (NaN where JAX has NaN); a bad step leaves the port's params
    and momenta exactly as they were."""
    import jax
    import jax.numpy as jnp
    jstep, jp, tp, jopt, opt, sched = sentinel_pair
    tp = {k: v for k, v in bridge.flatten(tp).items()}
    tp = bridge.unflatten({k: v.clone() for k, v in tp.items()})
    step = steps.make_train_step(CFG, opt, sched, sentinels=True,
                                 nan_policy="skip", inject=INJECT)
    jstate, state = jopt.init(jp), opt.init(tp)
    rng = np.random.default_rng(5)
    jema, ema = 0.0, 0.0
    n = {None: 2, "nan": 3, "spike": 4}[inject]
    for i in range(n):
        b = {k: rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
        before = [t.clone() for t in tree_leaves({"p": tp, "s": state})]
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(jnp.asarray, b),
                               jnp.asarray(i), jnp.float32(jema))
        tp, state, m = step(tp, state, {k: torch.from_numpy(v).long()
                                        for k, v in b.items()}, i, ema)
        jm = {k: float(v) for k, v in jax.device_get(jm).items()}
        assert float(m["bad"]) == jm["bad"] == float(i in INJECT)
        for key in ("loss", "grad_norm", "update_norm", "gnorm_ema"):
            got, want = float(m[key]), jm[key]
            if math.isnan(want):
                assert math.isnan(got), key
            else:
                assert abs(got - want) <= 1e-5 * abs(want), \
                    f"step {i} {key}: {got} vs {want}"
        jema, ema = jm["gnorm_ema"], float(m["gnorm_ema"])
        if float(m["bad"]):
            after = tree_leaves({"p": tp, "s": state})
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(state["step"]) == int(jstate["step"]) == 2


# ---------------------------------------------------------------------------
# Transient-fault containment: retried faults are byte-exact no-ops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clean_result():
    return run().run()


@pytest.mark.parametrize("site", ["train.batch", "train.step", "train.eval",
                                  "train.expand"])
def test_transient_fault_retried_to_byte_parity(site, clean_result):
    tc = tcfg(eval_every=4) if site == "train.eval" else tcfg()
    base = run(tc).run() if site == "train.eval" else clean_result
    plane = FaultPlane.parse(f"{site}:1,{site}:2")
    res = run(tc, faults=plane, max_retries=3, retry_backoff_s=1e-4).run()
    assert plane.counts[site] >= 3, "site never exercised (vacuous test)"
    assert len(plane.fired) == 2
    assert res.fault_stats["retries"] >= 2
    assert res.history["loss"] == base.history["loss"]
    assert leaves_equal(res.params, base.params)


def test_ckpt_write_fault_is_contained(tmp_path, clean_result):
    """A checkpoint write that fails past its retries does not kill the
    run, nor touch the training state."""
    res = run(ckpt_dir=str(tmp_path), async_ckpt=False,
              faults="ckpt.write:1,ckpt.write:2,ckpt.write:3",
              max_retries=1, retry_backoff_s=1e-4).run()
    assert res.fault_stats["ckpt_failures"] >= 1
    assert leaves_equal(res.params, clean_result.params)
    assert ckpt.latest_step(str(tmp_path)) == 12   # later saves landed


def test_retry_exhaustion_raises():
    spec = ",".join(f"train.step:{i}" for i in range(1, 6))
    with pytest.raises(FaultError):
        run(faults=spec, max_retries=0).run()


def test_fault_storm_with_retries_reaches_byte_parity(clean_result):
    plane = FaultPlane.seeded(0.05, seed=7)
    res = run(faults=plane, max_retries=5, retry_backoff_s=1e-4).run()
    assert plane.fired, "storm never fired (vacuous test)"
    assert res.history["loss"] == clean_result.history["loss"]
    assert leaves_equal(res.params, clean_result.params)


# ---------------------------------------------------------------------------
# Byte-identical preempt-resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [4, 5, 6, 7, 8])
def test_crash_resume_byte_parity_expansion_window(tmp_path, clean_result, k):
    """Crash the k-th loop iteration (k straddles τ=6 and the periodic
    checkpoints at 3/6/9, written asynchronously) and resume: final params
    AND the loss curve are byte-identical to the uninterrupted run.  The
    crash joins the write in flight, so a checkpoint is on disk whenever
    one was started: the documented contract holds every time."""
    d = str(tmp_path)
    with pytest.raises(CrashError):
        run(ckpt_dir=d, faults=f"train.iter:{k + 1}:crash").run()
    assert ckpt.latest_step(d) is not None and ckpt.latest_step(d) <= k
    assert ckpt.latest_step(d) == (3 if k < TAU else 6)
    res = run(ckpt_dir=d).run()
    assert res.final_layers == 2
    assert res.history["step"] == clean_result.history["step"]
    assert res.history["loss"] == clean_result.history["loss"]
    assert res.history["expansion_steps"] == [TAU]
    assert leaves_equal(res.params, clean_result.params)
    assert leaves_equal(res.opt_state, clean_result.opt_state)


def test_crash_mid_expansion_resumes_to_parity(tmp_path, clean_result):
    """train.expand fires after the boundary checkpoint and before params
    change: the crash window inside the expansion itself."""
    d = str(tmp_path)
    with pytest.raises(CrashError):
        run(ckpt_dir=d, faults="train.expand:1:crash",
            async_ckpt=False).run()
    assert ckpt.latest_step(d) == TAU          # boundary ckpt completed
    assert ckpt.load_metadata(d, TAU)["num_layers"] == 1
    res = run(ckpt_dir=d).run()
    assert res.history["loss"] == clean_result.history["loss"]
    assert leaves_equal(res.params, clean_result.params)


def test_crash_mid_async_checkpoint_resumes_to_parity(tmp_path, clean_result):
    """A crash inside the async writer (between arrays and manifest)
    surfaces on the next wait and unwinds the run; the torn directory is
    invisible to resume."""
    d = str(tmp_path)
    with pytest.raises(CrashError):
        run(ckpt_dir=d, faults="ckpt.write:2:crash").run()
    assert ckpt.latest_step(d) == 3
    assert os.path.isdir(os.path.join(d, "step_000000006.tmp"))
    res = run(ckpt_dir=d).run()
    assert res.history["loss"] == clean_result.history["loss"]
    assert leaves_equal(res.params, clean_result.params)


def test_ckpt_restore_fault_retried_on_resume(tmp_path, clean_result):
    d = str(tmp_path)
    with pytest.raises(CrashError):
        run(ckpt_dir=d, faults="train.iter:8:crash").run()
    plane = FaultPlane.parse("ckpt.restore:1")
    res = run(ckpt_dir=d, faults=plane, retry_backoff_s=1e-4).run()
    assert plane.counts["ckpt.restore"] >= 2      # fault + successful retry
    assert res.history["loss"] == clean_result.history["loss"]
    assert leaves_equal(res.params, clean_result.params)


def test_checkpoint_label_means_steps_completed(tmp_path):
    """The checkpoint labelled k holds exactly the state of a run trained
    for k steps."""
    tc = tcfg(source_layers=2, expansions=(), checkpoint_every=5,
              total_steps=10)
    d = str(tmp_path)
    run(tc, ckpt_dir=d, async_ckpt=False).run()
    assert ckpt.all_steps(d) == [5, 10]
    short = run(tcfg(source_layers=2, expansions=(), total_steps=5)).run()
    a5 = dict(np.load(os.path.join(d, "step_000000005", "arrays.npz")))
    flat = [t.numpy() for t in tree_leaves(
        {"params": short.params, "opt_state": short.opt_state})]
    assert len(flat) == len(a5)
    assert all(np.array_equal(a5[f"leaf_{i}"], x)
               for i, x in enumerate(flat))


def test_checkpoint_metadata_carries_sentinel_and_guard_state(tmp_path):
    """The metadata holds the run's real EMAs and guard state (the resume
    baselines), no longer idle values."""
    d = str(tmp_path)
    run(_guard_tcfg("copying_zeroL", checkpoint_every=10), ckpt_dir=d,
        expansion_guard=True, guard_window=5, async_ckpt=False).run()
    mid, end = ckpt.load_metadata(d, 10), ckpt.load_metadata(d, 16)
    assert mid["guard"]["boundary"] == 8 and mid["guard"]["until"] == 13
    assert mid["history"]["expansion_guard"] == []   # still on probation
    for meta in (mid, end):
        assert meta["gnorm_ema"] > 0.0 and meta["loss_ema"] > 0.0
        json.dumps(meta)
    assert end["guard"]["boundary"] == -1 and end["guard"]["attempt"] == 0
    assert [e["action"] for e in end["history"]["expansion_guard"]] == \
        ["pass"]


# ---------------------------------------------------------------------------
# Numerical sentinels (NaN / spike policy ladder)
# ---------------------------------------------------------------------------


def _sentinel_tcfg(**kw):
    base = dict(source_layers=2, expansions=(), total_steps=10,
                checkpoint_every=1)
    base.update(kw)
    return tcfg(**base)


def test_nan_skip_discards_exactly_that_update(tmp_path):
    """checkpoint_every=1 makes adjacent checkpoints the proof: the
    skipped step's before and after states are bitwise equal (params AND
    momenta: the update never happened), and healthy steps still move."""
    d = str(tmp_path)
    res = run(_sentinel_tcfg(), ckpt_dir=d, async_ckpt=False,
              nan_policy="skip", nan_inject="nan:5").run()
    assert res.history["skipped_steps"] == [5]
    assert math.isnan(res.history["loss"][5])
    assert all(math.isfinite(l) for i, l in enumerate(res.history["loss"])
               if i != 5)
    a5 = dict(np.load(os.path.join(d, "step_000000005", "arrays.npz")))
    a6 = dict(np.load(os.path.join(d, "step_000000006", "arrays.npz")))
    a7 = dict(np.load(os.path.join(d, "step_000000007", "arrays.npz")))
    assert all(np.array_equal(a5[k], a6[k], equal_nan=True) for k in a5)
    assert not all(np.array_equal(a6[k], a7[k], equal_nan=True) for k in a6)


def test_nan_warn_poisons_the_run():
    res = run(_sentinel_tcfg(checkpoint_every=100), nan_policy="warn",
              nan_inject="nan:5").run()
    assert [e["step"] for e in res.history["sentinel"]] and \
        res.history["sentinel"][0]["step"] == 5
    assert res.history["skipped_steps"] == []
    assert not math.isfinite(res.history["loss"][-1])


def test_spike_sentinel_detects_exploding_grads():
    res = run(_sentinel_tcfg(checkpoint_every=100), nan_policy="skip",
              nan_inject="spike:6", spike_factor=10.0).run()
    assert res.history["skipped_steps"] == [6]
    assert all(math.isfinite(l) for l in res.history["loss"])


def test_nan_rollback_restores_then_degrades_to_skip(tmp_path):
    """'rollback' restores the latest checkpoint after the streak; the
    injection refires on replay, so it then degrades to skip, ending
    byte-identical to the pure-skip run."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    skip = run(_sentinel_tcfg(), ckpt_dir=d1, async_ckpt=False,
               nan_policy="skip", nan_inject="nan:5").run()
    rb = run(_sentinel_tcfg(), ckpt_dir=d2, async_ckpt=False,
             nan_policy="rollback", nan_inject="nan:5",
             nan_rollback_after=1).run()
    assert rb.fault_stats["nan_rollbacks"] == 1
    assert np.array_equal(rb.history["loss"], skip.history["loss"],
                          equal_nan=True)
    assert leaves_equal(rb.params, skip.params)


def test_clean_run_sentinels_silent(clean_result):
    """Sentinels on a healthy run: no events, and the same losses and
    params as the plain step (the sentinel step adds metrics, not math)."""
    res = run(nan_policy="skip").run()
    assert res.history["sentinel"] == [] and \
        res.history["skipped_steps"] == []
    np.testing.assert_allclose(res.history["loss"],
                               clean_result.history["loss"], rtol=1e-6)
    assert leaves_equal(res.params, clean_result.params)


# ---------------------------------------------------------------------------
# Expansion guard (post-τ divergence watchdog)
# ---------------------------------------------------------------------------


def _guard_tcfg(init, **kw):
    base = dict(total_steps=16, checkpoint_every=100,
                expansions=(ExpansionConfig(at_frac=0.5, target_layers=2,
                                            init=init),))
    base.update(kw)
    return tcfg(**base)          # τ = 8


def test_expansion_guard_rolls_back_once_and_retries_zeroL(tmp_path):
    """An injected post-expansion divergence (attempt 0 only) rolls back
    once to the boundary checkpoint; the retry takes the
    function-preserving init and the run completes."""
    res = run(_guard_tcfg("random"), ckpt_dir=str(tmp_path),
              nan_policy="warn", nan_inject="spike:9@0,nan:10@0",
              expansion_guard=True, guard_window=6).run()
    acts = [e["action"] for e in res.history["expansion_guard"]]
    assert acts == ["retry_zeroL", "pass"]
    assert res.final_layers == 2
    assert res.history["expansion_steps"] == [8]
    assert math.isfinite(res.history["loss"][-1])


def test_expansion_guard_defers_tau_when_init_already_preserving(tmp_path):
    res = run(_guard_tcfg("copying_zeroL"), ckpt_dir=str(tmp_path),
              nan_policy="warn", nan_inject="nan:9@0",
              expansion_guard=True, guard_window=4, guard_defer=3).run()
    acts = [e["action"] for e in res.history["expansion_guard"]]
    assert acts == ["defer_to_11", "pass"]
    assert res.history["expansion_steps"] == [11]
    assert res.final_layers == 2
    assert math.isfinite(res.history["loss"][-1])


def test_expansion_guard_clean_run_no_false_positive(tmp_path):
    res = run(_guard_tcfg("copying_zeroL"), ckpt_dir=str(tmp_path),
              expansion_guard=True, guard_window=5).run()
    acts = [e["action"] for e in res.history["expansion_guard"]]
    assert acts == ["pass"]
    assert res.history["expansion_steps"] == [8]


# ---------------------------------------------------------------------------
# Async checkpointer under crash (torn write, async path)
# ---------------------------------------------------------------------------


def test_async_crash_before_manifest_keeps_previous_latest(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    ckpt.save(d, 1, tree)
    ac = ckpt.AsyncCheckpointer()
    ac.save(d, 2, tree, faults=FaultPlane.parse("ckpt.write:1:crash"))
    with pytest.raises(CrashError):
        ac.wait()
    assert ckpt.latest_step(d) == 1                    # torn dir invisible
    assert os.path.isdir(os.path.join(d, "step_000000002.tmp"))
    restored = ckpt.restore(d, 1, {"w": tree["w"]})
    assert np.array_equal(restored["w"], tree["w"].numpy())
    ac.save(d, 2, tree)                                # clean write sweeps
    ac.wait()
    assert ckpt.latest_step(d) == 2
    assert not os.path.exists(os.path.join(d, "step_000000002.tmp"))


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The write holds the values of the moment ``save`` was called: an
    in-place update right after it (as the next train step makes) does
    not reach the file."""
    d = str(tmp_path)
    w = torch.arange(6, dtype=torch.float32)
    ac = ckpt.AsyncCheckpointer()
    ac.save(d, 1, {"w": w})
    w.mul_(-1.0)
    ac.wait()
    np.testing.assert_array_equal(ckpt.restore(d, 1, {"w": w})["w"],
                                  np.arange(6, dtype=np.float32))


# ---------------------------------------------------------------------------
# StragglerMonitor hang deadline
# ---------------------------------------------------------------------------


def test_straggler_monitor_hang_deadline_unit():
    mon = StragglerMonitor(hang_deadline_s=0.0)
    mon.start()
    with pytest.raises(HangError) as ei:
        mon.stop()
    assert isinstance(ei.value, FaultError)       # contained as train.step
    assert not isinstance(ei.value, CrashError)
    assert ei.value.site == "train.step"
    assert mon.hangs == 1 and mon.last_dt > 0.0


def test_engine_contains_hangs_and_completes(clean_result):
    """Deadline 0 flags every step as hung; the trainer records each hang
    and keeps going, WITHOUT retrying the step (it has run)."""
    res = run(hang_deadline_s=0.0).run()
    assert res.history["hangs"] == list(range(12))
    assert res.history["loss"] == clean_result.history["loss"]
    assert leaves_equal(res.params, clean_result.params)


# ---------------------------------------------------------------------------
# The CLI and the refusals that stay
# ---------------------------------------------------------------------------


def test_cli_crash_then_resume_prints_faults_line(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    argv = ["--smoke", "--device", "cpu", "--tau", "0", "--seq-len", "16",
            "--batch", "4", "--ckpt-dir", str(tmp_path)]
    launch_train.main(argv + ["--steps", "3"])
    with pytest.raises(CrashError):
        launch_train.main(argv + ["--steps", "5", "--faults",
                                  "train.iter:1:crash"])
    launch_train.main(argv + ["--steps", "5", "--nan-policy", "skip",
                              "--nan-inject", "nan:4",
                              "--hang-deadline-s", "1000"])
    out = capsys.readouterr().out
    assert out.count("[resume] step=3") == 2     # the crash run resumed too
    assert "faults: retries=0 ckpt_failures=0 skipped=1" in out
    # The mesh is ported (item 13): in one process a 4x2 spec is refused
    # against the world of 1, naming both.
    with pytest.raises(ValueError, match="has 8 ranks; the world has 1"):
        ProgressiveTrainer(CFG, tcfg(), device="cpu", mesh="4x2")

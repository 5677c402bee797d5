"""The port's expansion-timing recipe (``core/mixing``, ``core/theory``,
``core/scaling_laws``, ``data/corpus``, ``core/recipe``) against the JAX
package's, on the CPU.

The numpy functions get the same numpy inputs on both sides and must return
the same values: exactly where the reference returns ints or booleans,
within 1e-12 (relative) for floats.  ``BinCorpus`` batches are compared
byte for byte on a token file the test writes.  ``calibrate_tau`` runs once
with both packages' ``loop.train`` replaced by one that hands back the same
recorded histories (the same τ, probe steps, ``MixingReport`` and
production ``TrainConfig``), and once end to end on the port's trainer.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import mixing as jmixing
from repro.core import recipe as jrecipe
from repro.core import scaling_laws as jscaling
from repro.core import theory as jtheory
from repro.core.schedules import make_schedule as jax_make_schedule
from repro.data import corpus as jcorpus
from repro.train import loop as jloop
from repro_torch.configs import base as tbase
from repro_torch.core import mixing, recipe, scaling_laws, theory
from repro_torch.core.schedules import make_schedule
from repro_torch.data import corpus
from repro_torch.train import loop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the end-to-end probes are tiny, and on a shared
    CPU many threads make them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, what=""):
    """Equal ints, bools and Nones; floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif dataclasses.is_dataclass(want):
        _same(dataclasses.asdict(got), dataclasses.asdict(want), what)
    elif isinstance(want, (bool, int, type(None), np.bool_)) \
            and not isinstance(want, float):
        assert got == want and type(got) is type(want), what
    else:
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), what


def _curves(seed, n=60, exp=10, mix_at=25):
    """A fixed-size loss curve and a progressive one that spikes at
    ``exp`` and rejoins it from ``mix_at`` on (never, for mix_at=None)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    fixed = 3.0 + 2.0 * np.exp(-t / 15) + 0.01 * rng.standard_normal(n)
    prog = fixed + np.where(t < exp, 0.3, 0.0)
    gap = 0.8 * np.exp(-(t - exp) / 5.0) * (t >= exp)
    if mix_at is None:
        gap = np.where(t >= exp, 0.5, 0.0)
    prog = prog + gap
    return prog.tolist(), fixed.tolist()


@pytest.mark.parametrize("mix_at", [25, None])
@pytest.mark.parametrize("tol,patience", [(0.005, 5), (0.02, 3), (0.05, 2)])
def test_mixing_functions_match_jax(mix_at, tol, patience):
    prog, fixed = _curves(3, mix_at=mix_at)
    for exp in (0, 10, 40):
        args = (prog, fixed, exp, 4096)
        kw = dict(tolerance=tol, patience=patience)
        _same(mixing.detect_mixing(*args, **kw),
              jmixing.detect_mixing(*args, **kw), "detect_mixing")
    for name in ("wsd", "cosine", "constant"):
        js = jbase.ScheduleConfig(name=name, decay_frac=0.2)
        ts = tbase.ScheduleConfig(name=name, decay_frac=0.2)
        for total, mix in ((400, 0), (400, 37), (1000, 900), (50, 3)):
            _same(mixing.plan_expansion_step(ts, total, mix),
                  jmixing.plan_expansion_step(js, total, mix), "plan")
    for toks, per in ((0, 512), (1, 512), (4096, 4096), (123457, 8192)):
        _same(mixing.transfer_mix_steps(toks, per),
              jmixing.transfer_mix_steps(toks, per), "transfer")
    for args in ((150, 90, 1000, 50000, 512), (10, 0, 0, 7, 3),
                 (300, 299, 123456, 124439808, 16384)):
        _same(mixing.compute_savings(*args), jmixing.compute_savings(*args),
              "savings")


@pytest.mark.parametrize("name", ["wsd", "cosine", "constant"])
def test_theory_matches_jax(name):
    """``schedule_ratio`` and ``progressive_bound`` on one numpy schedule
    and on the port's ``make_schedule`` (a float32 tensor) for both; and,
    where the two packages' schedules return the same float32 learning
    rates (WSD and constant: the cosine's float32 cos differs by an ulp),
    each package's own."""
    T = 200
    lrs = np.linspace(0.1, 1.0, T) ** 2
    for tau in (0, 1, 50, 199, 200):
        _same(theory.schedule_ratio(lrs, tau),
              jtheory.schedule_ratio(lrs, tau), "ratio")
    cfg = dict(name=name, warmup_frac=0.05, decay_frac=0.2)
    own = (make_schedule(tbase.ScheduleConfig(**cfg), 0.02, T),
           jax_make_schedule(jbase.ScheduleConfig(**cfg), 0.02, T))
    if name != "cosine":
        np.testing.assert_array_equal(np.asarray(own[0](np.arange(T))),
                                      np.asarray(own[1](np.arange(T))))
    for tau in (10, 120):
        jinp = jtheory.BoundInputs(total_steps=T, tau=tau, dist_x_tau=0.7)
        inp = theory.BoundInputs(total_steps=T, tau=tau, dist_x_tau=0.7)
        _same(theory.progressive_bound(inp, lambda t: np.cos(t / T) + 1.5),
              jtheory.progressive_bound(jinp, lambda t: np.cos(t / T) + 1.5),
              "bound (numpy lr)")
        _same(theory.progressive_bound(inp, own[0]),
              jtheory.progressive_bound(jinp, own[0]), "bound (port's lr)")
        if name != "cosine":
            _same(theory.progressive_bound(inp, own[0]),
                  jtheory.progressive_bound(jinp, own[1]), "bound (own lr)")


def test_scaling_laws_match_jax():
    rng = np.random.default_rng(0)
    C = np.logspace(10, 14, 12)
    noisy = (80.0 * C ** (-0.12) + 2.1) * (1 + rng.normal(0, 0.005, C.shape))
    fit, jfit = (m.fit_power_law(C, noisy) for m in (scaling_laws, jscaling))
    _same(fit, jfit, "fit")
    np.testing.assert_allclose(fit.predict(C), jfit.predict(C), rtol=1e-12)
    assert abs(fit.b - 0.12) < 0.03
    for fb, pb in ((0.10, 0.13), (0.13, 0.10)):
        fixed = [(c, 80 * c ** -fb + 2.0) for c in C[:10]]
        prog = [(c, 60 * c ** -pb + 2.0) for c in C[:10]]
        _same(scaling_laws.compare_exponents(fixed, prog),
              jscaling.compare_exponents(fixed, prog), "compare")


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_bin_corpus_batches_match_jax_byte_for_byte(tmp_path, dtype):
    path = str(tmp_path / "toks.bin")
    toks = np.random.default_rng(1).integers(0, 70000, 20000)
    n = corpus.write_corpus(path, toks, dtype=dtype)
    assert n == jcorpus.write_corpus(str(tmp_path / "j.bin"), toks,
                                     dtype=dtype)
    assert open(path, "rb").read() == open(tmp_path / "j.bin", "rb").read()
    for vocab, seq, batch, seed in ((97, 16, 4, 1), (50304, 64, 8, 0)):
        ds = corpus.BinCorpus(path, vocab, seq, batch, seed=seed,
                              dtype=dtype)
        jds = jcorpus.BinCorpus(path, vocab, seq, batch, seed=seed,
                                dtype=dtype)
        for step, shard, shards in ((0, 0, 1), (3, 0, 2), (3, 1, 2),
                                    (17, 3, 4)):
            got = ds.batch(step, shard, shards)
            want = jds.batch(step, shard, shards)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                assert got[key].tobytes() == want[key].tobytes()
            np.testing.assert_array_equal(got["tokens"][:, 1:],
                                          got["labels"][:, :-1])
    stream = ds.stream(5)
    assert next(stream)["tokens"].tobytes() == \
        ds.batch(5)["tokens"].tobytes()


class _Recorded:
    """A stand-in for ``loop.train``: hands back recorded histories (the
    fixed-size probe's, or the progressive one's with its expansion step)
    and keeps the configs it was called with."""

    def __init__(self, prog, fixed):
        self.prog, self.fixed, self.calls = prog, fixed, []

    def __call__(self, model_cfg, tcfg, **kw):
        self.calls.append((model_cfg.num_layers, tcfg, sorted(kw)))
        if tcfg.expansions:
            exp = int(tcfg.expansions[0].at_frac * tcfg.total_steps)
            hist = {"loss": self.prog, "expansion_steps": [exp]}
        else:
            hist = {"loss": self.fixed, "expansion_steps": []}
        return loop.TrainResult(history=hist, params=None, opt_state=None,
                                final_layers=0)


@pytest.mark.parametrize("source,mix_at", [(0, 25), (1, 25), (0, None)])
def test_calibrate_tau_over_shared_histories_matches_jax(monkeypatch, source,
                                                         mix_at):
    """The same τ, probe steps, ``MixingReport`` and production
    ``TrainConfig``; the probes are asked for the same runs."""
    prog, fixed = _curves(4, n=60, exp=2, mix_at=mix_at)
    from repro_torch import configs
    from repro import configs as jconfigs
    cfg, jcfg = (c.get_smoke_config("gpt2-12l") for c in (configs, jconfigs))
    kw = dict(total_steps=400, seq_len=24, global_batch=8,
              source_layers=source)
    base = tbase.TrainConfig(schedule=tbase.ScheduleConfig(decay_frac=0.2),
                             **kw)
    jbase_cfg = jbase.TrainConfig(
        schedule=jbase.ScheduleConfig(decay_frac=0.2), **kw)
    ours, theirs = _Recorded(prog, fixed), _Recorded(prog, fixed)
    monkeypatch.setattr(loop, "train", ours)
    monkeypatch.setattr(jloop, "train", theirs)
    quiet = dict(probe_steps=60, tolerance=0.05, log_fn=lambda *a: None)
    got = recipe.calibrate_tau(cfg, base, device="cpu", **quiet)
    want = jrecipe.calibrate_tau(jcfg, jbase_cfg, **quiet)
    assert got.tau == want.tau and got.probe_steps == want.probe_steps
    assert got.mixing.mixed == (mix_at is not None)
    _same(got.mixing, want.mixing, "mixing")
    assert dataclasses.asdict(got.train_config) == \
        dataclasses.asdict(want.train_config)
    assert [(n, dataclasses.asdict(t)) for n, t, _ in ours.calls] == \
        [(n, dataclasses.asdict(t)) for n, t, _ in theirs.calls]
    assert all("device" in k for _, _, k in ours.calls)


def test_calibrate_tau_end_to_end_on_the_cpu():
    """``tests/test_recipe_scaling.py``'s run through the port's trainer:
    τ lands after warmup and at or before the stable phase's end."""
    cfg = tbase.ModelConfig(name="r", family="dense", num_layers=2,
                            d_model=48, num_heads=4, num_kv_heads=4, d_ff=96,
                            vocab_size=128, max_seq_len=64)
    base = tbase.TrainConfig(
        total_steps=400, seq_len=24, global_batch=8, source_layers=0,
        optimizer=tbase.OptimizerConfig(name="muon_nsgd", learning_rate=0.02),
        schedule=tbase.ScheduleConfig(name="wsd", decay_frac=0.2))
    res = recipe.calibrate_tau(cfg, base, probe_steps=50, tolerance=0.05,
                               log_fn=lambda *a: None, device="cpu")
    warmup = int(0.02 * base.total_steps)
    stable_end = base.total_steps - int(0.2 * base.total_steps)
    assert warmup < res.tau <= stable_end
    assert res.probe_steps == 50
    e = res.train_config.expansions[0]
    assert e.target_layers == cfg.num_layers and e.init == "random"
    assert abs(e.at_frac - res.tau / base.total_steps) < 1e-9

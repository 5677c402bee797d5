"""The port's serving path against the JAX package's, on the CPU at smoke
size.

Greedy tokens of ``ServeEngine.generate`` must equal the JAX engine's on the
same parameters, with every step's logits within ``LOGIT_TOL`` (float32 sums
in other orders).  A greedy token is only well defined where its top-2
margin exceeds that tolerance, so the test asserts the margin too: a flip
fails as a margin, never silently.  Temperature sampling uses another
generator than ``jax.random.categorical``, so it is checked by distribution.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import checkpointer as jax_ckpt
from repro.launch import mesh as mesh_lib
from repro.launch import serve as jax_serve
from repro.models import transformer as jtr
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.train import steps
from repro_torch.train.serve_engine import ServeEngine

CFG = configs.get_smoke_config("gpt2-12l")
JCFG = jax_configs.get_smoke_config("gpt2-12l")
LOGIT_TOL = 1e-5


def _params(n_layers=2, seed=0):
    jp = jax.device_get(jtr.lm_init(jax.random.PRNGKey(seed), JCFG,
                                    num_layers=n_layers))
    return jp, bridge.params_from_jax(jp)


@pytest.mark.parametrize("n_layers", [0, 2])
def test_greedy_generate_matches_jax_engine(n_layers):
    jp, tp = _params(n_layers, seed=11)
    prompts = np.random.default_rng(11).integers(
        0, CFG.vocab_size, (2, 10)).astype(np.int32)
    G = 8
    want = JaxServeEngine(JCFG.with_depth(n_layers), jp,
                          mesh=mesh_lib.single_device_mesh(),
                          max_len=32).generate(prompts, G, return_logits=True)
    got = ServeEngine(CFG.with_depth(n_layers), tp, device="cpu",
                      max_len=32).generate(prompts, G, return_logits=True)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (2, 10 + G)
    assert got.steps == G and got.prefill_tokens == 10
    assert got.logits.shape == want.logits.shape == (2, G, CFG.vocab_size)
    top2 = np.sort(want.logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > 2 * LOGIT_TOL, (
        f"near-tie (margin {margin.min():.2e}): greedy tokens undefined at "
        "this tolerance; pick another seed")
    np.testing.assert_allclose(got.logits, want.logits, atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_sampling_follows_the_softmax_distribution():
    """Empirical frequencies at a tiny vocabulary against softmax(l / T),
    for the port's sampler and for jax.random.categorical alike."""
    V, N, temp = 8, 40000, 0.7
    logits = np.random.default_rng(0).standard_normal(V).astype(np.float32)
    p = np.exp(logits / temp - (logits / temp).max())
    p /= p.sum()
    bound = 5 * np.sqrt(p * (1 - p) / N)          # 5 sigma per bin
    gen = torch.Generator().manual_seed(0)
    draws = steps._sample(torch.from_numpy(np.tile(logits, (N, 1))), temp,
                          gen, sample=True)
    freq = np.bincount(draws.numpy(), minlength=V) / N
    assert np.all(np.abs(freq - p) < bound), (freq, p)
    jdraws = jax.random.categorical(jax.random.PRNGKey(0),
                                    np.tile(logits, (N, 1)) / temp)
    jfreq = np.bincount(np.asarray(jdraws), minlength=V) / N
    assert np.all(np.abs(jfreq - p) < bound), (jfreq, p)
    # greedy is argmax, first maximum on ties (as jnp.argmax)
    tie = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert steps._sample(tie, None, None, sample=False).tolist() == [1]


def test_temperature_generate_is_seeded_and_in_vocab():
    _, tp = _params(2, seed=12)
    eng = ServeEngine(CFG, tp, device="cpu", max_len=24)
    prompts = np.zeros((3, 4), np.int32)
    a = eng.generate(prompts, 12, temperature=1.0, seed=5).tokens
    b = eng.generate(prompts, 12, temperature=1.0, seed=5).tokens
    c = eng.generate(prompts, 12, temperature=1.0, seed=6).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < CFG.vocab_size


def test_generate_checks_lengths():
    _, tp = _params(2)
    eng = ServeEngine(CFG, tp, device="cpu", max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 10), np.int32), 7)
    eng = ServeEngine(CFG, tp, device="cpu", max_len=512)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(np.zeros((1, 120), np.int32), 10)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_serve_cli_on_cpu():
    out = _run(serve.main, ["--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4"])
    assert "arch=gpt2-12l-smoke layers=2 mesh=single batch=2" in out
    assert "prefill tokens/s=" in out and "decode tokens/s=" in out
    assert "sample: [" in out


def test_serve_cli_serves_a_jax_checkpoint_at_its_depth(tmp_path):
    """A checkpoint of a grown 4-layer model, written by the JAX
    checkpointer: the port serves it at the manifest's depth and samples
    the JAX CLI's greedy tokens (both draw prompts from the same seed)."""
    jp, _ = _params(4, seed=13)
    jax_ckpt.save(str(tmp_path), 3, {"params": jp},
                  metadata={"num_layers": 4})
    argv = ["--smoke", "--checkpoint", str(tmp_path), "--batch", "2",
            "--prompt-len", "8", "--gen", "6", "--seed", "2"]
    out = _run(serve.main, argv + ["--device", "cpu"])
    want = _run(jax_serve.main, argv)
    assert "layers=4" in out

    def sample(text):
        return [line for line in text.splitlines()
                if line.startswith("sample:")]
    assert sample(out) == sample(want)


def test_default_device_is_the_card(monkeypatch):
    """Without a card the default device raises with the way out named;
    nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _params(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(CFG, tp)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke"])


@pytest.mark.parametrize("flag,item", [
    (["--continuous", "--faults", "storm:0.1"], "item 11"),
    (["--paged"], "requires --continuous"),
    (["--spec-depth", "1"], "item 9"), (["--prefix-cache"], "item 10"),
    (["--mesh", "host"], "item 13")])
def test_unported_cli_paths_name_their_roadmap_item(flag, item):
    with pytest.raises(SystemExit, match=item):
        serve.main(["--smoke", "--device", "cpu"] + flag)

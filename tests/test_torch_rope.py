"""Rotary position embeddings in the port (``models/common.rope_table`` and
``apply_rope``, ``models/attention._position_encode``) against the JAX
package's ``apply_rope``, on the CPU.

The port gathers each position's cos/sin from a table built once per (hd,
θ, length, device) from the reference's float32 angles pos · freq, with
sin and cos taken in float64 and rounded.  XLA's float32 sin/cos differ
from those by at most one float32 ulp (~1% of the entries), and the two
frameworks' float32 pow gives the same frequencies but one at (θ 5e6, hd
128), one ulp apart (~9e-10 on 0.0103), which moves that frequency's angle
by position · 9e-10.  So the rotated values are held to
``ROPE_TOL`` · max|x| plus, at θ 5e6, position · 1e-9 · max|x|, at
positions up to each config's ``max_seq_len - 1``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common

ROPE_TOL = 1e-6
# (θ, hd, max_seq_len): the testbeds (1e4, 64, 1024), starcoder2-3b and the
# MoE registry models (1e4, 128, 16384), yi-34b (5e6, 128, 32768), and the
# smoke configs' head dim 16.
CASES = [(1e4, 16, 128), (1e4, 64, 1024), (1e4, 128, 16384),
         (5e6, 16, 128), (5e6, 64, 1024), (5e6, 128, 32768)]


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("theta,hd,max_len", CASES)
def test_apply_rope_matches_jax_up_to_max_seq_len(theta, hd, max_len):
    """Positions 0..7 and the last 120 below max_seq_len, in a (B, S, H,
    hd) batch whose two rows sit at different positions."""
    pos = np.concatenate([np.arange(8), np.arange(max_len - 120, max_len)])
    pos = np.stack([pos, pos[::-1]]).astype(np.int32)          # (2, 128)
    x = _x(int(theta) % 97 + hd, (2, pos.shape[1], 3, hd))
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta, max_len).numpy()
    scale = float(np.abs(x).max())
    slope = 1e-9 if theta > 1e4 else 0.0
    tol = scale * (ROPE_TOL + slope * pos[:, :, None, None])
    assert np.all(np.abs(got - want) <= tol)
    assert got.dtype == np.float32


def test_frequencies_and_table_follow_the_reference():
    """The float32 frequencies equal the reference's (all but the one
    pow ulp above); the table at a position equals cos/sin of the float32
    angle to one float32 ulp, and equals itself from a longer table."""
    for theta, hd, _ in CASES:
        want = np.asarray(jcommon.rope_freqs(hd, theta))
        got = common.rope_freqs(hd, theta).numpy()
        assert np.sum(got != want) <= (1 if theta > 1e4 else 0)
    cos, sin = common.rope_table(64, 1e4, 1024, "cpu")
    ang = (np.arange(1024, dtype=np.float32)[:, None]
           * np.asarray(jcommon.rope_freqs(64, 1e4))[None, :])
    np.testing.assert_allclose(cos.numpy(), np.asarray(jnp.cos(ang)),
                               atol=6e-8, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jnp.sin(ang)),
                               atol=6e-8, rtol=0)
    cos2, sin2 = common.rope_table(64, 1e4, 4096, "cpu")
    assert torch.equal(cos2[:1024], cos) and torch.equal(sin2[:1024], sin)
    assert common.rope_table(64, 1e4, 1024, "cpu")[0] is cos   # built once


def test_rotation_bits_do_not_depend_on_the_layout():
    """The same rows at the same positions rotate to the same bits as a
    whole prefill (B, S), one decode step, a chunk and a verify round
    (per-row cursors) lay them out: the contracts that hold serving paths
    byte-identical rest on it."""
    cfg = ModelConfig(name="rope", family="dense", num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=64, vocab_size=64, max_seq_len=128)
    S = 40
    xq, xk = _x(1, (2, S, 4, 16)), _x(2, (2, S, 2, 16))

    def rotate(starts, n):
        q = np.stack([xq[b, t:t + n] for b, t in enumerate(starts)])
        k = np.stack([xk[b, t:t + n] for b, t in enumerate(starts)])
        pos = np.stack([88 + t + np.arange(n) for t in starts])
        return attention._position_encode(cfg, torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(pos))

    ref_q, ref_k = rotate((0, 0), S)
    for starts, n in (((0, 17), 1), ((S - 1, 3), 1), ((16, 16), 16),
                      ((33, 21), 7)):
        q, k = rotate(starts, n)
        for b, t in enumerate(starts):
            assert torch.equal(q[b], ref_q[b, t:t + n])
            assert torch.equal(k[b], ref_k[b, t:t + n])


def test_positions_past_the_table_clamp_and_training_past_it_grows_it():
    """A speculative round's positions past the table (the cache's span)
    read its last row (their logits are never in play); a training
    sequence longer than max_seq_len gets a table of its length, as the
    reference rotates any position."""
    x = torch.from_numpy(_x(3, (1, 2, 1, 16)))
    past = common.apply_rope(x, torch.tensor([[127, 140]]), 1e4, 128)
    last = common.apply_rope(x, torch.tensor([[127, 127]]), 1e4, 128)
    assert torch.equal(past, last)
    cfg = ModelConfig(name="rope", family="dense", num_layers=1,
                      d_model=16, num_heads=1, num_kv_heads=1, d_ff=32,
                      vocab_size=64, max_seq_len=8)
    pos = torch.arange(12)[None, :]
    x = torch.from_numpy(_x(4, (1, 12, 1, 16)))
    q, _ = attention._position_encode(cfg, x, x, pos)
    want = jcommon.apply_rope(jnp.asarray(x.numpy()),
                              jnp.asarray(pos.numpy()), 1e4)
    np.testing.assert_allclose(q.numpy(), np.asarray(want),
                               atol=ROPE_TOL * float(x.abs().max()), rtol=0)


def test_mrope_still_raises_naming_item_12():
    """M-RoPE is ported: the attention's position encoding takes (3, B,
    S) ids, and text-only ids (t = h = w) rotate to RoPE's bits."""
    cfg = ModelConfig(name="vl", family="vlm", num_layers=1, d_model=16,
                      num_heads=1, num_kv_heads=1, d_ff=32, vocab_size=64,
                      position="mrope")
    x = torch.from_numpy(_x(5, (1, 12, 1, 16)))
    pos = torch.arange(12)[None, :]
    q, k = attention._position_encode(cfg, x, x, pos[None].expand(3, 1, 12))
    want, _ = attention._position_encode(
        dataclasses.replace(cfg, position="rope"), x, x, pos)
    assert torch.equal(q, want) and torch.equal(k, want)

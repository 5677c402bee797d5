"""Continuous, paged, prefix-cached and speculative serving of the port on
a device mesh, over gloo ranks started by the port's own launcher
(``repro_torch.launch.mesh.spawn``), against the JAX package's solo
``ServeEngine.generate`` on the same parameters.

The reference's serving test configs (``ARCH_CFGS`` of
``tests/test_serving_{paged,spec,prefix}.py``: dense GQA, a 4-wide window
beside global layers, MLA latent pages, Mamba and RWKV6) are drawn by the
JAX package's ``registry.init`` and carried over by ``repro_torch.bridge``.
Each mesh shape is spawned once per module, every scenario of that shape
in one spawn (``tests/mesh_runs.py``'s ``cserve``, which imports no JAX),
one torch thread a rank; the two spawns and the JAX references in this
process run at once.
Held:

  * on ``host`` (4 ranks on 'data', one slot a rank at ``max_batch`` 4),
    every family in every mode (continuous over a contiguous cache, paged
    with chunked prefill, the prefix cache, speculation) gives greedy
    streams byte-identical to the JAX package's solo generation, and every
    rank returns the same results and stats; a ``max_batch`` that does not
    divide the DP ranks serves every slot on every rank, to the same
    streams;
  * the int8 lane on ``host``: dense agrees with its f32 run on at least
    0.9 of the tokens (the reference's bar), Mamba and RWKV6 (no paged
    layer) are byte-exact;
  * on ``2x2`` (two DP blocks of two slots, heads, d_ff and vocab over
    'model'): dense and window on their local KV heads, MLA on its local
    heads over whole latent pages, Mamba on its local channels and RWKV6
    on its local heads (their recurrent states the rank's share), tokens
    equal to one device's, the radix tree's pages alike on the DP ranks
    of each 'model' rank;
  * the replicated pool: a request admitted into a slot of rank 1 hits the
    prefix that rank 0's row published, its stream equal to its cold run,
    and the hash of the pages the radix tree holds (K/V and int8 scales)
    is equal on every DP rank and to one device's run, in f32 and int8;
  * the agreed clock: staggered arrivals, a deadline that expires and a
    ``time_fn`` skewed by the rank times 1000 s give every rank the same
    tokens, finish reasons and admission and finish times;
  * a fault plane, ``snapshot_every``, ``snapshot()`` and ``restore()`` run
    on a mesh (ROADMAP queue A item 22): a decode fault retried and a
    ``sched.iter`` crash restored from rank 0's snapshot file on a fresh
    scheduler give the JAX solo streams on every rank
    (``tests/test_torch_mesh_faults.py`` holds the whole fault plane).
"""
import concurrent.futures
import dataclasses
import json
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
import mesh_runs

MAX_LEN = 48
# The reference's spec workload (``tests/test_serving_spec.py``):
# (prompt, new tokens).
REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5))
ARCHS = ("dense", "window", "mla", "mamba", "rwkv")
MODES = {"contiguous": {},
         "paged": dict(paged=True, block_size=4),
         "prefix": dict(paged=True, block_size=4, prefix_cache=True),
         "spec": dict(paged=True, block_size=4, spec_decode=True, gamma=3,
                      draft_depth=2)}
TP_MODES = {"dense": ("contiguous", "paged", "prefix", "spec"),
            "window": ("contiguous", "paged", "prefix", "spec"),
            "mla": ("paged", "spec"), "mamba": ("paged", "spec"),
            "rwkv": ("paged", "spec")}
INT8 = dict(paged=True, block_size=4, kv_dtype="int8")
QUANT_AGREEMENT = 0.9       # tests/test_serving_paged.py's int8 lane
SKEW_S = 1000.0


def _cfgs(mod):
    dense = mod.ModelConfig(name="ms-dense", family="dense", num_layers=4,
                            d_model=32, num_heads=4, num_kv_heads=2,
                            d_ff=64, vocab_size=64, max_seq_len=64)
    ssm = dict(family="ssm", num_layers=4, d_model=32, num_heads=4,
               num_kv_heads=4, d_ff=64, vocab_size=64, max_seq_len=64,
               attention="none", position="none")
    return {"dense": dense,
            "window": dataclasses.replace(dense, name="ms-window",
                                          window_pattern=(4, 0)),
            "mla": dataclasses.replace(dense, name="ms-mla",
                                       attention="mla", mla_kv_lora_rank=8),
            "mamba": mod.ModelConfig(name="ms-mamba",
                                     block_pattern=("mamba",),
                                     ssm=mod.SSMConfig(d_state=4), **ssm),
            "rwkv": mod.ModelConfig(name="ms-rwkv", norm="layernorm",
                                    block_pattern=("rwkv",),
                                    ssm=mod.SSMConfig(kind="rwkv6",
                                                      head_dim=16), **ssm)}


CFGS = _cfgs(base)
JCFGS = _cfgs(jbase)


def _req(prompt, gen, **kw):
    return dict(prompt=np.asarray(prompt, np.int32), max_new_tokens=gen,
                **kw)


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [_req(rng.integers(0, cfg.vocab_size, (p,)), g)
            for p, g in REQ_SHAPES]


def _shared_workload(cfg, seed=0, gen=6):
    """``tests/test_serving_prefix.py``'s: six prompts over one 12-token
    (3-page) shared prefix S: three tails, S itself (the copy-on-write
    rerun), a repeat and a divergence after one page."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, cfg.vocab_size, (12,))
    tails = [rng.integers(0, cfg.vocab_size, (t,)) for t in (3, 5, 2)]
    div = rng.integers(0, cfg.vocab_size, (8,))
    prompts = [np.concatenate([S, tails[0]]), np.concatenate([S, tails[1]]),
               np.concatenate([S, tails[2]]), S.copy(),
               np.concatenate([S, tails[0]]), np.concatenate([S[:4], div])]
    return [_req(p, gen) for p in prompts]


def _cross_workload(cfg, seed=1):
    """Rows 0-3 (one a rank on ``host``) take requests 0-3 at once;
    request 0 publishes S's 3 pages after 4 chunks, request 1 ends first,
    after 8 tokens, and request 4 (S + another tail) takes its slot on
    rank 1 and hits the pages rank 0's row published."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, cfg.vocab_size, (12,))
    return [_req(np.concatenate([S, rng.integers(0, cfg.vocab_size, (1,))]),
                 16),
            _req(rng.integers(0, cfg.vocab_size, (4,)), 8),
            _req(rng.integers(0, cfg.vocab_size, (6,)), 16),
            _req(rng.integers(0, cfg.vocab_size, (5,)), 16),
            _req(np.concatenate([S, rng.integers(0, cfg.vocab_size, (5,))]),
                 6)]


def _clock_workload(cfg, seed=2):
    """Arrivals 4 ms apart; request 2's deadline expires on arrival."""
    rng = np.random.default_rng(seed)
    shapes = ((6, 8), (9, 5), (4, 6), (7, 7), (5, 9), (8, 4))
    return [_req(rng.integers(0, cfg.vocab_size, (p,)), g,
                 arrival_s=0.004 * i,
                 **({"deadline_s": 1e-9} if i == 2 else {}))
            for i, (p, g) in enumerate(shapes)]


def _kw(mode_kw):
    return dict(chunk_len=4) if mode_kw else {}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(one_thread):
    """The JAX package's params and solo streams, one device's runs of the
    port, and the ``host`` and ``2x2`` spawns."""
    jparams = {a: jax.device_get(jregistry.get_model(JCFGS[a]).init(
        jax.random.PRNGKey(0), JCFGS[a])) for a in ARCHS}
    params = {a: {k: np.asarray(v) for k, v in
                  bridge.flatten(jparams[a]).items()} for a in ARCHS}
    work = {a: {"reqs": _requests(CFGS[a]),
                "shared": _shared_workload(CFGS[a])} for a in ARCHS}
    cross = _cross_workload(CFGS["dense"])
    clock = _clock_workload(CFGS["dense"])

    def jax_solo():
        """The JAX package's solo greedy stream of every request."""
        out = {}
        for a in ARCHS:
            eng = JaxServeEngine(JCFGS[a], jparams[a],
                                 mesh=jmesh.single_device_mesh(),
                                 max_len=MAX_LEN)
            reqs = work[a]["reqs"] + work[a]["shared"]
            if a == "dense":
                reqs = reqs + cross + clock
            for r in reqs:
                key = (a, r["prompt"].tobytes(), r["max_new_tokens"])
                if key not in out:
                    out[key] = np.asarray(eng.generate(
                        r["prompt"][None], r["max_new_tokens"]).tokens[0])
        return out

    def scen(name, a, reqs, mesh, engine_kw, max_batch=4, **kw):
        return (name, "cserve", dict(
            cfg=CFGS[a], params_np=params[a], requests=reqs, mesh=mesh,
            max_len=MAX_LEN, max_batch=max_batch, engine_kw=engine_kw,
            sched_kw=_kw(engine_kw), **kw))

    host, tp = [], []
    for a in ARCHS:
        for mode, kw in MODES.items():
            reqs = work[a]["shared" if mode == "prefix" else "reqs"]
            host.append(scen(f"{a}_{mode}", a, reqs, "host", kw))
            if mode in TP_MODES[a]:
                tp.append(scen(f"{a}_{mode}", a, reqs, "2x2", kw))
    for a in ("dense", "mamba", "rwkv"):
        host.append(scen(f"{a}_int8", a, work[a]["reqs"], "host", INT8))
    host.append(scen("replicated", "dense", work["dense"]["reqs"], "host",
                     MODES["paged"], max_batch=2))
    cross_kw = {f"cross_{d}": dict(MODES["prefix"], kv_dtype=d)
                for d in ("f32", "int8")}
    for name, kw in cross_kw.items():
        host.append(scen(name, "dense", cross, "host", kw))
    host.append(scen("clock", "dense", clock, "host", MODES["paged"],
                     skew_s=SKEW_S))
    snap_dir = tempfile.mkdtemp(prefix="mesh_serve_snap_")
    host.append(scen("faults", "dense", work["dense"]["reqs"], "host",
                     MODES["paged"], faults="engine.decode:1,sched.iter:5:crash",
                     snapshot_dir=snap_dir))
    host[-1][2]["sched_kw"] = dict(chunk_len=4, snapshot_every=1)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(jax_solo)
        spawn_tp = pool.submit(mesh_lib.spawn, mesh_runs.run, 4,
                               (tp, "cpu"), timeout_s=600)
        r_host = mesh_lib.spawn(mesh_runs.run, 4, (host, "cpu"),
                                timeout_s=600)
        r_tp, solo = spawn_tp.result(), ref.result()
    shutil.rmtree(snap_dir, ignore_errors=True)
    # One device's port runs of the cross-rank workload, and request 4's
    # cold int8 run alone.
    none = {name: mesh_runs.cserve(CFGS["dense"], params["dense"], cross,
                                   None, max_len=MAX_LEN, engine_kw=kw,
                                   sched_kw=dict(chunk_len=4))
            for name, kw in cross_kw.items()}
    cold_int8 = mesh_runs.cserve(CFGS["dense"], params["dense"], cross[4:],
                                 None, max_len=MAX_LEN,
                                 engine_kw=cross_kw["cross_int8"],
                                 sched_kw=dict(chunk_len=4))
    print("PROFILE", r_host[0]["_seconds"], r_tp[0]["_seconds"])
    return dict(solo=solo, host=r_host, tp=r_tp, work=work, cross=cross,
                clock=clock, none=none, cold_int8=cold_int8)


def _solo(world, arch, req):
    return world["solo"][(arch, req["prompt"].tobytes(),
                          req["max_new_tokens"])]


def _same_on_every_rank(ranks, name, drop=("seconds", "summary", "rank")):
    def text(r):
        got = {k: v for k, v in r[name].items() if k not in drop}
        return json.dumps(got, sort_keys=True, default=lambda x: (
            x.tolist() if isinstance(x, np.ndarray) else str(x)))
    for r in ranks[1:]:
        assert text(r) == text(ranks[0]), name


def _assert_solo(world, arch, reqs, got):
    assert [r["uid"] for r in got["results"]] == list(range(len(reqs)))
    for req, res in zip(reqs, got["results"]):
        np.testing.assert_array_equal(res["tokens"], _solo(world, arch, req))
        assert res["finish_reason"] == "limit"


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_streams_equal_jax_solo(world, arch, mode):
    """``host``: greedy streams byte-identical to the JAX package's solo
    generation in every mode, every rank's results and stats alike;
    prefix hits where the workload repeats, acceptance under speculation
    within [0, 1]."""
    name = f"{arch}_{mode}"
    _same_on_every_rank(world["host"], name)
    got = world["host"][0][name]
    reqs = world["work"][arch]["shared" if mode == "prefix" else "reqs"]
    _assert_solo(world, arch, reqs, got)
    if mode == "prefix":
        assert got["stats"]["prefix"]["prefix_hits"] >= 1
    if mode == "spec":
        spec = got["stats"]["spec"]
        assert spec["spec_rounds"] > 0
        assert 0 <= spec["spec_accepted"] <= spec["spec_proposed"]


def test_dp_slots_that_do_not_divide_serve_on_every_rank(world):
    """``max_batch`` 2 over 4 DP ranks: every rank serves both slots (the
    batch rule of ``cache_shardings``), to the same streams."""
    _same_on_every_rank(world["host"], "replicated")
    _assert_solo(world, "dense", world["work"]["dense"]["reqs"],
                 world["host"][0]["replicated"])


@pytest.mark.parametrize("arch", ["dense", "mamba", "rwkv"])
def test_int8_lane_on_dp_mesh(world, arch):
    """int8 pages on ``host`` against the f32 pool's run: dense agrees on
    at least 0.9 of the tokens with the same lengths and finish reasons;
    Mamba and RWKV6 quantize nothing and stay byte-exact."""
    _same_on_every_rank(world["host"], f"{arch}_int8")
    f32 = world["host"][0][f"{arch}_paged"]["results"]
    i8 = world["host"][0][f"{arch}_int8"]["results"]
    assert world["host"][0][f"{arch}_int8"]["stats"]["kv"]["kv_dtype"] \
        == "int8"
    if arch != "dense":
        for a, b in zip(f32, i8):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        return
    hit = tot = 0
    for req, a, b in zip(world["work"]["dense"]["reqs"], f32, i8):
        assert len(a["tokens"]) == len(b["tokens"])
        assert a["finish_reason"] == b["finish_reason"]
        P = len(req["prompt"])
        hit += int((a["tokens"][P:] == b["tokens"][P:]).sum())
        tot += len(a["tokens"]) - P
    assert hit / tot >= QUANT_AGREEMENT


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_streams_equal_one_device(world, arch):
    """``2x2``: two DP blocks of two slots, each on two 'model' ranks
    (dense and window on their local KV heads, MLA on its local heads,
    Mamba on its local channels, RWKV6 on its local heads): every mode's
    tokens equal one device's, on every rank."""
    ranks = world["tp"]
    for mode in TP_MODES[arch]:
        name = f"{arch}_{mode}"
        # The pages differ between 'model' ranks (each holds its KV heads
        # where they split) and agree between DP ranks (ranks 0, 2 and
        # 1, 3 of the row-major 2x2 grid).
        _same_on_every_rank(ranks, name, drop=("seconds", "summary", "rank",
                                               "radix_hash"))
        assert ranks[0][name]["radix_hash"] == ranks[2][name]["radix_hash"]
        assert ranks[1][name]["radix_hash"] == ranks[3][name]["radix_hash"]
        reqs = world["work"][arch]["shared" if mode == "prefix" else "reqs"]
        _assert_solo(world, arch, reqs, ranks[0][name])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_prefix_published_on_one_rank_hits_on_another(world, dtype):
    """Request 0 publishes from slot 0 (rank 0); request 4 takes slot 1
    (rank 1) and maps the 3 published pages: its stream equals its cold
    run (the JAX solo stream in f32; the int8 pool's cold run alone in
    int8).  The pages the radix tree holds hash alike on every rank and
    in one device's run, scales included."""
    name = f"cross_{dtype}"
    ranks = world["host"]
    _same_on_every_rank(ranks, name)
    got = ranks[0][name]["results"]
    assert [r["slot"] for r in got[:4]] == [0, 1, 2, 3]
    assert got[4]["slot"] == 1 and got[4]["prefix_tokens"] == 12
    if dtype == "f32":
        _assert_solo(world, "dense", world["cross"], ranks[0][name])
    else:
        np.testing.assert_array_equal(
            got[4]["tokens"], world["cold_int8"]["results"][0]["tokens"])
    hashes = {r[name]["radix_hash"] for r in ranks}
    assert len(hashes) == 1 and None not in hashes
    assert hashes == {world["none"][name]["radix_hash"]}


def test_agreed_clock_under_skewed_time_fn(world):
    """Every rank's clock is skewed by its rank times 1000 s and the
    arrivals are staggered: every rank takes the same decisions (tokens,
    finish reasons, admission and finish times alike); request 2's
    deadline expires before admission, the others' streams equal the JAX
    solo streams."""
    ranks = world["host"]
    _same_on_every_rank(ranks, "clock")
    got = ranks[0]["clock"]["results"]
    reasons = [r["finish_reason"] for r in got]
    assert reasons == ["limit", "limit", "deadline", "limit", "limit",
                       "limit"]
    assert np.isnan(got[2]["admitted_s"])
    for req, res in zip(world["clock"], got):
        if res["finish_reason"] == "limit":
            np.testing.assert_array_equal(res["tokens"],
                                          _solo(world, "dense", req))
            assert res["admitted_s"] >= res["arrival_s"]


def test_fault_planes_and_snapshots_on_mesh_name_a22(world):
    """A fault plane, ``snapshot_every``, ``snapshot()`` and ``restore()``
    on a mesh (ROADMAP queue A item 22, which once refused them): on
    ``host`` a decode fault is retried on every rank, a ``sched.iter``
    crash unwinds every rank, and rank 0's snapshot file restored on a
    fresh scheduler gives every rank the JAX solo streams."""
    _same_on_every_rank(world["host"], "faults")
    got = world["host"][0]["faults"]
    assert got["crashed"]
    assert got["stats"]["fault"]["retries"] >= 1
    assert got["stats"]["fault"]["fault_sites"]["sched.iter"] == 5
    _assert_solo(world, "dense", world["work"]["dense"]["reqs"], got)

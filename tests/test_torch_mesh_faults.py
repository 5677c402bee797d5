"""Fault tolerance in continuous serving on a device mesh, the server's
placement knobs, and the launcher's teardown, over gloo ranks started by
the port's own launcher (``repro_torch.launch.mesh.spawn``), against the
JAX package on the same parameters.

The dense and MoE weights are the JAX package's (``registry.init`` at
seed 0), carried over by ``repro_torch.bridge``.  Each mesh shape is
spawned once, every scenario of that shape in one spawn
(``tests/mesh_runs.py``'s ``cserve`` and ``serve``, which import no JAX),
one torch thread a rank; the three spawns, the JAX references and the
port's one-device runs in this process run at once.  Held:

  * on ``host`` (4 ranks on 'data', a slot a rank), each contract of
    ``tests/test_serving_faults.py``: two transient faults at every
    serving site (the plain, prefix-cache and draft-prefill sites) retried
    to the JAX solo streams; exhausted retries fail only the rows they
    hit; a fault on every decode dispatch fails every row with its
    prefill token; a seeded storm under the invariant watchdog never
    escapes and every request ends with exactly one finish reason; a
    ``sched.iter`` crash at every iteration boundary, and one mid-decode,
    restored from rank 0's snapshot file on a fresh scheduler to the
    uninterrupted streams; deadlines queued and mid-decode on a virtual
    clock, a cancel issued on rank 0 alone and ``queue_limit`` shedding.
    Every rank returns the same results, and they equal the port's
    ``mesh=None`` run under the same tape, storm or cancel, its fault
    stats included;
  * a snapshot the JAX scheduler wrote at a crash restores on ``host`` to
    the JAX solo streams;
  * on ``2x2`` (heads, d_ff and vocab over 'model'): a seeded storm's
    ``fault_sites``, retries and finish reasons equal the JAX scheduler's
    on its 2x2 mesh under the same storm; a decode fault, a mid-decode
    crash and the rank-0 cancel as on one device;
  * the placement knobs: ``fsdp=True`` and ``layout="fsdp"`` on ``2x2``,
    ``layout="fsdp"`` on ``1x2`` and ``fsdp=True, moe_fsdp="ef"`` on an MoE
    config served dropless give the JAX ``ServeEngine``'s greedy tokens
    with the same knobs on the same mesh shape (logits within 1e-4), and
    continuous paged serving under them the JAX solo streams; a rank
    holds each leaf's shard over the DP axes only, and about 1/DP of the
    default placement's bytes;
  * on ``1x2``: an ``rwkv6-7b`` smoke config (each rank two of the four
    WKV heads) crashed at iteration boundaries and restored, each rank
    re-prefilling its heads' carries, to the uninterrupted streams and
    one device's;
  * the teardown: two-rank spawns in a loop, four at once, exit 0 every
    time, and ``close_world`` leaves no gloo thread behind.
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil
import tempfile
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.train import serve_engine as jax_engine
from repro.train import serve_scheduler as jax_sched
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.train.faults import FaultPlane
from repro_torch.train.serve_engine import ServeEngine
from repro_torch.train.serve_scheduler import (FINISH_REASONS,
                                               ContinuousScheduler, Request)
import mesh_runs

MAX_LEN = 48
REQ_SHAPES = ((5, 7), (9, 4), (3, 10), (6, 2), (4, 8), (7, 5), (2, 6),
              (8, 3))
PLAIN_SITES = ("pool.alloc", "engine.prefill_chunk", "engine.decode",
               "engine.table_upload")
PREFIX_SITES = ("radix.match", "radix.publish", "pool.evict")
SITES = PLAIN_SITES + PREFIX_SITES + ("engine.draft_prefill",)
PAGED = dict(paged=True, block_size=4)
PREFIX = dict(PAGED, prefix_cache=True)
SPEC = dict(PAGED, spec_decode=True, gamma=3, draft_depth=2)
# Backoff 0: a faulted row retries at the next iteration whatever the
# clock reads, so a mesh's iterations, and so its site hits, are one
# device's.
SCHED = dict(chunk_len=4, retry_backoff_s=0.0)
KNOBS = {"fsdp": dict(fsdp=True), "layout": dict(layout="fsdp"),
         "ef": dict(fsdp=True, moe_fsdp="ef")}
# (knob, mesh, arch) of the placement lanes
KNOB_LANES = (("fsdp", "2x2", "dense"), ("layout", "2x2", "dense"),
              ("layout", "1x2", "dense"), ("ef", "2x2", "moe"))
KNOB_PROMPT = (4, 6)            # (batch, prompt) of the knobs' generate
KNOB_GEN = 6
CANCEL = {"after": 0, "uids": [1, 5, 99]}
RWKV_CRASHES = (2, 4, 6, 9)


def _cfgs(mod):
    dense = mod.ModelConfig(name="mf-dense", family="dense", num_layers=4,
                            d_model=32, num_heads=4, num_kv_heads=2,
                            d_ff=64, vocab_size=64, max_seq_len=64)
    # Served dropless (capacity E/top_k): a row routes alike whatever the
    # rows beside it, on a mesh's rows as on the whole batch.
    moe = dataclasses.replace(
        dense, name="mf-moe", family="moe",
        moe=mod.MoEConfig(num_experts=8, top_k=2, capacity_factor=4.0))
    return {"dense": dense, "moe": moe}


CFGS = _cfgs(base)
JCFGS = _cfgs(jbase)
RWKV = configs.get_smoke_config("rwkv6-7b")          # 2 layers, 4 heads


def _req(prompt, gen, **kw):
    return dict(prompt=np.asarray(prompt, np.int32), max_new_tokens=gen,
                **kw)


def _requests(cfg, n=len(REQ_SHAPES)):
    rng = np.random.default_rng(0)
    return [_req(rng.integers(0, cfg.vocab_size, (p,)), g)
            for p, g in REQ_SHAPES[:n]]


def _workloads():
    reqs = _requests(CFGS["dense"])
    p = [r["prompt"] for r in reqs]
    return {
        "reqs": reqs, "three": reqs[:3], "four": reqs[:4],
        # Request 0 ends first (2 tokens) and cancels request 1 (live)
        # and request 5 (queued behind four slots); 99 is unknown.
        "cancel": [_req(p[0][:3], 2), _req(p[1], 12), _req(p[2], 8),
                   _req(p[4], 8), _req(p[5], 6), _req(p[6], 6)],
        # One slot: B waits behind A until its deadline lapses.
        "dl_queued": [_req(p[0], 7), _req(p[1], 4, deadline_s=0.01)],
        "dl_mid": [_req(p[0], 30)],
        "shed": [_req(p[0], 5) for _ in range(4)],
        "rwkv": _requests(RWKV, 3)}


W = _workloads()


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cs(name, work, mesh, engine_kw, arch="dense", max_batch=4,
        sched_kw=None, **kw):
    """A ``cserve`` scenario; its params come in at spawn time."""
    return (name, "cserve", dict(
        cfg=RWKV if arch == "rwkv" else CFGS[arch], params_np=arch,
        requests=W[work], mesh=mesh, max_len=MAX_LEN, max_batch=max_batch,
        engine_kw=engine_kw, sched_kw=dict(SCHED, **(sched_kw or {})),
        **kw))


def _with_params(scenarios, params):
    return [(n, fn, dict(kw, params_np=params[kw["params_np"]])
             if isinstance(kw.get("params_np"), str) else kw)
            for n, fn, kw in scenarios]


def _none(scenario):
    """The same scenario on one device, in this process."""
    _, fn, kw = scenario
    kw = dict(kw, mesh=None)
    if kw.get("snapshot_dir"):
        kw["snapshot_dir"] = tempfile.mkdtemp(prefix="mf_none_")
    out = getattr(mesh_runs, fn)(**kw)
    if kw.get("snapshot_dir"):
        shutil.rmtree(kw["snapshot_dir"], ignore_errors=True)
    return out


def _iterations(params_np, work, engine_kw, **sched_kw):
    """Iterations a clean run takes on one device (the ``sched.iter``
    hits of a plane with an empty tape), under the crash runs'
    ``snapshot_every=1`` (whose drains can end a run an iteration
    sooner)."""
    eng = ServeEngine(CFGS["dense"], mesh_runs._tensors(params_np, "cpu"),
                      device="cpu", max_len=MAX_LEN, **engine_kw)
    eng.faults = FaultPlane.from_tape([])
    ContinuousScheduler(eng, max_batch=4, **dict(SCHED, **sched_kw)).run(
        [Request(prompt=r["prompt"], max_new_tokens=r["max_new_tokens"])
         for r in W[work]])
    return eng.faults.counts["sched.iter"]


def _jax_snapshot(jparams, path):
    """The JAX scheduler crashes at its 6th iteration boundary; its last
    snapshot goes to ``path``."""
    jeng = jax_engine.ServeEngine(JCFGS["dense"], jparams, max_len=MAX_LEN,
                                  paged=True, block_size=4,
                                  faults="sched.iter:6:crash")
    js = jax_sched.ContinuousScheduler(jeng, max_batch=2, chunk_len=4,
                                       num_blocks=12, snapshot_every=1)
    from repro.train import faults as jax_faults
    with pytest.raises(jax_faults.CrashError):
        js.run([jax_sched.Request(prompt=r["prompt"],
                                  max_new_tokens=r["max_new_tokens"])
                for r in W["three"]])
    jax_sched.save_snapshot(js.last_snapshot, path)


def _jax_mesh(spec):
    d, m = (int(x) for x in spec.split("x"))
    return jmesh.make_mesh((d, m), ("data", "model"),
                           devices=jax.devices()[:d * m])


def _knob_prompts(cfg):
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab_size, KNOB_PROMPT).astype(np.int32)


def _jax_refs(jparams):
    """The JAX package's solo streams of every dense request, its 2x2
    storm, and its greedy ``generate`` under each knob lane."""
    solo = {}
    eng = jax_engine.ServeEngine(JCFGS["dense"], jparams["dense"],
                                 mesh=jmesh.single_device_mesh(),
                                 max_len=MAX_LEN)
    for work in ("reqs", "cancel", "dl_queued", "dl_mid"):
        for r in W[work]:
            key = (r["prompt"].tobytes(), r["max_new_tokens"])
            if key not in solo:
                solo[key] = np.asarray(eng.generate(
                    r["prompt"][None], r["max_new_tokens"]).tokens[0])
    jeng = jax_engine.ServeEngine(JCFGS["dense"], jparams["dense"],
                                  mesh=_jax_mesh("2x2"), max_len=MAX_LEN,
                                  paged=True, block_size=4,
                                  faults="storm:0.05:0")
    js = jax_sched.ContinuousScheduler(jeng, max_batch=2, snapshot_every=1,
                                       **SCHED)
    res = js.run([jax_sched.Request(prompt=r["prompt"],
                                    max_new_tokens=r["max_new_tokens"])
                  for r in W["four"]])
    storm = {"stats": js.fault_stats(),
             "reasons": [r.finish_reason for r in res],
             "tokens": [np.asarray(r.tokens) for r in res]}
    knobs = {}
    for knob, mesh, arch in KNOB_LANES:
        g = jax_engine.ServeEngine(JCFGS[arch], jparams[arch],
                                   mesh=_jax_mesh(mesh), max_len=MAX_LEN,
                                   **KNOBS[knob]).generate(
            _knob_prompts(CFGS[arch]), KNOB_GEN, return_logits=True)
        knobs[(knob, mesh, arch)] = (np.asarray(g.tokens),
                                     np.asarray(g.logits))
    return {"solo": solo, "storm": storm, "knobs": knobs}


@pytest.fixture(scope="module")
def world(one_thread):
    jparams = {a: jax.device_get(jregistry.get_model(JCFGS[a]).init(
        jax.random.PRNGKey(0), JCFGS[a])) for a in CFGS}
    params = {a: {k: np.asarray(v) for k, v in
                  bridge.flatten(jparams[a]).items()} for a in CFGS}
    params["rwkv"] = {k: bridge.to_numpy(v) for k, v in bridge.flatten(
        registry.get_model(RWKV).init(torch.Generator().manual_seed(0),
                                      RWKV, device="cpu")).items()}
    tmp = tempfile.mkdtemp(prefix="mesh_faults_")
    dirs = {m: os.path.join(tmp, m) for m in ("host", "2x2", "1x2")}
    for d in dirs.values():
        os.makedirs(d)
    jax_snap = os.path.join(tmp, "jax_snapshot.json")
    _jax_snapshot(jparams["dense"], jax_snap)
    n_iter = _iterations(params["dense"], "three", PREFIX, num_blocks=12,
                         snapshot_every=1)

    host, tp, one_by_two = [], [], []
    for site in SITES:
        eng = SPEC if site == "engine.draft_prefill" else \
            PREFIX if site in PREFIX_SITES else PAGED
        host.append(_cs(f"tape_{site}", "reqs", "host", eng,
                        faults=f"{site}:1,{site}:2",
                        sched_kw=dict(num_blocks=8, max_retries=3)))
    host.append(_cs("exhausted", "reqs", "host", PAGED,
                    faults=",".join(f"engine.prefill_chunk:{n}"
                                    for n in range(1, 9)),
                    sched_kw=dict(num_blocks=8, max_retries=1)))
    host.append(_cs("decode_storm", "four", "host", PAGED,
                    faults=",".join(f"engine.decode:{n}"
                                    for n in range(1, 40)),
                    sched_kw=dict(num_blocks=8, max_retries=0)))
    host.append(_cs("storm", "reqs", "host", PREFIX, faults="storm:0.05:3",
                    sched_kw=dict(num_blocks=8, max_retries=2,
                                  invariant_every=1)))
    host.append(_cs("clean3", "three", "host", PREFIX,
                    sched_kw=dict(num_blocks=12, snapshot_every=1)))
    for k in range(1, n_iter + 1):
        host.append(_cs(f"crash_{k}", "three", "host", PREFIX,
                        faults=f"sched.iter:{k}:crash",
                        snapshot_dir=dirs["host"],
                        sched_kw=dict(num_blocks=12, snapshot_every=1)))
    crash_mid = dict(faults="engine.decode:4:crash",
                     sched_kw=dict(num_blocks=12, snapshot_every=1))
    host.append(_cs("crash_mid", "three", "host", PREFIX,
                    snapshot_dir=dirs["host"], **crash_mid))
    host.append(_cs("dl_queued", "dl_queued", "host", PAGED, max_batch=1,
                    tick_s=0.002, sched_kw=dict(num_blocks=8)))
    host.append(_cs("dl_mid", "dl_mid", "host", PAGED, max_batch=1,
                    tick_s=0.002, sched_kw=dict(num_blocks=12,
                                                deadline_s=0.05)))
    host.append(_cs("cancel", "cancel", "host", PAGED, cancel=CANCEL,
                    sched_kw=dict(num_blocks=12)))
    host.append(_cs("shed", "shed", "host", PAGED, max_batch=1,
                    sched_kw=dict(num_blocks=8, queue_limit=1)))
    host.append(_cs("jax_snapshot", "three", "host", PAGED,
                    restore_from=jax_snap, sched_kw=dict(num_blocks=12)))

    tp.append(_cs("storm", "four", "2x2", PAGED, max_batch=2,
                  faults="storm:0.05:0", sched_kw=dict(snapshot_every=1)))
    tp.append(_cs("tape_engine.decode", "reqs", "2x2", PAGED,
                  faults="engine.decode:1,engine.decode:2",
                  sched_kw=dict(num_blocks=8, max_retries=3)))
    tp.append(_cs("crash_mid", "three", "2x2", PREFIX,
                  snapshot_dir=dirs["2x2"], **crash_mid))
    tp.append(_cs("cancel", "cancel", "2x2", PAGED, cancel=CANCEL,
                  sched_kw=dict(num_blocks=12)))
    tp.append(("gen_default", "serve", dict(
        cfg=CFGS["dense"], params_np="dense",
        prompts=_knob_prompts(CFGS["dense"]), num_tokens=KNOB_GEN,
        mesh="2x2", max_len=MAX_LEN)))
    for knob, mesh, arch in KNOB_LANES:
        lane = tp if mesh == "2x2" else one_by_two
        lane.append((f"gen_{knob}_{arch}", "serve", dict(
            cfg=CFGS[arch], params_np=arch, prompts=_knob_prompts(CFGS[arch]),
            num_tokens=KNOB_GEN, mesh=mesh, max_len=MAX_LEN,
            engine_kw=KNOBS[knob])))
        if arch == "dense":
            lane.append(_cs(f"paged_{knob}", "reqs", mesh,
                            dict(PAGED, **KNOBS[knob])))
    one_by_two.append(_cs("rwkv_clean", "rwkv", "1x2", PAGED, arch="rwkv",
                          sched_kw=dict(num_blocks=12)))
    for k in RWKV_CRASHES:
        one_by_two.append(_cs(
            f"rwkv_crash_{k}", "rwkv", "1x2", PAGED, arch="rwkv",
            faults=f"sched.iter:{k}:crash", snapshot_dir=dirs["1x2"],
            sched_kw=dict(num_blocks=12, snapshot_every=1)))

    def spawn(n, scen):
        return mesh_lib.spawn(mesh_runs.run, n,
                              (_with_params(scen, params), "cpu"),
                              timeout_s=600)

    compare = [s for s in host if s[0] in (
        [f"tape_{x}" for x in SITES] + ["exhausted", "decode_storm", "storm",
                                        "clean3", "crash_mid", "dl_queued",
                                        "cancel", "shed"])]
    compare_tp = [s for s in tp if s[0] in ("storm", "tape_engine.decode",
                                            "cancel")]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        f_host = pool.submit(spawn, 4, host)
        f_tp = pool.submit(spawn, 4, tp)
        f_12 = pool.submit(spawn, 2, one_by_two)
        f_jax = pool.submit(_jax_refs, jparams)
        none = {n: _none(s) for n, s in
                ((s[0], s) for s in _with_params(compare, params))}
        none_tp = {n: _none(s) for n, s in
                   ((s[0], s) for s in _with_params(compare_tp, params))}
        none["rwkv_clean"] = _none(next(
            s for s in _with_params(one_by_two, params)
            if s[0] == "rwkv_clean"))
        none["gen"] = mesh_runs.serve(CFGS["dense"], params["dense"],
                                      _knob_prompts(CFGS["dense"]), KNOB_GEN,
                                      None, max_len=MAX_LEN)
        r_host, r_tp, r_12 = f_host.result(), f_tp.result(), f_12.result()
        ref = f_jax.result()
    shutil.rmtree(tmp, ignore_errors=True)
    print("PROFILE", time.perf_counter() - t0, r_host[0]["_seconds"],
          r_tp[0]["_seconds"], r_12[0]["_seconds"])
    return dict(host=r_host, tp=r_tp, r12=r_12, none=none, none_tp=none_tp,
                ref=ref, n_iter=n_iter, params=params)


def _text(got, drop=("seconds", "summary", "rank", "radix_hash", "held")):
    """A run's results and stats as text, without what may differ between
    ranks (times, the pages a 'model' rank holds, its held shapes)."""
    got = {k: v for k, v in got.items() if k not in drop}
    if "results" in got:
        got["results"] = [{k: v for k, v in r.items() if k not in (
            "arrival_s", "admitted_s", "finished_s")}
            for r in got["results"]]
    return json.dumps(got, sort_keys=True, default=lambda x: (
        x.tolist() if isinstance(x, np.ndarray) else str(x)))


def _same_on_every_rank(ranks, name):
    first = _text(dict(ranks[0][name]))
    for r in ranks[1:]:
        assert _text(dict(r[name])) == first, name


def _streams(got):
    return [(r["uid"], list(r["tokens"]), r["finish_reason"])
            for r in got["results"]]


def _equal_to_one_device(got, want, stats=True):
    """Tokens and finish reasons equal one device's; with ``stats`` the
    fault counters and site hits too."""
    assert _streams(got) == _streams(want)
    if stats:
        assert got["stats"]["fault"] == want["stats"]["fault"]
    assert got["crashed"] == want["crashed"]


def _solo(world, req):
    return world["ref"]["solo"][(req["prompt"].tobytes(),
                                 req["max_new_tokens"])]


def _prefix_of_solo(world, work, got):
    """Whatever each request emitted, full or partial, is a prefix of its
    JAX solo stream; completed ones are the whole stream."""
    for req, res in zip(W[work], got["results"]):
        assert res["finish_reason"] in FINISH_REASONS
        want = _solo(world, req)
        np.testing.assert_array_equal(res["tokens"],
                                      want[:len(res["tokens"])])
        if res["finish_reason"] in ("eos", "limit"):
            np.testing.assert_array_equal(res["tokens"], want)


# ---------------------------------------------------------------------------
# The reference's fault contracts on 'host'
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", SITES)
def test_transient_fault_at_each_site_recovers(world, site):
    """Two faults at ``site``, three retries: every request completes with
    its JAX solo stream on every rank, the site fired past its tape, and
    the results and fault stats are one device's under the same tape."""
    name = f"tape_{site}"
    _same_on_every_rank(world["host"], name)
    got = world["host"][0][name]
    assert all(r["finish_reason"] == "limit" for r in got["results"])
    _prefix_of_solo(world, "reqs", got)
    fault = got["stats"]["fault"]
    assert fault["fault_sites"][site] >= 2 and fault["retries"] >= 1
    _equal_to_one_device(got, world["none"][name])


def test_exhausted_retries_fail_only_affected_rows(world):
    """A streak of prefill-chunk faults over a retry budget of 1 fails some
    requests (the error names the site) and completes the rest byte for
    byte, as on one device."""
    _same_on_every_rank(world["host"], "exhausted")
    got = world["host"][0]["exhausted"]
    reasons = [r["finish_reason"] for r in got["results"]]
    assert "failed" in reasons and "limit" in reasons
    for r in got["results"]:
        if r["finish_reason"] == "failed":
            assert "engine.prefill_chunk" in r["error"]
    _prefix_of_solo(world, "reqs", got)
    assert got["stats"]["fault"]["failed"] == reasons.count("failed")
    _equal_to_one_device(got, world["none"]["exhausted"])


def test_decode_fault_on_every_dispatch_fails_live_rows(world):
    """Every decode dispatch faults with no retry budget: every request
    fails with its prefill token alone (a prefix of its solo stream), on
    every rank, and the scheduler returns."""
    _same_on_every_rank(world["host"], "decode_storm")
    got = world["host"][0]["decode_storm"]
    for req, res in zip(W["four"], got["results"]):
        assert res["finish_reason"] == "failed"
        assert len(res["tokens"]) == len(req["prompt"]) + 1
    _prefix_of_solo(world, "four", got)
    _equal_to_one_device(got, world["none"]["decode_storm"])


def test_storm_never_escapes_with_the_watchdog(world):
    """A seeded storm over every site with the invariant watchdog at every
    iteration: a result with exactly one finish reason for every request,
    completed ones byte-identical, the same on every rank and on one
    device, sites and retries included."""
    _same_on_every_rank(world["host"], "storm")
    got = world["host"][0]["storm"]
    assert sorted(r["uid"] for r in got["results"]) == list(range(8))
    assert sum(got["summary"]["finish_reasons"].values()) == 8
    _prefix_of_solo(world, "reqs", got)
    assert got["stats"]["fault"]["retries"] >= 1
    _equal_to_one_device(got, world["none"]["storm"])


def test_crash_at_every_iteration_boundary_restores(world):
    """``sched.iter:k:crash`` for every boundary k of the workload: every
    rank unwinds, rank 0's snapshot file restores on a fresh scheduler on
    every rank, and the merged streams equal the uninterrupted run's (and
    the JAX solo streams)."""
    clean = world["host"][0]["clean3"]
    _prefix_of_solo(world, "three", clean)
    assert world["n_iter"] > 3
    for k in range(1, world["n_iter"] + 1):
        name = f"crash_{k}"
        _same_on_every_rank(world["host"], name)
        got = world["host"][0][name]
        assert got["crashed"], k
        assert _streams(got) == _streams(clean), k


@pytest.mark.parametrize("mesh", ["host", "2x2"])
def test_crash_mid_iteration_restores(world, mesh):
    """A crash inside an iteration (the 4th decode dispatch) loses at most
    that iteration; the restored streams equal the uninterrupted ones, as
    on one device."""
    ranks = world["host" if mesh == "host" else "tp"]
    _same_on_every_rank(ranks, "crash_mid")
    got = ranks[0]["crash_mid"]
    assert got["crashed"]
    assert _streams(got) == _streams(world["host"][0]["clean3"])
    assert _streams(got) == _streams(world["none"]["crash_mid"])


def test_deadlines_on_the_mesh(world):
    """On a virtual clock: a request queued behind a busy slot finishes
    ``deadline`` with no tokens (as on one device), and the scheduler-wide
    deadline stops a live request mid-decode with a prefix of its solo
    stream, the same on every rank."""
    _same_on_every_rank(world["host"], "dl_queued")
    got = world["host"][0]["dl_queued"]
    a, b = got["results"]
    assert a["finish_reason"] == "limit" and b["finish_reason"] == "deadline"
    assert len(b["tokens"]) == len(W["dl_queued"][1]["prompt"])
    assert b["slot"] == -1 and np.isnan(b["admitted_s"])
    _prefix_of_solo(world, "dl_queued", got)
    _equal_to_one_device(got, world["none"]["dl_queued"])
    _same_on_every_rank(world["host"], "dl_mid")
    res, = world["host"][0]["dl_mid"]["results"]
    assert res["finish_reason"] == "deadline"
    P = len(W["dl_mid"][0]["prompt"])
    assert P < len(res["tokens"]) < P + 30
    _prefix_of_solo(world, "dl_mid", world["host"][0]["dl_mid"])


@pytest.mark.parametrize("mesh", ["host", "2x2"])
def test_cancel_on_rank_0_lands_on_every_rank(world, mesh):
    """Rank 0 alone cancels requests 1 (live) and 5 (queued) and an unknown
    uid from its ``on_finish``: every rank cancels both at the same
    boundary, request 1 with a prefix of its solo stream and request 5 with
    nothing, and the results equal one device's with the same cancel."""
    ranks = world["host" if mesh == "host" else "tp"]
    none = world["none" if mesh == "host" else "none_tp"]["cancel"]
    _same_on_every_rank(ranks, "cancel")
    got = ranks[0]["cancel"]
    reasons = [r["finish_reason"] for r in got["results"]]
    assert reasons == ["limit", "cancelled", "limit", "limit", "limit",
                       "cancelled"]
    P1 = len(W["cancel"][1]["prompt"])
    assert P1 < len(got["results"][1]["tokens"]) < P1 + 12
    assert len(got["results"][5]["tokens"]) == len(W["cancel"][5]["prompt"])
    assert got["stats"]["fault"]["cancelled"] == 2
    _prefix_of_solo(world, "cancel", got)
    _equal_to_one_device(got, none)


def test_queue_limit_sheds_on_the_mesh(world):
    """``queue_limit`` 1 and one slot, four arrivals at once: one serves
    and three shed, on every rank as on one device."""
    _same_on_every_rank(world["host"], "shed")
    got = world["host"][0]["shed"]
    assert [r["finish_reason"] for r in got["results"]].count("shed") == 3
    assert got["summary"]["finish_reasons"] == {"limit": 1, "shed": 3}
    for r in got["results"]:
        if r["finish_reason"] == "shed":
            assert "queue_limit" in r["error"]
    _equal_to_one_device(got, world["none"]["shed"])


def test_snapshot_written_by_jax_restores_on_the_mesh(world):
    """The JAX scheduler crashed mid-run and saved its snapshot; restored
    on the port's ``host`` mesh it gives every rank the JAX solo
    streams."""
    _same_on_every_rank(world["host"], "jax_snapshot")
    got = world["host"][0]["jax_snapshot"]
    assert [r["uid"] for r in got["results"]] == [0, 1, 2]
    _prefix_of_solo(world, "three", got)
    assert all(r["finish_reason"] == "limit" for r in got["results"])


# ---------------------------------------------------------------------------
# 2x2: the JAX scheduler's storm, tensor parallelism under faults
# ---------------------------------------------------------------------------


def test_storm_sites_and_retries_equal_jax_on_2x2(world):
    """``storm:0.05:0`` with ``snapshot_every=1`` on 2x2: the site hits,
    retries and finish reasons equal the JAX scheduler's on its 2x2 mesh
    under the same storm, the streams its, and one device's port run's."""
    _same_on_every_rank(world["tp"], "storm")
    got = world["tp"][0]["storm"]
    want = world["ref"]["storm"]
    assert got["stats"]["fault"]["fault_sites"] == \
        want["stats"]["fault_sites"]
    assert got["stats"]["fault"]["retries"] == want["stats"]["retries"]
    assert [r["finish_reason"] for r in got["results"]] == want["reasons"]
    for r, w in zip(got["results"], want["tokens"]):
        np.testing.assert_array_equal(r["tokens"], w)
    _equal_to_one_device(got, world["none_tp"]["storm"])


def test_transient_decode_fault_under_tensor_parallelism(world):
    """Two decode faults on 2x2 (heads, d_ff and vocab over 'model'):
    retried on all four ranks to the JAX solo streams, as on one
    device."""
    _same_on_every_rank(world["tp"], "tape_engine.decode")
    got = world["tp"][0]["tape_engine.decode"]
    _prefix_of_solo(world, "reqs", got)
    assert all(r["finish_reason"] == "limit" for r in got["results"])
    _equal_to_one_device(got, world["none_tp"]["tape_engine.decode"])


# ---------------------------------------------------------------------------
# The placement knobs
# ---------------------------------------------------------------------------


def _lane(world, mesh):
    return world["tp"] if mesh == "2x2" else world["r12"]


@pytest.mark.parametrize("knob,mesh,arch", KNOB_LANES)
def test_knobs_generate_matches_jax_with_the_same_knobs(world, knob, mesh,
                                                         arch):
    """Greedy ``generate`` under the knob on the mesh: the JAX
    ``ServeEngine``'s tokens with the same knobs on the same mesh shape,
    logits within 1e-4, on every rank."""
    want_tokens, want_logits = world["ref"]["knobs"][(knob, mesh, arch)]
    for r in _lane(world, mesh):
        got = r[f"gen_{knob}_{arch}"]
        np.testing.assert_array_equal(got["tokens"], want_tokens)
        np.testing.assert_allclose(got["logits"], want_logits, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("knob,mesh", [("fsdp", "2x2"), ("layout", "2x2"),
                                       ("layout", "1x2")])
def test_knobs_continuous_paged_streams(world, knob, mesh):
    """Continuous paged serving under the knob: every rank's streams are
    the JAX solo streams."""
    ranks = _lane(world, mesh)
    _same_on_every_rank(ranks, f"paged_{knob}")
    got = ranks[0][f"paged_{knob}"]
    assert all(r["finish_reason"] == "limit" for r in got["results"])
    _prefix_of_solo(world, "reqs", got)


@pytest.mark.parametrize("knob,mesh,arch", KNOB_LANES)
def test_rank_holds_its_dp_shards_only(world, knob, mesh, arch):
    """Each leaf that ``param_spec`` splits over a DP axis under the knob
    is held as that shard alone ('data' under ``fsdp``, the expert-ffn dim
    under ``moe_fsdp='ef'``, ('data', 'model') under the fsdp layout), and
    a rank's bytes fall to about 1/DP of the default placement's."""
    cfg = CFGS[arch]
    d, m = (int(x) for x in mesh.split("x"))
    shape = shd.MeshShape(("data", "model"), (d, m))
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    full = {k: tuple(v.shape) for k, v in bridge.flatten(like).items()}
    specs = bridge.flatten(shd.params_shardings(like, shape, **KNOBS[knob]))
    kw = KNOBS[knob]
    dp = ("data", "model") if kw.get("layout") == "fsdp" else ("data",)
    held = [r[f"gen_{knob}_{arch}"]["held"] for r in _lane(world, mesh)]
    split = 0
    for key, spec in specs.items():
        for dim, e in enumerate(spec):
            axes = tuple(a for a in shd.dim_axes(e) if a in dp)
            n = int(np.prod([dict(zip(("data", "model"), (d, m)))[a]
                             for a in axes])) if axes else 1
            if n > 1:
                split += 1
                for h in held:
                    assert h["shapes"][key][dim] * n <= full[key][dim], key
    assert split > 0
    if arch == "dense":
        default = world["tp"][0]["gen_default"]["held"]["param_bytes"]
        whole = world["none"]["gen"]["held"]["param_bytes"]
        base_bytes = default if mesh == "2x2" and knob == "fsdp" else whole
        ndp = d if knob == "fsdp" else d * m
        for h in held:
            assert h["param_bytes"] <= base_bytes / ndp * 1.25, (
                h["param_bytes"], base_bytes)


def test_default_placement_is_unchanged(world):
    """The defaults (``fsdp=False``, ``layout='tp'``, ``moe_fsdp='auto'``)
    place as before the knobs: the 'model' shards a layer computes on,
    every other leaf whole, and one device's tokens."""
    got = world["tp"][0]["gen_default"]
    np.testing.assert_array_equal(got["tokens"], world["none"]["gen"]
                                  ["tokens"])
    shapes = got["held"]["shapes"]
    assert shapes["['blocks']['layer0']['mlp']['w_up']"][-1] == 64 // 2
    assert shapes["['final_norm']['scale']"] == (32,)


# ---------------------------------------------------------------------------
# RWKV6 carries through crash-restore on 1x2
# ---------------------------------------------------------------------------


def test_rwkv_crash_restore_on_1x2_restores_each_ranks_heads(world):
    """``rwkv6-7b``'s smoke config on 1x2, each rank two of the four WKV
    heads: crashes at several boundaries restore (every rank re-prefilling
    prompt + emitted into its heads' carries) to the uninterrupted
    streams, which equal one device's."""
    ranks = world["r12"]
    _same_on_every_rank(ranks, "rwkv_clean")
    clean = ranks[0]["rwkv_clean"]
    assert _streams(clean) == _streams(world["none"]["rwkv_clean"])
    for k in RWKV_CRASHES:
        _same_on_every_rank(ranks, f"rwkv_crash_{k}")
        got = ranks[0][f"rwkv_crash_{k}"]
        assert got["crashed"], k
        assert _streams(got) == _streams(clean), k


# ---------------------------------------------------------------------------
# The launcher's teardown
# ---------------------------------------------------------------------------


def test_spawn_teardown_exits_clean_in_a_loop(one_thread):
    """Two-rank spawns, four at once and twice over (the load under which
    a rank once aborted at exit): every spawn returns, so every rank
    exited 0, and after ``close_world`` no gloo worker or transport thread
    is left in a rank, though a ``Mesh`` stays cached and another sits in
    a reference cycle."""
    scen = [("probe", "teardown_probe", dict(mesh="host"))]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        runs = [pool.submit(mesh_lib.spawn, mesh_runs.run, 2, (scen, "cpu"),
                            timeout_s=120) for _ in range(8)]
        results = [f.result() for f in runs]
    for ranks in results:
        for r in ranks:
            names = r["probe"]["threads"]
            assert not [n for n in names if "gloo" in n], names

"""The port on a device mesh, over gloo ranks started by the port's own
launcher (``repro_torch.launch.mesh.spawn``), against the JAX package's
sharded runs (the 4x2 training run's losses up to τ, and DP and TP greedy
serving) and, for the rest, against the port on one device (whose
single-device paths the other ``test_torch_*`` modules hold against the
JAX package).

Each mesh shape is started once per module: a module fixture spawns the
ranks and runs every scenario of that shape in one go
(``tests/mesh_runs.py``, which imports no JAX, so the children
never import it), one torch thread a rank.  Held:

  * the JAX 4x2 run of ``tests/test_distributed.py``'s ``CFG`` from the
    same parameters (a step-0 checkpoint both engines resume from): the
    losses up to τ within 1e-4 and the same expansion step; the port's
    4x2 run against its own single-device run within 1e-4 through the
    end;
  * ``grad_accum=2`` against one full batch on the mesh: 1e-4;
  * Muon-NSGD with the global-norm clip under remat on the mesh (every
    matrix orthogonalized whole, an expert stack split over 'model'
    orthogonalized expert by expert on its rank, every element counted
    once in the norms, each super-block gathered again in its backward)
    against one device: 1e-4;
  * ``zero`` and ``copying_zeroL`` expansions of sharded params keep the
    logits (1e-5), and ``expand_opt_state`` under every policy gives the
    single-device expansion bit for bit with moments shaped as params;
  * a checkpoint saved at 4x2 restores at 2x2 and without a mesh equal,
    and an asynchronous save writes the synchronous save's bytes;
  * an MoE run under ``layout="fsdp"`` within 1e-4 of one device;
  * the fault plane on a 2x2 mesh: transient faults at every train site
    (the checkpoint write's on rank 0 alone) retried on every rank alike,
    a NaN step skipped by every rank, losses within 1e-4 of one device
    under the same plan; a crash unwinds every rank and the restart
    resumes to one device's losses;
  * greedy serving from the JAX model's parameters: DP (``host``) of the
    dense, Mamba and RWKV6 configs byte-identical to one device with
    logits within 1e-4, and equal to the JAX package's ``host`` serving
    (logits 1e-4); TP 4x2 dense tokens equal to one device's and to the
    JAX package's 4x2 serving (logits 1e-4); the ``copying_zeroL``-
    expanded checkpoint served on the DP mesh gives the source model's
    tokens;
  * the serve CLI's continuous, paged, prefix-cached serving on a
    two-rank mesh, and its fault injection and crash snapshots there.
"""
import concurrent.futures
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.optim.base import make_optimizer as jmake_optimizer
from repro.train.engine import ProgressiveTrainer as JaxTrainer
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import base
from repro_torch.core import expansion as exp
from repro_torch.launch import mesh as mesh_lib
import mesh_runs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
from repro_torch.train.engine import ProgressiveTrainer
from repro_torch.train.serve_engine import ServeEngine

_CFG = dict(name="dist", family="dense", num_layers=4, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
            max_seq_len=32)
CFG = base.ModelConfig(**_CFG)
JCFG = jbase.ModelConfig(**_CFG)
CFG_MOE = dataclasses.replace(CFG, name="dist-moe", family="moe",
                              moe=base.MoEConfig(num_experts=8, top_k=2))


def _srv(mod):
    """The serving configs of ``tests/test_serving.py``, in ``mod``'s
    config classes."""
    return {"dense": mod.ModelConfig(
                name="srv-dense", family="dense", num_layers=4, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                max_seq_len=64),
            "mamba": mod.ModelConfig(
                name="srv-mamba", family="ssm", num_layers=4, d_model=32,
                num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                max_seq_len=64, attention="none", position="none",
                block_pattern=("mamba",), ssm=mod.SSMConfig(d_state=4)),
            "rwkv": mod.ModelConfig(
                name="srv-rwkv", family="ssm", num_layers=4, d_model=32,
                num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                max_seq_len=64, attention="none", position="none",
                norm="layernorm", block_pattern=("rwkv",),
                ssm=mod.SSMConfig(kind="rwkv6", head_dim=16))}


SRV = _srv(base)
JSRV = _srv(jbase)
TAU_STEP = 6
GEN = 12
# Transient faults at every train site and the checkpoint write, and one
# NaN step under the skip policy.
FAULTS = dict(faults="train.step:3,ckpt.write:1,train.batch:5,"
                     "train.expand:1,ckpt.write:2",
              nan_policy="skip", nan_inject="nan:4")


def _tcfg(mod, **kw):
    cfg = dict(total_steps=12, seq_len=16, global_batch=16, source_layers=1,
               optimizer=mod.OptimizerConfig(name="adamw",
                                             learning_rate=0.01),
               schedule=mod.ScheduleConfig(name="wsd"),
               expansions=(mod.ExpansionConfig(at_frac=0.5, target_layers=2,
                                               init="random"),),
               eval_every=10_000, checkpoint_every=10_000, log_every=1)
    cfg.update(kw)
    return mod.TrainConfig(**cfg)


def _muon_tcfg():
    """Muon-NSGD, a global-norm clip that binds (0.05), remat 'nothing'."""
    return _tcfg(base, optimizer=base.OptimizerConfig(
        name="muon_nsgd", learning_rate=0.01, grad_clip=0.05), remat=True)


def _params_np(cfg, seed=0):
    p = registry.get_model(cfg).init(torch.Generator().manual_seed(seed),
                                     cfg, device="cpu")
    return {k: v.numpy() for k, v in bridge.flatten(p).items()}


def _jax_params(jcfg, seed=0):
    """The JAX model's parameters, and the same as numpy (the port's)."""
    jp = jax.device_get(jregistry.get_model(jcfg).init(
        jax.random.PRNGKey(seed), jcfg))
    return jp, {k: np.asarray(v) for k, v in bridge.flatten(jp).items()}


def _prompts(cfg, B=8, P=8, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _solo(cfg, params_np, prompts, max_len=32):
    params = bridge.unflatten({k: torch.from_numpy(v.copy())
                               for k, v in params_np.items()})
    return ServeEngine(cfg, params, device="cpu", max_len=max_len).generate(
        prompts, GEN, return_logits=True)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_thread):
    """Everything: the JAX reference run, the single-device references,
    the 8-rank (4x2) scenarios and the 4-rank (2x2 and host) ones."""
    tmp = tmp_path_factory.mktemp("mesh")
    # A step-0 checkpoint of the JAX model's parameters, which the JAX and
    # the port trainers both resume from.
    j1 = JCFG.with_depth(1)
    jp = jregistry.get_model(j1).init(jax.random.PRNGKey(0), j1)
    jopt = jmake_optimizer(jbase.OptimizerConfig(name="adamw",
                                                 learning_rate=0.01))
    init = tmp / "init"
    jckpt.save(str(init), 0, {"params": jp, "opt_state": jopt.init(jp)},
               metadata={"num_layers": 1})
    jres = JaxTrainer(JCFG, _tcfg(jbase), mesh=jmesh.make_train_mesh("4x2"),
                      checkpoint_dir=_copy(init, tmp / "jax"),
                      log_fn=lambda *a: None).run()
    single = ProgressiveTrainer(CFG, _tcfg(base), device="cpu",
                                checkpoint_dir=_copy(init, tmp / "single"),
                                log_fn=lambda *a: None).run()
    moe_single = ProgressiveTrainer(CFG_MOE, _tcfg(base), device="cpu",
                                    log_fn=lambda *a: None).run()
    muon_single = ProgressiveTrainer(CFG, _muon_tcfg(), device="cpu",
                                     log_fn=lambda *a: None).run()
    single_seeded = ProgressiveTrainer(CFG, _tcfg(base), device="cpu",
                                       log_fn=lambda *a: None).run()
    fault_single = ProgressiveTrainer(
        CFG, _tcfg(base, checkpoint_every=4), device="cpu",
        checkpoint_dir=str(tmp / "faults_single"), log_fn=lambda *a: None,
        **FAULTS).run()

    cfg2 = CFG.with_depth(2)
    p2 = _params_np(cfg2)
    tokens = np.random.default_rng(0).integers(0, CFG.vocab_size, (4, 16))
    jsrv = {a: _jax_params(c) for a, c in JSRV.items()}
    srv = {a: jsrv[a][1] for a in SRV}
    prompts = {a: _prompts(c) for a, c in SRV.items()}

    def jax_serving():
        """The JAX package's own sharded serving on the same parameters:
        DP on 'host' (8 devices on 'data'), TP on 4x2."""
        dp = {a: JaxServeEngine(JSRV[a], jsrv[a][0],
                                mesh=jmesh.make_train_mesh("host"),
                                max_len=32).generate(prompts[a], GEN,
                                                     return_logits=True)
              for a in SRV}
        tp = JaxServeEngine(JSRV["dense"], jsrv["dense"][0],
                            mesh=jmesh.make_train_mesh("4x2"),
                            max_len=32).generate(prompts["dense"], GEN,
                                                 return_logits=True)
        return dp, tp
    # The source model's tokens and its copying_zeroL expansion, saved.
    dense2 = SRV["dense"].with_depth(2)
    src_np = _params_np(dense2, seed=1)
    src = bridge.unflatten({k: torch.from_numpy(v.copy())
                            for k, v in src_np.items()})
    grown = exp.expand_params(src, dense2, 4, "copying_zeroL")
    grown_dir = str(tmp / "grown")
    ckpt.save(grown_dir, 3, {"params": grown}, metadata={"num_layers": 4})

    s8 = [("parity", "train",
           dict(cfg=CFG, tcfg=_tcfg(base), mesh="4x2",
                ckpt_dir=_copy(init, tmp / "port_4x2"))),
          ("accum", "train",
           dict(cfg=CFG, tcfg=_tcfg(base, grad_accum=2), mesh="4x2",
                ckpt_dir=_copy(init, tmp / "port_accum"))),
          ("muon", "train", dict(cfg=CFG, tcfg=_muon_tcfg(), mesh="4x2"))]
    s8 += [(f"preserve_{m}", "expand_logits",
            dict(cfg=cfg2, target=4, method=m, params_np=p2, tokens=tokens,
                 mesh="4x2")) for m in ("zero", "copying_zeroL")]
    s8 += [(f"os_{pol}", "expand_state",
            dict(cfg=cfg2, target=4, method="copying_stack", policy=pol,
                 params_np=p2, mesh="4x2"))
           for pol in ("inherit", "copy", "reset")]
    s8 += [("save_sync", "save_state",
            dict(cfg=cfg2, params_np=p2, mesh="4x2",
                 directory=str(tmp / "sync"), step=7)),
           ("save_async", "save_state",
            dict(cfg=cfg2, params_np=p2, mesh="4x2",
                 directory=str(tmp / "async"), step=7, use_async=True)),
           ("moe", "train", dict(cfg=CFG_MOE, tcfg=_tcfg(base), mesh="4x2",
                                 layout="fsdp")),
           ("tp_serve", "serve",
            dict(cfg=SRV["dense"], params_np=srv["dense"],
                 prompts=prompts["dense"], num_tokens=GEN, mesh="4x2"))]
    r8 = mesh_lib.spawn(mesh_runs.run, 8, (s8, "cpu"), timeout_s=600)

    s4 = [("restored", "restore_state",
           dict(cfg=cfg2, mesh="2x2", directory=str(tmp / "sync"), step=7))]
    s4 += [(f"dp_{a}", "serve",
            dict(cfg=SRV[a], params_np=srv[a], prompts=prompts[a],
                 num_tokens=GEN, mesh="host")) for a in SRV]
    s4 += [("faults", "train",
            dict(cfg=CFG, tcfg=_tcfg(base, checkpoint_every=4), mesh="2x2",
                 ckpt_dir=str(tmp / "faults_mesh"), **FAULTS)),
           ("crash", "train",
            dict(cfg=CFG, tcfg=_tcfg(base, checkpoint_every=2), mesh="2x2",
                 ckpt_dir=str(tmp / "crash"), expect_crash=True,
                 faults="train.iter:8:crash")),
           ("resumed", "train",
            dict(cfg=CFG, tcfg=_tcfg(base, checkpoint_every=2), mesh="2x2",
                 ckpt_dir=str(tmp / "crash")))]
    s4 += [("grown", "serve",
            dict(cfg=SRV["dense"], params_np=None,
                 prompts=prompts["dense"], num_tokens=GEN, mesh="host",
                 ckpt_dir=grown_dir))]
    # The JAX serving runs in this process while the 4 ranks run in theirs.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_refs = pool.submit(jax_serving)
        r4 = mesh_lib.spawn(mesh_runs.run, 4, (s4, "cpu"), timeout_s=600)
        jax_dp, jax_tp = jax_refs.result()
    print("PROFILE", r8[0]["_seconds"], r4[0]["_seconds"])
    return dict(tmp=tmp, jres=jres, single=single, moe_single=moe_single,
                muon_single=muon_single, fault_single=fault_single,
                single_seeded=single_seeded,
                p2=p2, tokens=tokens, srv=srv, prompts=prompts,
                jax_dp=jax_dp, jax_tp=jax_tp,
                src=(dense2, src_np), r8=r8, r4=r4)


def _same_on_every_rank(ranks, name, key="history"):
    """Every rank's ``key`` equal to rank 0's (a NaN equal to a NaN)."""
    def text(r):
        return json.dumps(r[name][key], sort_keys=True)
    for r in ranks[1:]:
        assert text(r) == text(ranks[0])


def test_sharded_matches_jax_4x2_through_tau(world):
    """The port's 4x2 run and the JAX 4x2 run from the same parameters:
    the same expansion step, losses up to τ within 1e-4 (the fresh blocks
    are each framework's own draws); against the port on one device
    within 1e-4 through the end.  Every rank holds the same history."""
    r8 = world["r8"]
    _same_on_every_rank(r8, "parity")
    h = r8[0]["parity"]["history"]
    jh = world["jres"].history
    assert h["expansion_steps"] == jh["expansion_steps"] == [TAU_STEP]
    assert r8[0]["parity"]["final_layers"] == 2
    assert h["step"] == jh["step"] == list(range(12))
    np.testing.assert_allclose(h["loss"][:TAU_STEP], jh["loss"][:TAU_STEP],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(h["loss"], world["single"].history["loss"],
                               rtol=0, atol=1e-4)


def test_grad_accum_matches_full_batch_on_mesh(world):
    r8 = world["r8"]
    _same_on_every_rank(r8, "accum")
    np.testing.assert_allclose(r8[0]["accum"]["history"]["loss"],
                               r8[0]["parity"]["history"]["loss"],
                               rtol=0, atol=1e-4)


def test_muon_clip_remat_on_mesh_matches_one_device(world):
    r8 = world["r8"]
    _same_on_every_rank(r8, "muon")
    h = r8[0]["muon"]["history"]
    single = world["muon_single"].history
    assert h["expansion_steps"] == single["expansion_steps"] == [TAU_STEP]
    np.testing.assert_allclose(h["loss"], single["loss"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", ["zero", "copying_zeroL"])
def test_function_preserving_expansion_on_mesh(world, method):
    got = world["r8"][0][f"preserve_{method}"]
    assert got["after"].shape == got["before"].shape == (4, 16, 64)
    np.testing.assert_allclose(got["after"], got["before"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("policy", ["inherit", "copy", "reset"])
def test_expand_opt_state_on_mesh_matches_one_device(world, policy):
    """The sharded expansion of params and AdamW state equals the
    single-device one bit for bit (fresh blocks drawn whole, then sliced),
    and every moment shard has its param shard's shape."""
    cfg2 = CFG.with_depth(2)
    params = bridge.unflatten({k: torch.from_numpy(v.copy())
                               for k, v in world["p2"].items()})
    opt = make_optimizer(base.OptimizerConfig(name="adamw"))
    state = opt.init(params)
    for k in ("m", "v"):
        state[k] = bridge.unflatten({p: x + 0.5 for p, x in
                                     bridge.flatten(state[k]).items()})
    fn = exp.make_expand_fn(cfg2, 4, "copying_stack",
                            opt_state_policy=policy)
    new_p, new_os = fn(params, state, torch.Generator().manual_seed(3))
    want = {"params": new_p, "m": new_os["m"], "v": new_os["v"]}
    for r in world["r8"]:
        got = r[f"os_{policy}"]
        assert got["same_shapes"]
        assert got["step"] == int(new_os["step"])
        for tree, leaves in got["trees"].items():
            ref = bridge.flatten(want[tree])
            assert sorted(leaves) == sorted(ref)
            for key, x in leaves.items():
                np.testing.assert_array_equal(x, ref[key].numpy(),
                                              err_msg=f"{tree}{key}")
    if policy == "reset":
        assert all(float(np.abs(x).max()) == 0.0 for x in
                   world["r8"][0]["os_reset"]["trees"]["m"].values())


def test_checkpoint_4x2_restores_at_2x2_and_without_mesh(world):
    """Saved from 4x2 shards (rank 0 writes whole leaves), restored as 2x2
    shards (each the shape its spec gives) and without a mesh: the trees
    equal the saved params and each other exactly."""
    tmp = world["tmp"]
    cfg2 = CFG.with_depth(2)
    like_p = registry.get_model(cfg2).init(None, cfg2, device="meta")
    opt = make_optimizer(base.OptimizerConfig(name="adamw"))
    whole = bridge.flatten(ckpt.restore(
        str(tmp / "sync"), 7, {"params": like_p,
                               "opt_state": opt.init(like_p)}))
    for key, x in world["p2"].items():
        np.testing.assert_array_equal(whole["['params']" + key], x)
    assert ckpt.load_metadata(str(tmp / "sync"), 7)["num_layers"] == 2
    for r in world["r4"]:
        got = r["restored"]
        assert got["shard_shapes_ok"]
        assert sorted(got["tree"]) == sorted(whole)
        for key, x in got["tree"].items():
            np.testing.assert_array_equal(x, whole[key], err_msg=key)


def test_mesh_save_gathers_to_rank_0_alone(world):
    """A save on the mesh leaves the gathered leaves with rank 0, the
    writer, and nothing with the other ranks."""
    for name in ("save_sync", "save_async"):
        held = [r[name]["holds_gathered"] for r in world["r8"]]
        assert held == [True] + [False] * 7, (name, held)
        assert [r[name]["saved"] for r in world["r8"]] == held


def test_async_save_on_mesh_matches_sync(world):
    tmp = world["tmp"]
    a = np.load(tmp / "async" / "step_000000007" / "arrays.npz")
    s = np.load(tmp / "sync" / "step_000000007" / "arrays.npz")
    assert sorted(a.files) == sorted(s.files)
    for f in s.files:
        np.testing.assert_array_equal(a[f], s[f])
    assert ckpt.load_metadata(str(tmp / "async"), 7) == \
        ckpt.load_metadata(str(tmp / "sync"), 7)


def test_moe_fsdp_layout_matches_single_device(world):
    """MoE under the pure-ZeRO-3 layout (batch over every axis, no tensor or
    expert parallelism: every leaf gathered whole, every rank running
    every expert, as the reference's fsdp layout does; the tp layout's
    expert parallelism is ``tests/test_torch_mesh_layers.py``'s): the
    single-device loss trajectory within 1e-4, through the expansion."""
    r8 = world["r8"]
    _same_on_every_rank(r8, "moe")
    h = r8[0]["moe"]["history"]
    single = world["moe_single"].history
    assert h["expansion_steps"] == single["expansion_steps"] == [TAU_STEP]
    np.testing.assert_allclose(h["loss"], single["loss"], rtol=0, atol=1e-4)


def test_fault_plane_on_mesh_agrees_across_ranks(world):
    """Every rank retries the same faults and skips the same NaN step as
    one device under the same plan (the site decisions all-reduced, the
    checkpoint write's outcome rank 0's), with losses within 1e-4; a
    crash unwinds every rank and the restart resumes to one device's
    uninterrupted losses."""
    r4 = world["r4"]
    _same_on_every_rank(r4, "faults")
    single = world["fault_single"]
    got = r4[0]["faults"]
    assert got["history"]["skipped_steps"] == \
        single.history["skipped_steps"] == [4]
    for key in ("retries", "ckpt_failures", "skipped_steps"):
        assert all(r["faults"]["fault_stats"][key] == single.fault_stats[key]
                   for r in r4), key
    np.testing.assert_allclose(got["history"]["loss"],
                               single.history["loss"], rtol=0, atol=1e-4)
    assert all(r["crash"]["crashed"] for r in r4)
    _same_on_every_rank(r4, "resumed")
    np.testing.assert_allclose(r4[0]["resumed"]["history"]["loss"],
                               world["single_seeded"].history["loss"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["dense", "mamba", "rwkv"])
def test_dp_greedy_serving_matches_one_device(world, arch):
    """Rows over 'data' (4 ranks, 2 rows each): tokens byte-identical to
    one device, logits within 1e-4, gathered to every rank."""
    want = _solo(SRV[arch], world["srv"][arch], world["prompts"][arch])
    for r in world["r4"]:
        got = r[f"dp_{arch}"]
        np.testing.assert_array_equal(got["tokens"], want.tokens)
        np.testing.assert_allclose(got["logits"], want.logits, rtol=0,
                                   atol=1e-4)


def test_tp_greedy_serving_matches_one_device(world):
    """4x2: heads, d_ff and vocab over 'model' (each rank's cache holds its
    KV head): tokens equal, logits within 1e-4."""
    want = _solo(SRV["dense"], world["srv"]["dense"],
                 world["prompts"]["dense"])
    for r in world["r8"]:
        got = r["tp_serve"]
        np.testing.assert_array_equal(got["tokens"], want.tokens)
        np.testing.assert_allclose(got["logits"], want.logits, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["dense", "mamba", "rwkv"])
def test_dp_greedy_serving_matches_jax_host_mesh(world, arch):
    """The port's DP serving (4 ranks on 'data') against the JAX package's
    on its 8-device 'host' mesh, from the same parameters: tokens equal,
    logits within 1e-4."""
    want = world["jax_dp"][arch]
    for r in world["r4"]:
        got = r[f"dp_{arch}"]
        np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
        np.testing.assert_allclose(got["logits"], np.asarray(want.logits),
                                   rtol=0, atol=1e-4)


def test_tp_greedy_serving_matches_jax_4x2(world):
    """The port's 4x2 TP serving against the JAX package's 4x2 serving
    from the same parameters: tokens equal, logits within 1e-4."""
    want = world["jax_tp"]
    for r in world["r8"]:
        got = r["tp_serve"]
        np.testing.assert_array_equal(got["tokens"], np.asarray(want.tokens))
        np.testing.assert_allclose(got["logits"], np.asarray(want.logits),
                                   rtol=0, atol=1e-4)


def test_expanded_checkpoint_serves_source_tokens_on_dp_mesh(world):
    """A copying_zeroL 2 -> 4 expansion, checkpointed and served on the DP
    mesh: the source model's greedy tokens on one device."""
    dense2, src_np = world["src"]
    want = _solo(dense2, src_np, world["prompts"]["dense"])
    for r in world["r4"]:
        np.testing.assert_array_equal(r["grown"]["tokens"], want.tokens)


def test_mesh_spec_must_match_world_and_mesh_cli_refusals(capfd):
    """A spec whose size is not the world's raises naming both (no process
    group is made for it); the serve CLI serves continuous batching over
    paged KV with the prefix cache on a two-rank 'host' mesh to rank 0's
    report, and serves there under ``--faults`` with ``--snapshot-every``
    (once refused, naming ROADMAP item A22): rank 0 prints the
    ``lifecycle:`` line once, with the retried fault."""
    with pytest.raises(ValueError, match="has 4 ranks; the world has 1"):
        mesh_lib.make_train_mesh("2x2")
    with pytest.raises(ValueError, match="has 8 ranks; the world has 1"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "4x2"])
    capfd.readouterr()
    launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "host",
                       "--nproc", "2", "--continuous", "--paged",
                       "--prefix-cache"])
    lines = capfd.readouterr().out.splitlines()
    report = [ln for ln in lines if ln.startswith("arch=")]
    assert len(report) == 1 and "mesh=host paged" in report[0], lines
    assert lines[-1].startswith("prefix cache: hits="), lines
    assert sum(ln.startswith("  req ") for ln in lines) == 8, lines
    launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "host",
                       "--nproc", "2", "--continuous", "--paged",
                       "--faults", "engine.decode:1", "--snapshot-every",
                       "1"])
    lines = capfd.readouterr().out.splitlines()
    life = [ln for ln in lines if ln.startswith("lifecycle:")]
    assert len(life) == 1 and "limit=8" in life[0], lines
    assert "retries=1 " in life[0], lines
    assert sum(ln.startswith("  req ") for ln in lines) == 8, lines

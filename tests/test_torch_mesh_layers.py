"""Expert parallelism and the tensor-parallel Mamba, RWKV6 and MLA layers
of the port on a device mesh, over gloo ranks started by the port's own
launcher (``repro_torch.launch.mesh.spawn``), against the JAX package on
the same parameters.

Under the ``tp`` layout each 'model' rank runs its E/model experts, its
d_inner/model Mamba channels, its H/model RWKV6 heads and its KV/model
MLA heads (``distributed.context``: ``moe_ep``, ``mamba_tp``,
``rwkv_tp``, ``mla_tp``).  Four smoke configs: an MoE (8 experts, top-2,
``aux_loss_coef`` 1e-2 and ``router_zloss`` 1e-3, the defaults), MLA with
a shared expert (``deepseekv3-0.3b``'s smoke config), Mamba and RWKV6;
plus the MoE with 6 experts on a 1x4 mesh, where 6 does not divide 4.
Each mesh shape is spawned once (1x2 and 2x2 with the 1x4 scenarios at
once, then 4x2), every scenario of that shape in one spawn
(``tests/mesh_runs.py``, which imports no JAX), one torch thread a rank;
the JAX references run in this process meanwhile.  Held:

  * losses through a 1 -> 2 layer ``copying_stack`` expansion on 1x2 and
    4x2, from one step-0 checkpoint of the JAX model's parameters,
    against the JAX trainer's on its 8-device 4x2 mesh: 1e-4 (the
    reference's contract for its sharded runs);
  * every leaf's gradient of one loss (aux and z-loss included) on 1x2,
    2x2 and 4x2 against ``jax.grad`` on one device: 1e-5 absolute plus
    1e-4 relative, as the single-device tests hold it; on 2x2 also with
    ``moe_fsdp='ef'`` (expert dim on 'model', expert-ffn dim on 'data');
  * greedy ``generate`` and continuous paged serving with the prefix
    cache and speculation on 1x2, 2x2 and 4x2, against the JAX package's
    solo generation (the MoE configs served dropless):
    tokens equal, or first different where the reference's top-2 logits
    lie within 1e-4 (a near-tie the partial sums may flip); logits 1e-4;
  * the gather counter: ``materialize`` gathers over 'model' only the
    four small leaves the rule splits off the compute split (``router``,
    ``x_proj``, ``w_a``, ``wkv_a``), never an expert stack or a Mamba,
    RWKV6 or MLA projection, and each layer sees its leaves at the
    rank's shapes;
  * Muon orthogonalizes E/model experts a rank, and its MoE losses on
    1x2 and 4x2 are within 1e-4 of the JAX trainer's Muon run on 4x2;
  * each rank's recurrent caches hold its channels and heads, MLA's
    latent caches the whole latent;
  * 6 experts over 4 'model' ranks compute whole (the reference's
    ``divides`` rule leaves the stacks unsplit over 'model'): gradients
    and greedy tokens equal one device's;
  * a checkpoint written on 1x2 and on 4x2 restores under ``mesh=None``
    and, through the JAX checkpointer and ``bridge.params_from_jax``,
    to the run's final params bit for bit (the packed ``in_proj`` and
    ``wkv_b`` unpacked into the reference's layout).
"""
import concurrent.futures
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro.optim.base import make_optimizer as jmake_optimizer
from repro.train.engine import ProgressiveTrainer as JaxTrainer
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
import mesh_runs

ARCHS = ("moe", "mla", "mamba", "rwkv")
LOSS_TOL = 1e-4
GRAD_TOL = 1e-5            # absolute, plus 1e-4 relative
LOGIT_TOL = 1e-4
GEN = 6
MAX_LEN = 32
STEPS = 8
# Leaves the rule splits over 'model' along a dim that is not their
# layer's compute split: gathered whole (``distributed.context``).
SMALL = ("router", "x_proj", "w_a", "wkv_a")
# The large leaves a rank computes on its shard: never gathered over
# 'model' under the tp layout where their dim divides.
LOCAL = {"moe": ("w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo"),
         "mla": ("w_gate", "w_up", "w_down", "wq", "wkv_b", "wo"),
         "mamba": ("in_proj", "dt_proj", "out_proj"),
         "rwkv": ("w_r", "w_k", "w_v", "w_g", "w_b", "w_o", "cm_k", "cm_v")}
CSERVE = dict(paged=True, block_size=4, prefix_cache=True, spec_decode=True,
              gamma=2, draft_depth=1)


def _cfgs(mod, get_smoke):
    ssm = dict(family="ssm", num_layers=2, d_model=32, num_heads=4,
               num_kv_heads=4, d_ff=64, vocab_size=64, max_seq_len=64,
               attention="none", position="none")
    moe = mod.ModelConfig(name="ml-moe", family="moe", num_layers=2,
                          d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                          vocab_size=64, max_seq_len=64,
                          moe=mod.MoEConfig(num_experts=8, top_k=2))
    return {"moe": moe,
            "mla": get_smoke("deepseekv3-0.3b"),
            "mamba": mod.ModelConfig(name="ml-mamba",
                                     block_pattern=("mamba",),
                                     ssm=mod.SSMConfig(d_state=4), **ssm),
            "rwkv": mod.ModelConfig(name="ml-rwkv", norm="layernorm",
                                    block_pattern=("rwkv",),
                                    ssm=mod.SSMConfig(kind="rwkv6",
                                                      head_dim=16), **ssm),
            "moe6": dataclasses.replace(moe, name="ml-moe6", moe=(
                mod.MoEConfig(num_experts=6, top_k=2)))}


CFGS = _cfgs(base, configs.get_smoke_config)
JCFGS = _cfgs(jbase, jconfigs.get_smoke_config)


def _dropless(cfg):
    """An MoE served dropless (capacity E/top_k, as ``chip_smoke.py``
    phase 37 serves it): a chunked prefill and one piece route alike."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _tcfg(mod):
    return mod.TrainConfig(
        total_steps=STEPS, seq_len=16, global_batch=8, source_layers=1,
        optimizer=mod.OptimizerConfig(name="adamw", learning_rate=0.01),
        schedule=mod.ScheduleConfig(name="wsd"),
        expansions=(mod.ExpansionConfig(at_frac=0.5, target_layers=2,
                                        init="copying_stack"),),
        eval_every=10_000, checkpoint_every=10_000, log_every=1)


def _muon_tcfg(mod):
    return dataclasses.replace(_tcfg(mod), optimizer=mod.OptimizerConfig(
        name="muon_nsgd", learning_rate=0.01, grad_clip=0.05))


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_thread):
    """The JAX references (the 4x2 trainer, ``jax.grad`` and solo
    generation on one device) and the 1x2, 2x2 (with 1x4) and 4x2
    spawns."""
    tmp = tmp_path_factory.mktemp("layers")
    archs = ARCHS + ("moe6",)
    jp = {a: jax.device_get(jregistry.get_model(JCFGS[a]).init(
        jax.random.PRNGKey(1), JCFGS[a])) for a in archs}
    params = {a: {k: np.asarray(v) for k, v in bridge.flatten(jp[a]).items()}
              for a in archs}
    rng = np.random.default_rng(0)
    batch = {a: tuple(rng.integers(0, CFGS[a].vocab_size, (8, 16))
                      .astype(np.int32) for _ in range(2)) for a in archs}
    prompts = {a: rng.integers(0, CFGS[a].vocab_size, (4, 8))
               .astype(np.int32) for a in archs}
    reqs = {a: [dict(prompt=p, max_new_tokens=GEN)
                for p in (prompts[a][0], prompts[a][1], prompts[a][0],
                          prompts[a][2])] for a in ARCHS}
    # Step-0 checkpoints of the JAX model's parameters at depth 1, which
    # the JAX and the port trainers both resume from.
    # The MoE's Muon runs start from one with Muon's state.
    init = {}
    for a in ARCHS + ("muon_moe",):
        j1 = JCFGS[a.removeprefix("muon_")].with_depth(1)
        p1 = jregistry.get_model(j1).init(jax.random.PRNGKey(0), j1)
        opt = jmake_optimizer((_muon_tcfg(jbase) if a == "muon_moe" else
                               _tcfg(jbase)).optimizer)
        init[a] = tmp / f"init_{a}"
        jckpt.save(str(init[a]), 0, {"params": p1,
                                     "opt_state": opt.init(p1)},
                   metadata={"num_layers": 1})

    def jax_refs():
        out = {}
        for a in ARCHS:
            out[f"train_{a}"] = JaxTrainer(
                JCFGS[a], _tcfg(jbase), mesh=jmesh.make_train_mesh("4x2"),
                checkpoint_dir=_copy(init[a], tmp / f"jax_{a}"),
                log_fn=lambda *a: None).run().history["loss"]
        out["train_muon_moe"] = JaxTrainer(
            JCFGS["moe"], _muon_tcfg(jbase),
            mesh=jmesh.make_train_mesh("4x2"),
            checkpoint_dir=_copy(init["muon_moe"], tmp / "jax_muon_moe"),
            log_fn=lambda *a: None).run().history["loss"]
        for a in archs:
            toks, labels = batch[a]
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, c=JCFGS[a]: jtr.lm_loss(p, c, toks, labels),
                has_aux=True))(jp[a])
            out[f"grads_{a}"] = (float(loss), {
                k: np.asarray(v) for k, v in
                bridge.flatten(jax.device_get(grads)).items()})
            res = JaxServeEngine(_dropless(JCFGS[a]), jp[a],
                                 mesh=jmesh.single_device_mesh(),
                                 max_len=MAX_LEN).generate(
                prompts[a], GEN, return_logits=True)
            out[f"solo_{a}"] = (np.asarray(res.tokens),
                                np.asarray(res.logits))
        return out

    def grads(a, mesh, **kw):
        return (f"grads_{a}", "layer_grads", dict(
            cfg=CFGS[a], params_np=params[a], tokens=batch[a][0],
            labels=batch[a][1], mesh=mesh, **kw))

    def serve(a, mesh):
        return (f"serve_{a}", "serve", dict(
            cfg=_dropless(CFGS[a]), params_np=params[a], prompts=prompts[a],
            num_tokens=GEN, mesh=mesh, max_len=MAX_LEN))

    def train(a, mesh, **kw):
        return (f"train_{a}", "train", dict(
            cfg=CFGS[a], tcfg=_tcfg(base), mesh=mesh, want_params=True,
            ckpt_dir=_copy(init[a], tmp / f"{mesh}_{a}"), **kw))

    def cserve(a, mesh):
        return (f"cserve_{a}", "cserve", dict(
            cfg=_dropless(CFGS[a]), params_np=params[a], requests=reqs[a],
            mesh=mesh, max_len=MAX_LEN, max_batch=2, engine_kw=CSERVE,
            sched_kw=dict(chunk_len=4)))

    s2 = [f(a, "1x2") for a in ARCHS for f in (grads, serve, train, cserve)]
    s2 += [(f"caches_{a}", "cache_shapes", dict(
               cfg=CFGS[a], params_np=params[a], mesh="1x2",
               max_len=MAX_LEN))
           for a in ARCHS]
    def muon(mesh, name="muon_moe", **kw):
        return (name, "train", dict(
            cfg=CFGS["moe"], tcfg=_muon_tcfg(base), mesh=mesh,
            ns_shapes=True, ckpt_dir=_copy(init["muon_moe"],
                                           tmp / f"{name}_{mesh}"), **kw))

    s2 += [muon("1x2")]
    s4 = [f(a, "2x2") for a in ARCHS for f in (grads, serve, cserve)]
    s4 += [grads("moe6", "1x4"), serve("moe6", "1x4")]
    s4 += [("grads_moe_ef",) + grads("moe", "2x2", moe_fsdp="ef")[1:],
           muon("2x2", "muon_moe_ef", moe_fsdp="ef")]
    s8 = [f(a, "4x2") for a in ARCHS for f in (grads, serve, train, cserve)]
    s8 += [muon("4x2")]
    # The JAX references run in this process meanwhile; the 8-rank spawn
    # waits for the other two (at most 8 rank processes at once).
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(jax_refs)
        f2 = pool.submit(mesh_lib.spawn, mesh_runs.run, 2, (s2, "cpu"),
                         timeout_s=900)
        r4 = mesh_lib.spawn(mesh_runs.run, 4, (s4, "cpu"), timeout_s=900)
        r2 = f2.result()
        r8 = mesh_lib.spawn(mesh_runs.run, 8, (s8, "cpu"), timeout_s=900)
        jax_out = ref.result()
    # One device's port runs: Muon on the MoE, the 6-expert gradients and
    # greedy tokens.
    none = {"muon_moe": mesh_runs.train(
                CFGS["moe"], _muon_tcfg(base), None, ns_shapes=True,
                ckpt_dir=_copy(init["muon_moe"], tmp / "muon_none")),
            "grads_moe6": mesh_runs.layer_grads(
                CFGS["moe6"], params["moe6"], *batch["moe6"], None),
            "serve_moe6": mesh_runs.serve(
                _dropless(CFGS["moe6"]), params["moe6"], prompts["moe6"],
                GEN, None, max_len=MAX_LEN)}
    print("PROFILE", r2[0]["_seconds"], r4[0]["_seconds"],
          r8[0]["_seconds"])
    return dict(tmp=tmp, params=params, jax=jax_out, none=none,
                meshes={"1x2": r2, "2x2": r4, "4x2": r8})


def _near_tie_equal(got, want, logits, label):
    """Greedy streams ``got`` and ``want`` (rows of tokens) equal, or, row
    by row, first different where the reference's logits at that step
    have a top-2 gap within ``LOGIT_TOL``: a near-tie a sum in another
    order may flip (after it the streams may part)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size == 0:
            continue
        t = int(diff[0]) - (want.shape[1] - logits.shape[1])
        assert t >= 0, (label, b, "prompt tokens differ")
        top2 = np.sort(logits[b, t])[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (label, b, t, top2)


def _ranks_alike(ranks, name, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(np.asarray(r[name][key]),
                                      np.asarray(ranks[0][name][key]))


@pytest.mark.parametrize("mesh", ["1x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_through_expansion_match_jax_4x2(world, arch, mesh):
    """The port's tp run from the JAX parameters' step-0 checkpoint
    against the JAX trainer's 4x2 run: every step's loss within 1e-4,
    through the 1 -> 2 expansion at step 4; every rank alike."""
    ranks = world["meshes"][mesh]
    h = ranks[0][f"train_{arch}"]["history"]
    for r in ranks[1:]:
        assert r[f"train_{arch}"]["history"]["loss"] == h["loss"]
    assert h["expansion_steps"] == [STEPS // 2]
    assert ranks[0][f"train_{arch}"]["final_layers"] == 2
    np.testing.assert_allclose(h["loss"], world["jax"][f"train_{arch}"],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_gradients_match_jax_grad(world, arch, mesh):
    """One loss (aux and z-loss nonzero where there is an MoE) and every
    leaf's gradient, gathered whole, against ``jax.grad`` on one device;
    the same on every rank."""
    ranks = world["meshes"][mesh]
    got = ranks[0][f"grads_{arch}"]
    loss, want = world["jax"][f"grads_{arch}"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want)
    for key, g in want.items():
        np.testing.assert_allclose(got["grads"][key], g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=f"{mesh} {key}")
    for r in ranks[1:]:
        for key, g in got["grads"].items():
            np.testing.assert_array_equal(r[f"grads_{arch}"]["grads"][key],
                                          g)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_gathers_only_the_small_leaves(world, arch, mesh):
    """``materialize`` gathers over 'model' only the leaves in ``SMALL``;
    every expert stack, Mamba, RWKV6 and MLA projection (and attention's
    and the dense MLP's) stays on its rank's shard, at its shard's
    shape."""
    cfg = CFGS[arch]
    for r in world["meshes"][mesh]:
        got = r[f"grads_{arch}"]
        names = [bridge.parse_keystr(k)[-1] for k in got["model_gathers"]]
        assert set(names) <= set(SMALL), names
        assert set(names) == {n for n in SMALL if any(
            bridge.parse_keystr(k)[-1] == n for k in got["used_shapes"])}
        for key, shape in got["used_shapes"].items():
            path = bridge.parse_keystr(key)
            if path[-1] not in LOCAL[arch]:
                continue
            whole = world["params"][arch][key].shape
            split = [d for d in range(len(shape)) if shape[d] != whole[d]]
            assert len(split) == 1, (key, shape, whole)
            assert whole[split[0]] == 2 * shape[split[0]], (key, shape)
    if cfg.moe is not None:
        used = world["meshes"][mesh][0][f"grads_{arch}"]["used_shapes"]
        stack = used["['blocks']['layer0']['moe']['w_up']"]
        assert stack[1] == cfg.moe.num_experts // 2


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax_solo(world, arch, mesh):
    """Greedy ``generate`` on the mesh (MoE dropless) against the JAX
    package's solo generation: the near-tie rule for tokens, logits up to
    the first different token within 1e-4; every rank alike."""
    ranks = world["meshes"][mesh]
    tokens, logits = world["jax"][f"solo_{arch}"]
    got = ranks[0][f"serve_{arch}"]
    _ranks_alike(ranks, f"serve_{arch}", "tokens")
    _near_tie_equal(got["tokens"], tokens, logits, f"{mesh} {arch}")
    if np.array_equal(got["tokens"], tokens):
        np.testing.assert_allclose(got["logits"], logits, rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_paged_streams_match_jax_solo(world, arch, mesh):
    """Continuous serving over paged KV with the prefix cache and
    speculation (depth-1 draft, γ 2), 4 requests into 2 slots: each
    request's stream against its JAX solo stream (near-tie rule), the
    repeated prompt a prefix hit, every rank alike."""
    ranks = world["meshes"][mesh]
    tokens, logits = world["jax"][f"solo_{arch}"]
    got = ranks[0][f"cserve_{arch}"]
    rows = (0, 1, 0, 2)
    for r in ranks[1:]:
        assert [list(x["tokens"]) for x in r[f"cserve_{arch}"]["results"]] \
            == [list(x["tokens"]) for x in got["results"]]
    for i, res in enumerate(got["results"]):
        assert res["finish_reason"] == "limit"
        b = rows[i]
        _near_tie_equal(np.asarray(res["tokens"])[None], tokens[b:b + 1],
                        logits[b:b + 1], f"{mesh} {arch} request {i}")
    assert got["stats"]["prefix"]["prefix_hits"] >= 1
    assert got["stats"]["spec"]["spec_rounds"] > 0


def test_muon_orthogonalizes_a_ranks_experts(world):
    """Muon under expert parallelism: every expert stack reaches
    ``orthogonalize`` with E/model experts on each rank (the other
    matrices whole), and the losses through the expansion, from one
    step-0 checkpoint, are within 1e-4 of the JAX trainer's Muon run on
    its 4x2 mesh and of one device's; on 2x2 also with ``moe_fsdp='ef'``,
    where Muon gathers each expert's ffn dim over 'data' alone."""
    E = CFGS["moe"].moe.num_experts
    solo = world["none"]["muon_moe"]
    n_solo = [s for s in solo["ns_shapes"] if len(s) == 4]
    assert n_solo and all(s[1] == E for s in n_solo)
    for mesh, name in (("1x2", "muon_moe"), ("4x2", "muon_moe"),
                       ("2x2", "muon_moe_ef")):
        for r in world["meshes"][mesh]:
            got = r[name]
            stacks = [s for s in got["ns_shapes"] if len(s) == 4]
            assert len(stacks) == len(n_solo)
            assert all(s[1] == E // 2 for s in stacks), stacks
            others = sorted(s for s in got["ns_shapes"] if len(s) != 4)
            assert others == sorted(s for s in solo["ns_shapes"]
                                    if len(s) != 4)
            np.testing.assert_allclose(got["history"]["loss"],
                                       world["jax"]["train_muon_moe"],
                                       rtol=0, atol=LOSS_TOL)
            np.testing.assert_allclose(got["history"]["loss"],
                                       solo["history"]["loss"], rtol=0,
                                       atol=LOSS_TOL)


def test_moe_ef_layout_keeps_experts_on_model(world):
    """``moe_fsdp='ef'`` on 2x2: each rank holds E/2 experts ('model')
    and a half of each expert's ffn dim ('data'); ``materialize`` gathers
    the stacks over 'data' alone, so the layer runs E/2 whole experts,
    and every leaf's gradient is within the stated tolerance of
    ``jax.grad``."""
    cfg = CFGS["moe"]
    E, F = cfg.moe.num_experts, cfg.moe.expert_ffn_dim or cfg.d_ff
    loss, want = world["jax"]["grads_moe"]
    for r in world["meshes"]["2x2"]:
        got = r["grads_moe_ef"]
        names = [bridge.parse_keystr(k)[-1] for k in got["model_gathers"]]
        assert set(names) <= set(SMALL), names
        for name in ("w_gate", "w_up", "w_down"):
            key = f"['blocks']['layer0']['moe']['{name}']"
            shape = got["used_shapes"][key]
            assert shape[1] == E // 2, (key, shape)
            assert F in shape[-2:], (key, shape)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert sorted(got["grads"]) == sorted(want)
        for key, g in want.items():
            np.testing.assert_allclose(got["grads"][key], g, atol=GRAD_TOL,
                                       rtol=1e-4, err_msg=f"ef {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_and_latent_caches_hold_the_ranks_share(world, arch):
    """1x2: a Mamba layer's conv and SSM states hold d_inner/2 channels,
    an RWKV6 layer's WKV state H/2 heads (its token-shift rows whole);
    MLA's contiguous latent and its latent pages are whole; the B=1
    prefill carry likewise."""
    cfg = CFGS[arch]
    for r in world["meshes"]["1x2"]:
        got = r[f"caches_{arch}"]
        lay = "['layer0']"
        if arch == "mamba":
            di, N = 2 * cfg.d_model, cfg.ssm.d_state
            for kind, B in (("contiguous", 2), ("paged", 2), ("carry", 1)):
                assert got[kind][lay + "['conv']"] == (2, B, 3, di // 2)
                assert got[kind][lay + "['ssm']"] == (2, B, di // 2, N)
        elif arch == "rwkv":
            H, hd = cfg.d_model // 16, 16
            for kind, B in (("contiguous", 2), ("paged", 2), ("carry", 1)):
                assert got[kind][lay + "['wkv']"] == (2, B, H // 2, hd, hd)
                assert got[kind][lay + "['tm_x']"] == (2, B, cfg.d_model)
        elif arch == "mla":
            r_ = cfg.mla_kv_lora_rank
            assert got["contiguous"][lay + "['latent']"] == (2, 2, MAX_LEN,
                                                             r_)
            assert got["paged"][lay + "['latent_pages']"] == (2, 9, 4, r_)
        else:
            KV = cfg.num_kv_heads
            assert got["contiguous"][lay + "['k']"][3] == KV // 2


def test_experts_that_do_not_divide_model_compute_whole(world):
    """6 experts over 4 'model' ranks (1x4): the reference's ``divides``
    rule leaves the expert stacks (and the router) unsplit over 'model',
    and every rank runs every expert; gradients within 1e-5 of one
    device's and of ``jax.grad``, greedy tokens equal one device's."""
    for r in world["meshes"]["2x2"]:
        got = r["grads_moe6"]
        for name in ("w_gate", "w_up", "w_down", "router"):
            key = f"['blocks']['layer0']['moe']['{name}']"
            assert got["used_shapes"][key] == \
                world["params"]["moe6"][key].shape, key
        loss, want = world["jax"]["grads_moe6"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for key, g in world["none"]["grads_moe6"]["grads"].items():
            np.testing.assert_allclose(got["grads"][key], g, atol=GRAD_TOL,
                                       rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(got["grads"][key], want[key],
                                       atol=GRAD_TOL, rtol=1e-4,
                                       err_msg=key)
        np.testing.assert_array_equal(r["serve_moe6"]["tokens"],
                                      world["none"]["serve_moe6"]["tokens"])


@pytest.mark.parametrize("mesh", ["1x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_checkpoint_restores_bit_for_bit(world, arch, mesh):
    """The run's final checkpoint (rank 0 writes whole leaves, the packed
    ``in_proj`` and ``wkv_b`` unpacked) restored under ``mesh=None`` and
    read by the JAX checkpointer through ``bridge.params_from_jax``: both
    equal the run's final params, gathered whole, bit for bit."""
    cfg2 = CFGS[arch].with_depth(2)
    directory = str(world["tmp"] / f"{mesh}_{arch}")
    like_p = registry.get_model(cfg2).init(None, cfg2, device="meta")
    opt = make_optimizer(base.OptimizerConfig(name="adamw"))
    whole = bridge.flatten(ckpt.restore(directory, STEPS, {
        "params": like_p, "opt_state": opt.init(like_p)}))
    j2 = JCFGS[arch].with_depth(2)
    jlike = jax.eval_shape(lambda: jregistry.get_model(j2).init(
        jax.random.PRNGKey(0), j2))
    via_jax = bridge.flatten(bridge.params_from_jax(
        jckpt.restore_subtree(directory, STEPS, jlike, "params")))
    final = world["meshes"][mesh][0][f"train_{arch}"]["params"]
    assert sorted(via_jax) == sorted(final)
    for key, x in final.items():
        np.testing.assert_array_equal(whole["['params']" + key], x,
                                      err_msg=key)
        np.testing.assert_array_equal(bridge.to_numpy(via_jax[key]), x,
                                      err_msg=key)

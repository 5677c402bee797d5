"""Tensor-parallel attention whose KV heads do not divide 'model', and the
tensor-parallel encoder-decoder, on gloo ranks started by the port's own
launcher (``repro_torch.launch.mesh.spawn``), against the JAX package on
the same parameters.

Under the ``tp`` layout, where 'model' (m) divides the H query heads and
is a multiple of the KV heads, each rank runs its H/m query heads over
the one KV head they read (``distributed.context.kv_shared``): ``wq`` and
``wo`` are its column and row shards, ``wk`` and ``wv`` are gathered and
cut to that head's columns, and its caches, pool pages and rings hold
that head.  The encoder-decoder takes every rule: self- and
cross-attention on the rank's heads, the feed-forward on its d_ff
columns, the tied embedding and head on its vocab rows.  Held:

  * a truth table of ``attn_tp``, ``kv_shared``, ``tp_local_cfg`` and
    ``keeps_model_split`` over every ported config at m = 2, 4 and 16,
    with no spawn; a leaf kept split is one the reference's rule splits
    over 'model';
  * ``starcoder2-3b`` and ``qwen2-vl-2b`` smoke configs (4 query heads,
    2 KV heads), and ``gemma2-9b``'s with 2 KV heads (its sliding-window
    rings and softcaps), at 1x4: every leaf's gradient against ``jax.grad`` on one
    device (1e-5 absolute plus 1e-4 relative), flash called on 1 query
    head over 1 KV head, ``wk``/``wv`` the only leaves gathered over
    'model'; three steps' losses against ``mesh=None``'s and the JAX
    trainer's on its 1x4 mesh from one step-0 checkpoint (1e-4); greedy
    ``generate`` and continuous paged serving (prefix cache, speculation)
    against the JAX package's solo generation (tokens equal or first
    different at a top-2 gap within 1e-4; logits 1e-4); each rank's
    contiguous cache, pool pages, rings and prefill carry holding one KV
    head;
    the run's final checkpoint restored under ``mesh=None`` and through
    the JAX checkpointer bit for bit;
  * ``whisper-base``'s smoke config at 1x2 and 2x2: every leaf's gradient
    of the loss with frames against ``jax.grad`` (the MLPs, self- and
    cross-attention and the vocabulary on the rank's share, nothing
    gathered over 'model'), three Muon-NSGD steps' losses against
    ``mesh=None``'s and the JAX package's ``make_train_step`` on one
    device, greedy decoding through ``encdec_decode_step`` under the
    serving placement equal to ``mesh=None``'s, the cross K/V cache on
    the rank's heads.

Each mesh shape is spawned once (1x4 with 2x2 in one four-rank spawn,
then 1x2) with one torch thread a rank; the JAX references run in this
process meanwhile.
"""
import concurrent.futures
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.configs import base as jbase
from repro.core.schedules import make_schedule as jmake_schedule
from repro.launch import mesh as jmesh
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.models import transformer as jtr
from repro.optim.base import make_optimizer as jmake_optimizer
from repro.train import steps as jsteps
from repro.train.engine import ProgressiveTrainer as JaxTrainer
from repro.train.serve_engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import base
from repro_torch.distributed import context
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
import mesh_runs

LOSS_TOL = 1e-4
GRAD_TOL = 1e-5            # absolute, plus 1e-4 relative
LOGIT_TOL = 1e-4
GEN = 6
MAX_LEN = 32
STEPS = 3
# 4 query heads over 2 KV heads: two smoke configs, and gemma2-9b's with
# its KV heads cut to 2 (sliding-window rings, logit softcaps).
GQA = ("starcoder2-3b", "qwen2-vl-2b", "gemma2-9b-kv2")
WHISPER = "whisper-base"
# Continuous serving's engine; the draft is one pattern period deep.
CSERVE = dict(paged=True, block_size=4, prefix_cache=True, spec_decode=True,
              gamma=2)

# (attn_tp, kv_shared) of each ported config's full size at 'model' = 2,
# 4 and 16: query heads that divide m, over KV heads that divide m or
# that m is a multiple of.
TRUTH = {
    "rwkv6-7b": ((0, 0), (0, 0), (0, 0)),             # no attention
    "jamba-v0.1-52b": ((1, 0), (1, 0), (1, 1)),       # 32 / 8
    "yi-34b": ((1, 0), (1, 0), (0, 0)),               # 56 / 8
    "starcoder2-3b": ((1, 0), (1, 1), (0, 0)),        # 24 / 2
    "deepseek-moe-16b": ((1, 0), (1, 0), (1, 0)),     # 16 / 16
    "moonshot-v1-16b-a3b": ((1, 0), (1, 0), (1, 0)),  # 16 / 16
    "gemma2-9b": ((1, 0), (1, 0), (1, 1)),            # 16 / 8
    "gemma3-12b": ((1, 0), (1, 0), (1, 1)),           # 16 / 8
    "qwen2-vl-2b": ((1, 0), (1, 1), (0, 0)),          # 12 / 2
    "whisper-base": ((1, 0), (1, 0), (0, 0)),         # 8 / 8
    "llama3-0.3b": ((1, 0), (1, 0), (1, 1)),          # 16 / 8
    "qwen3-0.3b": ((1, 0), (1, 0), (1, 1)),           # 16 / 8
    "mixtral-0.3b": ((1, 0), (1, 0), (0, 0)),         # 8 / 4
    "deepseekv3-0.3b": ((0, 0), (0, 0), (0, 0)),      # MLA: mla_tp's
    "gpt2-12l": ((1, 0), (1, 0), (0, 0)),             # 12 / 12
}
MODELS = (2, 4, 16)


def _smoke(mod, name):
    """``name``'s smoke config from the configs module ``mod`` (the port's
    or the JAX package's); ``gemma2-9b-kv2``: gemma2-9b's with 2 KV
    heads."""
    if name == "gemma2-9b-kv2":
        return dataclasses.replace(mod.get_smoke_config("gemma2-9b"),
                                   name=name, num_kv_heads=2)
    return mod.get_smoke_config(name)


class _Mesh:
    """A mesh's axis sizes, this rank's coordinates and stand-in groups:
    all the rule reads."""

    def __init__(self, m: int, rank: int = 0, data: int = 1):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": m}
        self.coords = {"data": 0, "model": rank}

    def group(self, axes):
        return ("group", tuple(axes))


def _scope(m: int, rank: int = 0, layout: str = "tp"):
    return context.mesh_scope(context.MeshContext(_Mesh(m, rank), layout))


@pytest.mark.parametrize("name", sorted(TRUTH))
def test_rule_truth_table(name):
    """``attn_tp`` and ``kv_shared`` as ``TRUTH`` says; ``tp_local_cfg``
    gives H/m query heads and KV/m KV heads, one under ``kv_shared``;
    every rank's ``kv_head`` is the KV head each of its query heads reads;
    the encoder-decoder has a 'model' group under the tp layout (none
    under fsdp); ``keeps_model_split`` keeps ``wq``/``wo`` split under
    ``attn_tp``, ``wk``/``wv`` split only where KV divides m, and every
    leaf it keeps split is one the reference's rule splits over
    'model'."""
    cfg = configs.get_config(name)
    tree = registry.get_model(cfg).init(None, cfg, device="meta")
    H, KV = cfg.num_heads, cfg.num_kv_heads
    for m, (tp, shared) in zip(MODELS, TRUTH[name]):
        with _scope(m):
            assert context.model_group(cfg) is not None
            assert context.attn_tp(cfg) == bool(tp), (name, m)
            assert context.kv_shared(cfg) == bool(shared), (name, m)
            if tp:
                local = context.tp_local_cfg(cfg)
                assert local.num_heads == H // m
                assert local.num_kv_heads == (1 if shared else KV // m)
            mesh = shd.MeshShape(("data", "model"), (16, m))
            for path, leaf in bridge.flatten(tree).items():
                path = bridge.parse_keystr(path)
                keep = context.keeps_model_split(path, cfg)
                spec = shd.param_spec(path, leaf.shape, mesh)
                if keep:
                    assert "model" in shd.spec_axes(spec), (name, m, path)
                if path[-1] in ("wq", "wo") and cfg.attention != "mla":
                    assert keep == bool(tp), (name, m, path)
                if path[-1] in ("wk", "wv"):
                    assert keep == bool(tp and not shared), (name, m, path)
                if cfg.is_encoder_decoder and path[-1] in ("w_up", "w_down"):
                    assert keep == (cfg.d_ff % m == 0), (name, m, path)
        if shared:
            for r in range(m):
                with _scope(m, r):
                    heads = range(r * H // m, (r + 1) * H // m)
                    assert {h // (H // KV) for h in heads} == \
                        {context.kv_head(cfg)}, (name, m, r)
        with context.mesh_scope(context.MeshContext(_Mesh(m), "fsdp")):
            assert context.model_group(cfg) is None


def _gqa_tcfg(mod, cfg):
    return mod.TrainConfig(
        total_steps=STEPS, seq_len=16, global_batch=8,
        source_layers=cfg.num_layers,
        optimizer=mod.OptimizerConfig(name="adamw", learning_rate=0.01),
        schedule=mod.ScheduleConfig(name="wsd"), eval_every=10_000,
        checkpoint_every=10_000, log_every=1)


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
    """The JAX references (the 1x4 trainer, ``jax.grad`` and solo
    generation on one device, whisper's train steps on one device), the
    four-rank spawn (1x4 and 2x2) and the two-rank one (1x2), and
    ``mesh=None``'s port runs."""
    tmp = tmp_path_factory.mktemp("heads")
    archs = GQA + (WHISPER,)
    cfgs = {a: _smoke(configs, a) for a in archs}
    jcfgs = {a: _smoke(jconfigs, a) for a in archs}
    jp = {a: jax.device_get(jregistry.get_model(jcfgs[a]).init(
        jax.random.PRNGKey(1), jcfgs[a])) for a in archs}
    params = {a: {k: np.asarray(v) for k, v in bridge.flatten(jp[a]).items()}
              for a in archs}
    rng = np.random.default_rng(0)
    batch = {a: tuple(rng.integers(0, cfgs[a].vocab_size, (8, 16))
                      .astype(np.int32) for _ in range(2)) for a in GQA}
    wc = cfgs[WHISPER]
    # 12 decoder positions over the encoder's 16 frames: S_q != S_k
    wt = rng.integers(0, wc.vocab_size, (8, 13)).astype(np.int32)
    batch[WHISPER] = (wt[:, :-1], wt[:, 1:])
    frames = rng.standard_normal((8, wc.encoder_seq_len, wc.d_model),
                                 dtype=np.float32)
    wbatches = []
    for _ in range(STEPS):
        toks = rng.integers(0, wc.vocab_size, (8, 13)).astype(np.int32)
        wbatches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                         "frames": rng.standard_normal(
                             frames.shape, dtype=np.float32)})
    prompts = {a: rng.integers(0, cfgs[a].vocab_size, (4, 8))
               .astype(np.int32) for a in GQA}
    reqs = {a: [dict(prompt=p, max_new_tokens=GEN)
                for p in (prompts[a][0], prompts[a][1], prompts[a][0],
                          prompts[a][2])] for a in GQA}
    init = {}
    for a in GQA:
        j2 = jcfgs[a]
        p2 = jregistry.get_model(j2).init(jax.random.PRNGKey(0), j2)
        opt = jmake_optimizer(_gqa_tcfg(jbase, j2).optimizer)
        init[a] = tmp / f"init_{a}"
        jckpt.save(str(init[a]), 0, {"params": p2,
                                     "opt_state": opt.init(p2)},
                   metadata={"num_layers": j2.num_layers})

    def jax_refs():
        out = {}
        for a in GQA:
            out[f"train_{a}"] = JaxTrainer(
                jcfgs[a], _gqa_tcfg(jbase, jcfgs[a]),
                mesh=jmesh.make_train_mesh("1x4"),
                checkpoint_dir=_copy(init[a], tmp / f"jax_{a}"),
                log_fn=lambda *a: None).run().history["loss"]
            res = JaxServeEngine(jcfgs[a], jp[a],
                                 mesh=jmesh.single_device_mesh(),
                                 max_len=MAX_LEN).generate(
                prompts[a], GEN, return_logits=True)
            out[f"solo_{a}"] = (np.asarray(res.tokens),
                                np.asarray(res.logits))
        for a in archs:
            toks, labels = batch[a]
            if a == WHISPER:
                fn = (lambda p, c=jcfgs[a], t=toks, y=labels:
                      jencdec.encdec_loss(p, c, t, y, frames))
            else:
                fn = (lambda p, c=jcfgs[a], t=toks, y=labels:
                      jtr.lm_loss(p, c, t, y))
            (loss, _), grads = jax.jit(jax.value_and_grad(
                fn, has_aux=True))(jp[a])
            out[f"grads_{a}"] = (float(loss), {
                k: np.asarray(v) for k, v in
                bridge.flatten(jax.device_get(grads)).items()})
        jopt = jmake_optimizer(jbase.OptimizerConfig())
        jstep = jsteps.make_train_step(
            jcfgs[WHISPER], jopt,
            jmake_schedule(jbase.ScheduleConfig(), 0.01, 10), donate=False)
        p, state, losses = jp[WHISPER], jopt.init(jp[WHISPER]), []
        for i, b in enumerate(wbatches):
            p, state, metrics = jstep(p, state, jax.tree.map(jnp.asarray, b),
                                      jnp.asarray(i))
            losses.append(float(metrics["loss"]))
        out["train_whisper"] = losses
        return out

    def gqa(a, mesh):
        return [
            (f"grads_{a}", "layer_grads", dict(
                cfg=cfgs[a], params_np=params[a], tokens=batch[a][0],
                labels=batch[a][1], mesh=mesh)),
            (f"train_{a}", "train", dict(
                cfg=cfgs[a], tcfg=_gqa_tcfg(base, cfgs[a]), mesh=mesh,
                want_params=True,
                ckpt_dir=_copy(init[a], tmp / f"{mesh}_{a}"))),
            (f"serve_{a}", "serve", dict(
                cfg=cfgs[a], params_np=params[a], prompts=prompts[a],
                num_tokens=GEN, mesh=mesh, max_len=MAX_LEN)),
            (f"cserve_{a}", "cserve", dict(
                cfg=cfgs[a], params_np=params[a], requests=reqs[a],
                mesh=mesh, max_len=MAX_LEN, max_batch=2, engine_kw=dict(
                    CSERVE, draft_depth=cfgs[a].pattern_period),
                sched_kw=dict(chunk_len=4))),
            (f"caches_{a}", "cache_shapes", dict(
                cfg=cfgs[a], params_np=params[a], mesh=mesh,
                max_len=MAX_LEN))]

    def whisper(mesh):
        return [
            (f"grads_{WHISPER}", "layer_grads", dict(
                cfg=wc, params_np=params[WHISPER],
                tokens=batch[WHISPER][0], labels=batch[WHISPER][1],
                mesh=mesh, frames=frames)),
            ("train_whisper", "encdec_train", dict(
                cfg=wc, params_np=params[WHISPER], batches=wbatches,
                mesh=mesh)),
            ("decode_whisper", "encdec_decode", dict(
                cfg=wc, params_np=params[WHISPER], frames=frames[:4],
                num_tokens=GEN, mesh=mesh))]

    s4 = [x for a in GQA for x in gqa(a, "1x4")] + [
        (f"{n}@2x2", *x) for n, *x in whisper("2x2")]
    s2 = whisper("1x2")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_refs)
        r4 = mesh_lib.spawn(mesh_runs.run, 4, (s4, "cpu"), timeout_s=900)
        r2 = mesh_lib.spawn(mesh_runs.run, 2, (s2, "cpu"), timeout_s=900)
        jax_out = ref.result()
    none = {}
    for a in GQA:
        none[f"train_{a}"] = mesh_runs.train(
            cfgs[a], _gqa_tcfg(base, cfgs[a]), None,
            ckpt_dir=_copy(init[a], tmp / f"none_{a}"))
    none["train_whisper"] = mesh_runs.encdec_train(
        wc, params[WHISPER], wbatches, None)
    none["decode_whisper"] = mesh_runs.encdec_decode(
        wc, params[WHISPER], frames[:4], GEN, None)
    meshes = {"1x4": r4, "1x2": r2,
              "2x2": [{k.removesuffix("@2x2"): v for k, v in r.items()
                       if k.endswith("@2x2")} for r in r4]}
    print("PROFILE", r4[0]["_seconds"], r2[0]["_seconds"])
    return dict(tmp=tmp, cfgs=cfgs, params=params, jax=jax_out, none=none,
                meshes=meshes)


def _near_tie_equal(got, want, logits, label):
    """Greedy streams ``got`` and ``want`` (rows of tokens) equal, or, row
    by row, first different where the reference's logits at that step
    have a top-2 gap within ``LOGIT_TOL``."""
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


def _grads_match(got, loss, want, label):
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, err_msg=label)
    assert sorted(got["grads"]) == sorted(want)
    for key, g in want.items():
        np.testing.assert_allclose(got["grads"][key], g, atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=f"{label} {key}")


@pytest.mark.parametrize("arch", GQA)
def test_gqa_gradients_on_one_kv_head_match_jax_grad(world, arch):
    """1x4: every rank's loss and every leaf's gradient, gathered whole,
    within 1e-5 + 1e-4 relative of ``jax.grad`` on one device and alike
    on every rank; each flash call takes 1 query head over 1 KV head;
    ``wk`` and ``wv`` are the leaves gathered over 'model', ``wq`` is
    used at its column shard."""
    cfg = world["cfgs"][arch]
    loss, want = world["jax"][f"grads_{arch}"]
    ranks = world["meshes"]["1x4"]
    for r in ranks:
        got = r[f"grads_{arch}"]
        _grads_match(got, loss, want, arch)
        for key, g in got["grads"].items():
            np.testing.assert_array_equal(
                ranks[0][f"grads_{arch}"]["grads"][key], g)
        assert got["flash_shapes"], arch
        for q, k in got["flash_shapes"]:
            assert q[2] == cfg.num_heads // 4 and k[2] == 1, (q, k)
        names = {bridge.parse_keystr(k)[-1] for k in got["model_gathers"]}
        assert names == {"wk", "wv"}, names
        for key, shape in got["used_shapes"].items():
            if key.endswith("['wq']"):
                assert shape[-1] == cfg.q_dim // 4, (key, shape)


@pytest.mark.parametrize("arch", GQA)
def test_gqa_losses_match_mesh_none_and_jax(world, arch):
    """1x4: three AdamW steps' losses from the JAX parameters' step-0
    checkpoint within 1e-4 of ``mesh=None``'s and of the JAX trainer's on
    its 1x4 mesh; every rank alike."""
    ranks = world["meshes"]["1x4"]
    h = ranks[0][f"train_{arch}"]["history"]["loss"]
    assert len(h) == STEPS
    for r in ranks[1:]:
        assert r[f"train_{arch}"]["history"]["loss"] == h
    np.testing.assert_allclose(h, world["jax"][f"train_{arch}"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(
        h, world["none"][f"train_{arch}"]["history"]["loss"], rtol=0,
        atol=LOSS_TOL)


@pytest.mark.parametrize("arch", GQA)
def test_gqa_streams_match_jax_solo(world, arch):
    """1x4: greedy ``generate`` (logits within 1e-4 where the tokens are
    equal) and continuous paged serving with the prefix cache and
    speculation, 4 requests into 2 slots, against the JAX package's solo
    generation by the near-tie rule; every rank alike."""
    ranks = world["meshes"]["1x4"]
    tokens, logits = world["jax"][f"solo_{arch}"]
    got = ranks[0][f"serve_{arch}"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"serve_{arch}"]["tokens"],
                                      got["tokens"])
    _near_tie_equal(got["tokens"], tokens, logits, f"{arch} generate")
    if np.array_equal(got["tokens"], tokens):
        np.testing.assert_allclose(got["logits"], logits, rtol=0,
                                   atol=LOGIT_TOL)
    cs = ranks[0][f"cserve_{arch}"]
    for r in ranks[1:]:
        assert [list(x["tokens"]) for x in r[f"cserve_{arch}"]["results"]] \
            == [list(x["tokens"]) for x in cs["results"]]
    for i, (res, b) in enumerate(zip(cs["results"], (0, 1, 0, 2))):
        assert res["finish_reason"] == "limit"
        _near_tie_equal(np.asarray(res["tokens"])[None], tokens[b:b + 1],
                        logits[b:b + 1], f"{arch} request {i}")
    assert cs["stats"]["prefix"]["prefix_hits"] >= 1
    assert cs["stats"]["spec"]["spec_rounds"] > 0


@pytest.mark.parametrize("arch", GQA)
def test_gqa_caches_hold_one_kv_head(world, arch):
    """1x4: each rank's contiguous cache, pool pages, rings (beside the
    pool and in the B=1 prefill carry) hold one KV head of ``head_dim``;
    a rank's pool costs 1/KV of one device's bytes a token."""
    cfg = world["cfgs"][arch]
    hd = cfg.head_dim
    n_super = cfg.num_layers // cfg.pattern_period
    for r in world["meshes"]["1x4"]:
        got = r[f"caches_{arch}"]
        shapes = [s for kind in got.values() for s in kind.values()]
        assert shapes
        for s in shapes:
            assert s[-2:] == (1, hd), s
        paged = 0
        for i in range(cfg.pattern_period):
            lay = f"['layer{i}']"
            W = cfg.layer_window(i)
            S = min(MAX_LEN, W) if W else MAX_LEN
            assert got["contiguous"][lay + "['k']"] == (n_super, 2, S, 1, hd)
            if W:
                assert got["paged"][lay + "['k']"] == (n_super, 2, S, 1, hd)
                assert got["carry"][lay + "['k']"] == (n_super, 1, S, 1, hd)
            else:
                paged += n_super
                assert got["paged"][lay + "['k_pages']"][-2:] == (1, hd)
        assert paged
        assert r[f"cserve_{arch}"]["stats"]["kv"]["kv_bytes_per_token"] == \
            2 * paged * hd * 4


@pytest.mark.parametrize("arch", GQA)
def test_gqa_mesh_checkpoint_restores_bit_for_bit(world, arch):
    """The 1x4 run's final checkpoint (rank 0 writes whole leaves)
    restored under ``mesh=None`` and read by the JAX checkpointer through
    ``bridge.params_from_jax``: both equal the run's final params,
    gathered whole, bit for bit."""
    cfg = world["cfgs"][arch]
    directory = str(world["tmp"] / f"1x4_{arch}")
    like_p = registry.get_model(cfg).init(None, cfg, device="meta")
    opt = make_optimizer(base.OptimizerConfig(name="adamw"))
    whole = bridge.flatten(ckpt.restore(directory, STEPS, {
        "params": like_p, "opt_state": opt.init(like_p)}))
    jcfg = _smoke(jconfigs, arch)
    jlike = jax.eval_shape(lambda: jregistry.get_model(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    via_jax = bridge.flatten(bridge.params_from_jax(
        jckpt.restore_subtree(directory, STEPS, jlike, "params")))
    final = world["meshes"]["1x4"][0][f"train_{arch}"]["params"]
    assert sorted(via_jax) == sorted(final)
    for key, x in final.items():
        np.testing.assert_array_equal(whole["['params']" + key], x,
                                      err_msg=key)
        np.testing.assert_array_equal(bridge.to_numpy(via_jax[key]), x,
                                      err_msg=key)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_whisper_gradients_match_jax_grad(world, mesh):
    """The encoder-decoder's loss with frames and every leaf's gradient
    (encoder, cross-attention, the tied embedding and both position
    tables among them) within 1e-5 + 1e-4 relative of ``jax.grad`` on one
    device; nothing gathered over 'model'; flash on 2 of 4 heads (the
    encoder's, the decoder's and the cross-attention at S_k = 16 over
    S_q = 12); the MLP and the embedding used at their shards."""
    cfg = world["cfgs"][WHISPER]
    loss, want = world["jax"][f"grads_{WHISPER}"]
    for r in world["meshes"][mesh]:
        got = r[f"grads_{WHISPER}"]
        _grads_match(got, loss, want, mesh)
        assert got["model_gathers"] == []
        kinds = sorted((q[1], k[1]) for q, k in got["flash_shapes"])
        L = cfg.num_layers
        assert kinds == sorted([(12, 12)] * L + [(12, 16)] * L
                               + [(16, 16)] * cfg.num_encoder_layers)
        assert all(q[2] == k[2] == cfg.num_heads // 2
                   for q, k in got["flash_shapes"])
        used = got["used_shapes"]
        assert used["['embed']"][0] == cfg.vocab_size // 2
        assert used["['blocks']['mlp']['w_up']"][-1] == cfg.d_ff // 2
        assert used["['enc_blocks']['mlp']['w_down']"][-2] == cfg.d_ff // 2


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_whisper_losses_match_mesh_none_and_jax(world, mesh):
    """Three Muon-NSGD steps through ``make_train_step`` on batches with
    frames: losses within 1e-4 of ``mesh=None``'s and of the JAX
    package's steps on one device; every rank alike."""
    ranks = world["meshes"][mesh]
    got = ranks[0]["train_whisper"]["losses"]
    for r in ranks[1:]:
        assert r["train_whisper"]["losses"] == got
    np.testing.assert_allclose(got, world["jax"]["train_whisper"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got, world["none"]["train_whisper"]["losses"],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_whisper_decode_matches_mesh_none(world, mesh):
    """Greedy decoding of 6 tokens through ``encdec_decode_step`` under
    the serving placement: the tokens equal ``mesh=None``'s (or first
    differ at a near-tie), the logits within 1e-4 where they are equal;
    the cross K/V and self-attention caches on the rank's 2 of 4 heads."""
    cfg = world["cfgs"][WHISPER]
    want = world["none"]["decode_whisper"]
    for r in world["meshes"][mesh]:
        got = r["decode_whisper"]
        _near_tie_equal(got["tokens"], want["tokens"], want["logits"], mesh)
        if np.array_equal(got["tokens"], want["tokens"]):
            np.testing.assert_allclose(got["logits"], want["logits"],
                                       rtol=0, atol=LOGIT_TOL)
        for key, shape in got["cache_shapes"].items():
            assert shape[-2:] == (cfg.num_heads // 2, cfg.head_dim), key

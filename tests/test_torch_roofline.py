"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), and the step counter (``roofline.torch_cost``)
on its own.

  * the analytic functions equal the reference's for every assigned arch
    x applicable shape x KV dtype x a few batches, to 1e-12 relative;
  * ``RooflineTerms`` with one unit gives the reference's terms scaled by
    the peaks, and the same dominant term and useful ratio;
  * ``report.render`` and ``experiments_md``'s tables give the same text
    on the same JSON rows;
  * the work functions at ``PERF.md``'s kernel-table shapes give the
    table's FLOPs, bytes and bounds;
  * the counter: a matmul and a bmm exactly, each kernel region its work
    function and not the plain version inside it, a smoke train step on
    CPU tensors as on meta, the c10d ops of a 2-rank gloo run under the
    reference's kinds, and the smoke step's FLOPs within 25% of the
    reference's HLO walker on the same step jitted on one device.
"""
import contextlib
import dataclasses
import io
import json
import os

import jax
import pytest
import torch

from repro import configs as jcfglib
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import mesh as jmesh
from repro.roofline import analysis as janalysis
from repro.roofline import experiments_md as jexp
from repro.roofline import hlo_cost
from repro.roofline import report as jreport
from repro_torch import configs as cfglib
from repro_torch.configs import base
from repro_torch.configs.base import (OptimizerConfig, ScheduleConfig,
                                      ShapeConfig)
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.newton_schulz import ops as ns_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.optim.base import make_optimizer
from repro_torch.roofline import analysis, experiments_md, report, torch_cost
from repro_torch.train import steps


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the environment's XLA flags
    kept: the module appends a 512-device flag to ``XLA_FLAGS`` when
    imported (for its own process), which would give every later JAX
    backend in this worker 512 devices instead of the conftest's 8."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return dryrun


jdryrun = _reference_dryrun()

REL = 1e-12
KV_DTYPES = ("f32", "bf16", "int8", "fp8")
BATCHES = (1, 8, 128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# The analytic functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", cfglib.ASSIGNED_ARCHS)
def test_analytic_functions_equal_the_reference(arch):
    assert cfglib.ASSIGNED_ARCHS == jcfglib.ASSIGNED_ARCHS
    assert cfglib.LONG_CONTEXT_ARCHS == jcfglib.LONG_CONTEXT_ARCHS
    cfg, jcfg = cfglib.get_config(arch), jcfglib.get_config(arch)
    shapes = cfglib.applicable_shapes(arch)
    assert [dataclasses.astuple(s) for s in shapes] == [
        dataclasses.astuple(s) for s in jcfglib.applicable_shapes(arch)]
    n = 0
    for shape in shapes:
        jshape = JShapeConfig(*dataclasses.astuple(shape))
        assert _close(analysis.model_flops_estimate(cfg, shape),
                      janalysis.model_flops_estimate(jcfg, jshape))
        for kv in KV_DTYPES:
            ctx = shape.seq_len
            assert _close(analysis.decode_kv_bytes_per_token(cfg, ctx, kv),
                          janalysis.decode_kv_bytes_per_token(jcfg, ctx, kv))
            for b in BATCHES:
                assert _close(
                    analysis.decode_hbm_bytes_per_token(cfg, ctx, kv, b),
                    janalysis.decode_hbm_bytes_per_token(jcfg, ctx, kv, b))
                assert _close(
                    analysis.predicted_quant_speedup(cfg, ctx, kv, b),
                    janalysis.predicted_quant_speedup(jcfg, ctx, kv, b))
                n += 1
    assert n == len(shapes) * len(KV_DTYPES) * len(BATCHES)


def test_shapes_and_the_cards_constants():
    from repro.configs import base as jbase
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert (base.HW_PEAK_F32_FLOPS, base.HW_PEAK_TF32_FLOPS,
            base.HW_PEAK_BF16_FLOPS, base.HW_HBM_BW, base.HW_HBM_BYTES,
            base.HW_LINK_BW) == (67e12, 495e12, 989e12, 3.35e12, 80e9, 50e9)


# ---------------------------------------------------------------------------
# RooflineTerms and the reports
# ---------------------------------------------------------------------------

# (hlo_flops, hlo_bytes, collective bytes by kind): a compute-, a memory-
# and a collective-dominated cell, each term a hundredfold the others.
TERM_CASES = {"compute": (1e18, 1e12, {"all-gather": 1e9}),
              "memory": (1e12, 1e16, {"all-reduce": 1e9}),
              "collective": (1e12, 1e12, {"reduce-scatter": 1e15})}


def _terms(mod, case, **extra):
    flops, nbytes, coll = TERM_CASES[case]
    return mod.RooflineTerms(
        arch="a", shape="s", mesh="single", chips=256, hlo_flops=flops,
        hlo_bytes=nbytes,
        coll_bytes_weighted=mod.weighted_collective_bytes(coll),
        coll_by_op=coll, model_flops=0.4 * flops,
        per_device_memory={"argument_size_in_bytes": 1}, **extra)


@pytest.mark.parametrize("case", sorted(TERM_CASES))
def test_roofline_terms_with_one_unit_scale_by_the_peaks(case):
    from repro.configs import base as jbase
    port = _terms(analysis, case,
                  flops_by_unit={"bf16": TERM_CASES[case][0]})
    ref = _terms(janalysis, case)
    assert _close(port.t_compute * base.HW_PEAK_BF16_FLOPS,
                  ref.t_compute * jbase.HW_PEAK_FLOPS)
    assert _close(port.t_memory * base.HW_HBM_BW,
                  ref.t_memory * jbase.HW_HBM_BW)
    assert _close(port.t_collective * base.HW_LINK_BW,
                  ref.t_collective * jbase.HW_ICI_BW)
    assert port.dominant == ref.dominant == case
    assert port.useful_ratio == ref.useful_ratio
    if case == "compute":
        assert _close(port.roofline_fraction, ref.roofline_fraction)
    # A JSON without flops_by_unit (the reference's) is one bf16 unit.
    bare = _terms(analysis, case)
    assert bare.t_compute == port.t_compute


def test_units_split_the_compute_term():
    t = _terms(analysis, "compute",
               flops_by_unit={"f32": 6.7e17, "tf32x3": 3.3e17})
    want = (6.7e17 / 67e12 + 3 * 3.3e17 / 495e12) / 256
    assert _close(t.t_compute, want)


def _rows():
    """JSON rows of three cells as a dry run writes them (the reference's
    keys, ``compile_s`` included, and the port's own)."""
    rows = []
    for i, case in enumerate(sorted(TERM_CASES)):
        for tag in ("baseline", "opt"):
            t = _terms(janalysis, case)
            t.arch, t.shape = f"arch{i}", "train_4k"
            d = {**t.to_json(), "tag": tag, "compile_s": 3.0 + i,
                 "fits_hbm": bool(i % 2),
                 "per_device_memory": {
                     "argument_size_in_bytes": 2 ** 30 * (i + 1),
                     "temp_size_in_bytes": 2 ** 29 * (i + 2)}}
            rows.append(d)
    return rows


def test_reports_render_the_same_text(tmp_path, monkeypatch):
    rows = _rows()
    for n, d in enumerate(rows):
        with open(tmp_path / f"{n}.json", "w") as f:
            json.dump(d, f)
    got = report.load_all(str(tmp_path))
    assert got == jreport.load_all(str(tmp_path)) and len(got) == 3
    for fmt in ("md", "csv"):
        assert report.render(got, fmt) == jreport.render(got, fmt)
    for argv in ([], ["--tag", "opt"]):
        outs = []
        for mod in (report, jreport):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                mod.main(["--dir", str(tmp_path)] + argv)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    monkeypatch.setattr(experiments_md, "DIR", str(tmp_path))
    monkeypatch.setattr(jexp, "DIR", str(tmp_path))
    outs = []
    for mod in (experiments_md, jexp):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "arch2 | train_4k" in outs[0]


# ---------------------------------------------------------------------------
# The work functions at PERF.md's kernel-table shapes
# ---------------------------------------------------------------------------


def _ms(x):
    return round(x, 4)


def test_work_functions_give_the_kernel_tables_figures():
    w = torch_cost.flash_attention(8, 512, 512, 12, 12, 64)
    assert round(w.flops / 1e9, 3) == 3.228
    b = w.bounds()
    assert (_ms(b["bound_ms"]), b["bound_by"], _ms(b["f32_bound_ms"])) == (
        0.0196, "operations", 0.0482)
    lse = torch_cost.flash_attention(16, 256, 256, 12, 12, 64,
                                     with_lse=True)
    assert (_ms(lse.bound()["bound_ms"]), round(lse.bytes / 1e6, 1)) == (
        0.0151, 50.5)
    bwd = torch_cost.flash_attention_bwd(16, 256, 256, 12, 12, 64)
    assert (_ms(bwd.bound()["bound_ms"]), bwd.bound()["bound_by"],
            round(bwd.bytes / 1e6), _ms(bwd.bounds()["f32_bound_ms"])) == (
        0.0301, "bytes", 101, 0.0603)
    jamba = torch_cost.flash_attention(4, 1024, 1024, 32, 8, 128)
    assert (_ms(jamba.bound()["bound_ms"]),
            _ms(jamba.bounds()["f32_bound_ms"])) == (0.2084, 0.5133)
    gemma2 = torch_cost.flash_attention(1, 5120, 5120, 16, 8, 256,
                                        window=4096)
    assert round(gemma2.flops / 1e9, 1) == 206.2
    assert _ms(gemma2.bound()["bound_ms"]) == 1.2496
    assert _ms(torch_cost.flash_attention(
        1, 5120, 5120, 16, 8, 256, window=4096,
        itemsize=2).bound()["bound_ms"]) == 0.2085

    ns = torch_cost.ns_fused(12, 768, 3072, 5)
    assert round(ns.flops / 1e9) == 489
    assert round(ns.by_unit["tf32x3"] / 1e9, 1) == 353.5
    assert (_ms(ns.bound()["bound_ms"]), _ms(ns.bounds()["f32_bound_ms"])) \
        == (2.1425, 7.3018)
    gram = torch_cost.matmul(768, 768, 50304, symmetric=True)
    assert round(gram.by_unit["tf32x3"] / 1e9, 1) == 29.7
    assert (_ms(gram.bound()["bound_ms"]),
            _ms(gram.bounds()["f32_bound_ms"])) == (0.1801, 0.8857)
    gg = torch_cost.matmul(768, 768, 768, symmetric=True)
    px = torch_cost.matmul(768, 50304, 768)
    assert (_ms(gg.bound()["bound_ms"]), _ms(gg.bounds()["f32_bound_ms"]),
            _ms(px.bound()["bound_ms"]), _ms(px.bounds()["f32_bound_ms"])) \
        == (0.0027, 0.0135, 0.3596, 0.8857)

    wkv = torch_cost.wkv(4, 1024, 64, 64)
    assert round(wkv.bytes / 1e6, 1) == 343.9
    assert (_ms(wkv.bound()["bound_ms"]), wkv.bound()["bound_by"]) == (
        0.1027, "bytes")
    assert round(torch_cost.wkv(4, 1024, 64, 64, itemsize=2).bytes / 1e6,
                 1) == 209.7
    scan = torch_cost.selective_scan(4, 1024, 8192, 16)
    assert round(scan.bytes / 1e6, 1) == 407.9
    assert _ms(scan.bound()["bound_ms"]) == 0.1218
    wbwd = torch_cost.wkv_bwd(4, 1024, 64, 64, wkv_ops.chunk_steps(64))
    assert (_ms(wbwd.bound()["bound_ms"]), wbwd.bound()["bound_by"],
            round(wbwd.bytes / 1e6, 1), round(wbwd.flops / 1e9, 2)) == (
        0.2724, "operations", 746.6, 18.25)
    sbwd = torch_cost.selective_scan_bwd(4, 1024, 8192, 16,
                                         scan_ops.SAVE_STEPS)
    assert (_ms(sbwd.bound()["bound_ms"]), round(sbwd.bytes / 1e6, 1)) == (
        0.2326, 779.3)

    # paged: gpt2's shape (B 8, H = KV = 12, hd 64, pages of 16, cursors
    # 575) over f32 and int8 pages, and starcoder2-3b's (H 24, KV 2, hd 128)
    live, pages = 8 * 576, 8 * 36
    f32 = torch_cost.paged_attention(8, 12, 12, 64, live, pages)
    i8 = torch_cost.paged_attention(8, 12, 12, 64, live, pages,
                                    page_itemsize=1, quantized=True)
    assert (round(f32.bytes / 1e6, 1), round(i8.bytes / 1e6, 2)) == (
        28.4, 7.57)
    assert (_ms(f32.bound()["bound_ms"]), _ms(i8.bound()["bound_ms"])) == (
        0.0085, 0.0023)
    sc = torch_cost.paged_attention(8, 24, 2, 128, live, pages)
    assert round(sc.bytes / 1e6, 3) == 9.635


# ---------------------------------------------------------------------------
# The counter alone
# ---------------------------------------------------------------------------


def test_matmul_and_bmm_count_exactly():
    a, b = torch.randn(7, 5), torch.randn(5, 3)
    x, y = torch.randn(4, 7, 5, dtype=torch.bfloat16), \
        torch.randn(4, 5, 3, dtype=torch.bfloat16)
    with torch_cost.StepCounter() as c:
        a @ b
    assert c.count.flops == 2 * 7 * 3 * 5
    assert dict(c.count.by_unit) == {"f32": 2 * 7 * 3 * 5}
    assert c.count.bytes == 4 * (7 * 5 + 5 * 3 + 7 * 3)
    with torch_cost.StepCounter() as c:
        torch.bmm(x, y)
        torch.ones(6).view(2, 3).t()       # one op; the views are free
    assert dict(c.count.by_unit) == {"bf16": 2 * 4 * 7 * 3 * 5, "f32": 6}
    assert c.count.ops == 2


def _region_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    B, S, H, hd = 2, 40, 2, 16
    q, k, v = rnd(B, S, H, hd), rnd(B, S, H, hd), rnd(B, S, H, hd)
    r, kk, vv = rnd(B, 80, H, hd), rnd(B, 80, H, hd), rnd(B, 80, H, hd)
    w = torch.rand((B, 80, H, hd), generator=g) * 0.5 + 0.4
    u, st = rnd(H, hd), rnd(B, H, hd, hd)
    d, N = 24, 4
    us, dts = rnd(B, 70, d), torch.rand((B, 70, d), generator=g) * 0.1
    A, Bm, Cm, Dp = -torch.rand((d, N), generator=g), rnd(B, 70, N), \
        rnd(B, 70, N), rnd(d)
    kp, vp = rnd(9, 4, H, hd), rnd(9, 4, H, hd)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    idx = torch.tensor([13, 6])
    h0 = rnd(B, d, N)
    m = rnd(3, 24, 40)
    big = rnd(130, 40000)
    return [
        ("flash_attention", lambda: fa_ops.flash_attention(q, k, v),
         torch_cost.flash_attention(B, S, S, H, H, hd)),
        ("paged_attention", lambda: pa_ops.paged_attention(
            q[:, :1], kp, vp, table, idx),
         torch_cost.paged_attention(B, H, H, hd, 14 + 7, 4 + 2)),
        ("paged_prefill_attention", lambda: pa_ops.paged_prefill_attention(
            q[:, :3], kp, vp, table, torch.tensor([5, 2])),
         torch_cost.paged_prefill_attention(B, 3, 7, H, H, hd)),
        ("ns_fused", lambda: ns_ops.ns_fused(m),
         torch_cost.ns_fused(3, 24, 40)),
        ("matmul", lambda: ns_ops.matmul(m[0], m[0], trans_b=True),
         torch_cost.matmul(24, 24, 40, symmetric=True)),
        ("newton_schulz", lambda: ns_ops.newton_schulz(m.transpose(1, 2)),
         torch_cost.newton_schulz((3, 40, 24))),
        ("newton_schulz", lambda: ns_ops.newton_schulz(big, steps=1),
         torch_cost.newton_schulz((130, 40000), steps=1)),
        ("wkv", lambda: wkv_ops.wkv(r, kk, vv, w, u, st),
         torch_cost.wkv(B, 80, H, hd)),
        ("selective_scan", lambda: scan_ops.selective_scan(
            us, dts, A, Bm, Cm, Dp),
         torch_cost.selective_scan(B, 70, d, N, h0=False, final=False)),
        ("selective_scan", lambda: scan_ops.selective_scan_with_state(
            us, dts, A, Bm, Cm, Dp, h0=h0),
         torch_cost.selective_scan(B, 70, d, N)),
    ]


def test_each_region_counts_its_work_not_the_plain_version():
    assert ns_ops.route(130, 40000) == "large"
    for name, call, want in _region_cases():
        with torch_cost.StepCounter() as c:
            call()
        assert c.count.ops == 0, name
        assert c.count.flops == want.flops, name
        assert dict(c.count.by_unit) == {u: f for u, f in want.by_unit.items()
                                         if f}, name
        assert (c.count.bytes, c.count.kernel_bytes) == (0, want.bytes), name
        assert c.count.regions[name] == 1, name


def test_backward_regions_of_the_plain_paths():
    """Under the counter the plain flash, WKV and scan backwards run inside
    their kernels' regions, and give the gradients autograd gives."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 300, 2, 16), generator=g).requires_grad_()
               for _ in range(3))
    with torch_cost.StepCounter() as c:
        out = fa_ops.flash_attention(q, k, v)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    want_out = fa_ops.flash_attention(q, k, v)
    want = torch.autograd.grad(want_out.square().sum(), (q, k, v))
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert c.count.regions == {"flash_attention": 1,
                               "flash_attention_bwd": 1}
    work = torch_cost.flash_attention_bwd(2, 300, 300, 2, 2, 16)
    fwd = torch_cost.flash_attention(2, 300, 300, 2, 2, 16, with_lse=True)
    assert c.count.kernel_bytes == fwd.bytes + work.bytes
    # the square, its sum and their backward outside the regions
    assert c.count.flops == fwd.flops + work.flops + c.count.by_unit["f32"]


def _smoke_step_count(device, cfg, batch=(8, 64)):
    api = registry.get_model(cfg)
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = api.init(gen, cfg, dtype=torch.float32, device=device)
    opt = make_optimizer(OptimizerConfig())
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, make_schedule(
        ScheduleConfig(), 0.01, 100))
    data = {k: torch.zeros(batch, dtype=torch.long, device=device)
            for k in ("tokens", "labels")}
    with torch_cost.StepCounter() as c:
        step(params, state, data, 0)
    return c.count


@pytest.mark.parametrize("arch", ["gpt2-12l", "rwkv6-7b", "jamba-v0.1-52b"])
def test_a_step_counts_alike_on_cpu_tensors_and_on_meta(arch):
    """The smoke train step (loss, backward, Muon) counted on real CPU
    tensors and on meta: equal regions, kernel bytes and peak; FLOPs and
    bytes equal but for the learning rate's host-to-device copy, which the
    CPU does not make (1 FLOP, a 4-byte f32 read and written)."""
    cfg = cfglib.get_smoke_config(arch)
    cpu, meta = (_smoke_step_count(d, cfg) for d in ("cpu", "meta"))
    assert cpu.regions == meta.regions
    assert cpu.kernel_bytes == meta.kernel_bytes
    assert cpu.peak_bytes == meta.peak_bytes
    assert meta.flops - cpu.flops == 1 and meta.bytes - cpu.bytes == 8
    assert meta.ops - cpu.ops == 1
    assert meta.by_unit["f32"] - cpu.by_unit["f32"] == 1
    assert {u: f for u, f in meta.by_unit.items() if u != "f32"} == {
        u: f for u, f in cpu.by_unit.items() if u != "f32"}


def test_collectives_of_a_gloo_run_count_as_the_references_kinds():
    import mesh_runs
    got = mesh_lib.spawn(mesh_runs.run, 2,
                         ([("coll", "collective_counts", {"mesh": "2x1"})],
                          "cpu"), timeout_s=300)
    x = 4 * 8 * 4
    for res in got:
        assert res["coll"] == {"all-reduce": x, "all-gather": 2 * x,
                               "reduce-scatter": x // 2,
                               "collective-permute": x}


def test_smoke_step_within_a_quarter_of_the_reference_walker():
    """The smoke ``gpt2-12l`` train step (bf16, Muon-NSGD, remat, batch 8 x
    64): the port's count against ``hlo_cost.analyze`` of the reference's
    step jitted on one device."""
    cfg, jcfg = (m.get_smoke_config("gpt2-12l") for m in (cfglib, jcfglib))
    jmesh_1 = jmesh.make_mesh((1, 1), ("data", "model"),
                              devices=jax.devices()[:1])
    lowered = jdryrun.build_train_lowering(
        jcfg, JShapeConfig("t", 64, 8, "train"), jmesh_1)
    walked = hlo_cost.analyze(lowered.compile().as_text())
    dryrun.fake_world(1)
    try:
        m = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
        count, _, _ = dryrun.count_train(cfg, ShapeConfig("t", 64, 8,
                                                          "train"), m)
    finally:
        mesh_lib.close_world(barrier=False)
    ratio = count.flops / walked["flops"]
    print(f"smoke gpt2-12l step: port {count.flops:.4e} FLOPs, reference "
          f"walker {walked['flops']:.4e}, ratio {ratio:.4f}")
    assert 0.75 <= ratio <= 1.25

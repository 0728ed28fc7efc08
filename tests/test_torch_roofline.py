"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``) in the same process: shape bytes, the term
arithmetic, the op counter's FLOPs against ``hloparse.analyze`` of the
reference's compiled HLO (loops, stacked weights, a collective, reduced
granite's loss and gradient), the kernels' declared costs, the dry runs on
the ``meta`` device (read by the reference's ``roofline_report``) and the
kernel table's bounds."""
import dataclasses
import importlib.util
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as REF_ARCHS
from repro.models import transformer as RT
from repro.roofline import analysis as ref_analysis
from repro.roofline import hloparse
from repro_torch.configs import ARCHS
from repro_torch.kernels import distthresh as dt
from repro_torch.kernels import flashattn as fa
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis, dry_run, opcount
from repro_torch.roofline import kernels as costs
from repro_torch.roofline.dryrun import KINDS

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The reference's tolerance on its own FLOP counts (``test_roofline``).
REL = 0.01


def _ref_costs(f, *shapes):
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hloparse.analyze(jax.jit(f).lower(*structs).compile().as_text())


def _inputs(*shapes):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]


# ----------------------------------------------------------------------
# analysis
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hlo,tensors", [
    ("f32[2,3]{1,0}", [((2, 3), torch.float32)]),
    ("bf16[4,4]", [((4, 4), torch.bfloat16)]),
    ("pred[8]", [((8,), torch.bool)]),
    ("(f32[2], s32[3])", [((2,), torch.float32), ((3,), torch.int32)]),
    ("f32[]", [((), torch.float32)]),
    ("u8[10,10]", [((10, 10), torch.uint8)]),
])
def test_tensor_bytes_equal_shape_bytes(hlo, tensors):
    assert sum(analysis.tensor_bytes(s, d) for s, d in tensors) == \
        ref_analysis.shape_bytes(hlo)


#: The reference's ``TestRooflineTerms`` inputs.
REPORT_CASES = {
    "formulas": dict(per_device_flops=197e12, per_device_bytes=819e9,
                     per_device_collective_bytes=50e9, chips=256,
                     n_active_params=1_000_000, tokens=1000, kind="train"),
    "bottleneck": dict(per_device_flops=1e12, per_device_bytes=819e9 * 5,
                       per_device_collective_bytes=0, chips=2,
                       n_active_params=1, tokens=1, kind="prefill"),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_roofline_report_equals_reference_at_v5e(case):
    kw = REPORT_CASES[case]
    got = analysis.roofline_report(**kw, hw=ref_analysis.HW)
    assert got.as_dict() == ref_analysis.roofline_report(**kw).as_dict()


@pytest.mark.parametrize("kind", KINDS)
def test_model_flops_equal_reference(kind):
    assert analysis.model_flops(10, 5, kind) == \
        ref_analysis.model_flops(10, 5, kind)


def test_h100_terms_are_one_second():
    hw = analysis.HW
    t = analysis.roofline_report(
        per_device_flops=hw["peak_flops"], per_device_bytes=hw["hbm_bw"],
        per_device_collective_bytes=hw["link_bw"], chips=4,
        n_active_params=1_000_000, tokens=1000, kind="train")
    assert (t.compute_s, t.memory_s, t.collective_s) == pytest.approx(
        (1.0, 1.0, 1.0))
    assert t.model_flops == pytest.approx(6e9)
    assert analysis.compute_seconds({"float32": 67e12, "bfloat16": 989e12}
                                    ) == pytest.approx(2.0)


# ----------------------------------------------------------------------
# the op counter against hloparse
# ----------------------------------------------------------------------
def _scan(x, ws):
    def body(x, w):
        return jnp.tanh(x @ w), None
    y, _ = jax.lax.scan(body, x, ws)
    return y.sum()


def _nested_scan(x, ws):
    def outer(x, wp):
        x, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, wp)
        return x, None
    y, _ = jax.lax.scan(outer, x, ws)
    return y.sum()


def _loop(x, ws):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x.sum()


def _nested_loop(x, ws):
    for i in range(ws.shape[0]):
        for j in range(ws.shape[1]):
            x = torch.tanh(x @ ws[i, j])
    return x.sum()


LOOP_CASES = {
    "loop_10": (_scan, _loop, ((8, 16), (10, 16, 16))),
    "nested_5x3": (_nested_scan, _nested_loop, ((8, 16), (5, 3, 16, 16))),
    "plain_matmul": (lambda a, b: (a @ b).sum(), lambda a, b: (a @ b).sum(),
                     ((32, 64), (64, 128))),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_flops_equal_hloparse(case):
    ref_fn, port_fn, shapes = LOOP_CASES[case]
    want = _ref_costs(ref_fn, *shapes)
    got = opcount.count(port_fn, *_inputs(*shapes))
    assert got.flops == pytest.approx(want.flops, rel=REL)
    assert got.flops_by_dtype == {"float32": got.flops}
    assert got.collective_bytes["total"] == 0 == \
        want.collective_bytes["total"]


def test_stacked_weights_count_the_slice():
    """Each iteration reads its (128, 128) slice of the stacked weights,
    not the whole buffer: the traffic stays far below buffer × trips, as
    the reference's does, and equals the slices plus the activations."""
    shapes = ((8, 128), (20, 128, 128))
    got = opcount.count(_loop, *_inputs(*shapes))
    full_buffer_x_trips = 20 * (20 * 128 * 128 * 4)
    assert got.traffic_bytes < full_buffer_x_trips
    assert _ref_costs(_scan, *shapes).traffic_bytes < full_buffer_x_trips
    # Per trip: mm reads x and the slice and writes y, tanh reads y and
    # writes x; then the sum reads x and writes a scalar.
    x, w = 8 * 128 * 4, 128 * 128 * 4
    assert got.traffic_bytes == 20 * (x + w + x + x + x) + x + 4


def test_in_place_index_writes_count_the_part_written():
    """``index_copy_`` and ``copy_`` into a slice read their sources and
    write the part they touch, not the destination's whole buffer."""
    buf = torch.zeros(64, 32)
    src = torch.ones(4, 32)
    idx = torch.arange(4)

    def f():
        buf.index_copy_(0, idx, src)
        buf[8:12].copy_(src)
    got = opcount.count(f)
    assert got.traffic_bytes == (idx.numel() * 8 + 2 * src.numel() * 4
                                 + 2 * src.numel() * 4)


def test_all_reduce_counts_operand_bytes(tmp_path):
    """One all-reduce of float32[16] on a 1-rank gloo group: 64 bytes, as
    the reference's ``TestCollectiveParse``."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1)
    try:
        t = torch.ones(16)
        got = opcount.count(dist.all_reduce, t)
    finally:
        if own:
            dist.destroy_process_group()
    assert got.collective_bytes["all-reduce"] == 64
    assert got.collective_bytes["total"] == 64
    assert not got.warnings


# ----------------------------------------------------------------------
# reduced granite: the loss and its gradient
# ----------------------------------------------------------------------
#: Reduced granite at float32, 2 × 512 tokens: one cross-entropy chunk
#: (512 positions) and one reference attention chunk (1,024 keys) each.
B, S = 2, 512
REF_KV_CHUNK = 1024
CE_CHUNK = 512
#: Products of 2·hd per (query row, key) pair in the reference's chunked
#: attention, per layer: the forward's scores and value product, the
#: backward's five (scores, dP, dV, dQ, dK); under remat the forward runs
#: again in the backward, and XLA keeps its value product but merges its
#: score product with the backward's own.
REF_ATTN_PRODUCTS = {True: 8, False: 7}


def _granite(dtype="float32"):
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), dtype=dtype)
    rcfg = dataclasses.replace(REF_ARCHS["granite-3-2b"].reduced(),
                               dtype=dtype)
    return cfg, rcfg


def _port_step(cfg, model, b, s, remat):
    tok = torch.zeros((b, s), dtype=torch.int64, device=model.device)
    loss, _ = T.loss_fn(cfg, model, {"tokens": tok, "labels": tok},
                        remat=remat)
    return torch.autograd.grad(loss, list(model.parameters()),
                               allow_unused=True)


def _ref_step_costs(rcfg, remat):
    params = jax.eval_shape(lambda: RT.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    f = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b, remat=remat), has_aux=True))
    return hloparse.analyze(f.lower(params, batch).compile().as_text())


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_granite_loss_and_gradient_flops_against_reference(remat):
    """The port counts what the reference's HLO holds but in two places,
    each derived here from the shapes; past them the two agree within the
    reference's own ``REL``.

    (1) Attention: the reference's chunked attention evaluates every
    (row, key) pair of its ``REF_KV_CHUNK``-key chunks (the keys padded to
    a whole chunk) in ``REF_ATTN_PRODUCTS[remat]`` products of 2·hd; the
    port's kernels declare the causal pairs (``roofline.kernels``).
    (2) The cross-entropy: the port's backward recomputes each chunk's
    logits (``torch.utils.checkpoint``), one product of 2·B·chunk·D·V a
    chunk that XLA folds into the forward's."""
    cfg, rcfg = _granite()
    want = _ref_step_costs(rcfg, remat)
    model = T.LM(cfg, device="cpu")
    with opcount.CostCounter() as counter:
        _port_step(cfg, model, B, S, remat)
    got = counter.costs()
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    t_pad = -(-S // REF_KV_CHUNK) * REF_KV_CHUNK
    ref_attention = (cfg.num_layers * REF_ATTN_PRODUCTS[remat]
                     * 2 * B * h * S * t_pad * hd)
    port_attention = sum(k["flops"] for k in got.kernels.values())
    ce_recompute = (-(-S // CE_CHUNK) * 2 * B * CE_CHUNK * cfg.d_model
                    * cfg.padded_vocab_size)
    expected = want.flops - ref_attention + port_attention + ce_recompute
    assert got.flops == pytest.approx(expected, rel=REL)
    assert port_attention == cfg.num_layers * (
        (2 if remat else 1) * costs.flash_fwd_cost(
            B * h, B * cfg.num_kv_heads, S, S, hd, torch.float32,
            True).total_flops
        + costs.flash_bwd_cost(B * h, B * cfg.num_kv_heads, S, S, hd,
                               torch.float32).total_flops)


def test_remat_adds_the_recomputed_forward():
    """Remat on counts the recomputed forward of every layer: its
    projections, its attention (one more declared forward) and the MLP up
    to the last product, whose output the backward does not need
    (``torch.utils.checkpoint`` stops its recompute there)."""
    cfg, _ = _granite()
    model = T.LM(cfg, device="meta")
    on, off = (opcount.count(_port_step, cfg, model, B, S, remat)
               for remat in (True, False))
    d, hd, tok = cfg.d_model, cfg.resolved_head_dim, B * S
    proj = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    up = 2 * d * cfg.d_ff                         # swiglu's gate and up
    attention = costs.flash_fwd_cost(B * cfg.num_heads,
                                     B * cfg.num_kv_heads, S, S, hd,
                                     torch.float32, True).total_flops
    recomputed = cfg.num_layers * (2 * tok * (proj + up) + attention)
    assert on.flops - off.flops == recomputed
    assert on.kernels["flashattn"]["calls"] == \
        2 * off.kernels["flashattn"]["calls"]


def test_cpu_count_equals_meta_dry_run():
    """The plain twins on the CPU and the empty outputs on ``meta`` give
    one count: the declared kernels hide what runs inside them."""
    cfg, _ = _granite()
    cpu = opcount.count(_port_step, cfg, T.LM(cfg, device="cpu"), B, 64,
                        True)
    meta = opcount.count(_port_step, cfg, T.LM(cfg, device="meta"), B, 64,
                         True)
    assert (cpu.flops, cpu.traffic_bytes, cpu.kernels) == \
        (meta.flops, meta.traffic_bytes, meta.kernels)


def test_backward_on_another_thread():
    """On CUDA the backward runs on the autograd engine's own thread,
    which carries the forward thread's dispatch modes: the counter,
    entered on a second thread as the engine hands it over, counts the
    backward there, and ``declare`` finds it and hides the plain twin on
    that thread alone."""
    cfg, _ = _granite()
    model = T.LM(cfg, device="cpu")
    one = opcount.count(_port_step, cfg, model, B, 64, True)
    counter = opcount.CostCounter()
    with counter:
        tok = torch.zeros((B, 64), dtype=torch.int64)
        loss, _ = T.loss_fn(cfg, model, {"tokens": tok, "labels": tok},
                            remat=True)

    def backward():
        with counter:
            torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    got = counter.costs()
    assert (got.flops, got.traffic_bytes, got.kernels) == \
        (one.flops, one.traffic_bytes, one.kernels)


# ----------------------------------------------------------------------
# declared kernel costs
# ----------------------------------------------------------------------
def test_declare_charges_the_kernel_and_hides_its_plain_twin():
    """A count through the kernels' plain twins is the declared costs
    plus the ops outside them: a product before the forward, the
    backward's, and a distance kernel each charge what
    ``roofline.kernels`` says, and none of the twins' own products."""
    g, bkv, s, hd = 2, 3, 70, 16
    q, do = (torch.randn(bkv * g, s, hd) for _ in range(2))
    k, v = (torch.randn(bkv, s, hd) for _ in range(2))
    w = torch.randn(hd, hd)
    rng = np.random.default_rng(1)
    e = torch.from_numpy(rng.uniform(0, 1, (300, 8)).astype(np.float32))
    qt = torch.from_numpy(rng.uniform(0, 1, (8, 40)).astype(np.float32))

    def f():
        o, lse = fa.flashattn_fwd(q @ w, k, v, g=g, device="cpu")
        fa.flashattn_bwd(q, k, v, o, lse, do, g=g, device="cpu")
        dt.distthresh_compact(e, qt, 0.1, capacity=64, device="cpu")
    got = opcount.count(f)
    fwd = costs.flash_fwd_cost(bkv * g, bkv, s, s, hd, torch.float32, True)
    bwd = costs.flash_bwd_cost(bkv * g, bkv, s, s, hd, torch.float32)
    dist = costs.distthresh_shape_cost(300, 40, "compact", valid_c=300,
                                       valid_q=40, capacity=64)
    mm = 2 * bkv * g * s * hd * hd
    assert got.flops_by_dtype == {"float32": mm + fwd.total_flops
                                  + bwd.total_flops + dist.total_flops}
    assert got.kernels == {
        "flashattn": {"calls": 1, "flops": fwd.total_flops,
                      "bytes": fwd.bytes},
        "flashattn_bwd": {"calls": 1, "flops": bwd.total_flops,
                          "bytes": bwd.bytes},
        "distthresh_compact": {"calls": 1, "flops": dist.total_flops,
                               "bytes": dist.bytes}}
    # The product reads q and w and writes q @ w: all the traffic outside
    # the kernels.
    assert got.traffic_bytes == fwd.bytes + bwd.bytes + dist.bytes + 4 * (
        2 * q.numel() + w.numel())


def test_declare_without_counter_prices_nothing():
    def never():
        raise AssertionError("priced without a counter")
    with opcount.declare("flashattn", never):
        pass


def test_meta_wrappers_return_empty_outputs_of_the_right_shape():
    q = torch.empty((8, 64, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 16), dtype=torch.bfloat16, device="meta")
    o, lse = fa.flashattn_fwd(q, k, k, g=4)
    assert (o.shape, o.device.type, lse.shape, lse.dtype) == (
        q.shape, "meta", (8, 64), torch.float32)
    dq, dk, dv = fa.flashattn_bwd(q, k, k, o, lse, o, g=4)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    e = torch.empty((300, 8), device="meta")
    qt = torch.empty((8, 40), device="meta")
    out = dt.distthresh_compact(e, qt, 0.1, capacity=64, device="meta")
    assert [tuple(x.shape) for x in out] == [(64,)] * 4 + [()] * 2
    dense = dt.distthresh_dense(e, qt, 0.1, device="meta")
    assert [tuple(x.shape) for x in dense] == [(300, 40)] * 3


# ----------------------------------------------------------------------
# dry runs
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def granite_train_record():
    return dry_run(ARCHS["granite-3-2b"], "train", 1, 64)


def test_dry_run_model_flops_equal_reference(granite_train_record):
    cfg = REF_ARCHS["granite-3-2b"]
    rf = granite_train_record["roofline"]
    assert rf["model_flops"] == ref_analysis.model_flops(
        cfg.active_param_count(), 64, "train")
    assert granite_train_record["chips"] == 1
    assert granite_train_record["mesh"] == "1"


def test_dry_run_train_state_is_params_m_v_master(granite_train_record):
    """33.0 GiB for granite-3-2b: 2 bytes a parameter plus 12 for m, v
    and the master copy (PERF.md), to within the norm scales, which the
    reference's count leaves out."""
    cfg = ARCHS["granite-3-2b"]
    scales = sum(p.numel() for n, p in T.param_specs(cfg).items()
                 if n.endswith(".scale"))
    got = granite_train_record["memory"]["peak_estimate_bytes"]
    assert got - 4 == 14 * (cfg.param_count() + scales)   # + the step count
    assert round(14 * cfg.param_count() / 2**30, 1) == 33.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dry_run_every_arch_and_kind(arch, kind):
    """Every configuration's prefill, decode step and train step run on
    the ``meta`` device at reduced size and count their products."""
    cfg = ARCHS[arch].reduced()
    rec = dry_run(cfg, kind, 2, 32)
    rf = rec["roofline"]
    assert rec["status"] == "ok" and rf["hlo_flops_global"] > 0
    assert rf["hlo_bytes_global"] > 0 and "count_warnings" not in rec
    assert rf["model_flops"] == analysis.model_flops(
        cfg.active_param_count(), 2 if kind == "decode" else 64, kind)


def test_reference_report_reads_dry_run_records(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "roofline_report", ROOT / "benchmarks" / "roofline_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    cfg = ARCHS["granite-3-2b"].reduced()
    recs = [dry_run(cfg, kind, 2, 32) for kind in KINDS]
    for rec in recs:
        (tmp_path / f"{rec['shape']}.json").write_text(json.dumps(rec))
    rows = report.run(str(tmp_path))
    assert [r["shape"] for r in rows] == sorted(r["shape"] for r in recs)
    by_shape = {r["shape"]: r for r in recs}
    for row in rows:
        rec = by_shape[row["shape"]]
        assert row["status"] == "ok" and row["mesh"] == "1"
        assert row["compute_s"] == rec["roofline"]["compute_s"]
        assert row["bottleneck"] == rec["roofline"]["bottleneck"]
        assert row["peak_gb_per_device"] == \
            rec["memory"]["peak_estimate_bytes"] / 2**30
    assert "| granite-3-2b-reduced |" in report.markdown_table(rows)


# ----------------------------------------------------------------------
# the kernel table's bounds
# ----------------------------------------------------------------------
#: The kernel table's rows (PERF.md §6) and their bounds in ms as the
#: hand-written formulas this module replaces gave them on the card
#: (the distance rows at S1's and C3's largest batches, where every pair
#: overlaps in time; S1's ~5,900 hits a batch do not move an
#: operations-bound row).
BF16 = torch.bfloat16
BOUND_ROWS = {
    "1 compact": (costs.distthresh_cost(7500, 100, 750_000, 750_000, 5900,
                                        "compact"),
                  0.0005373134328358209, "operations"),
    "2 compact_live": (costs.distthresh_cost(3100, 32, 98_304, 98_304, 400,
                                             "live", slots=64),
                       7.042674626865671e-05, "operations"),
    "3 dense": (costs.distthresh_cost(7500, 100, 750_000, 750_000, 0,
                                      "dense"),
                0.0020875223880597016, "bytes"),
    "4 compact_rowloop": (costs.distthresh_cost(
        7500, 100, 750_000, 750_000, 5900, "compact"),
        0.0005373134328358209, "operations"),
    "5 compact_live_rowloop": (costs.distthresh_cost(
        3100, 32, 98_304, 98_304, 400, "live", slots=64),
        7.042674626865671e-05, "operations"),
    "6 flash hd 64": (costs.flash_fwd_cost(256, 64, 1024, 1024, 64, BF16),
                      0.0347758268958544, "operations"),
    "6 flash hd 128": (costs.flash_fwd_cost(256, 32, 1024, 1024, 128, BF16),
                       0.0695516537917088, "operations"),
    "6 flash hd 112": (costs.flash_fwd_cost(256, 256, 1024, 1024, 112,
                                            BF16),
                       0.07011373850746269, "bytes"),
    "6b flash backward": (costs.flash_bwd_cost(256, 64, 1024, 1024, 64,
                                               BF16),
                          0.086939567239636, "operations"),
}


@pytest.mark.parametrize("row", sorted(BOUND_ROWS))
def test_kernel_table_bounds(row):
    cost, ms, by = BOUND_ROWS[row]
    got_ms, got_by = costs.bound_ms(cost.flops, cost.bytes)
    assert (got_ms, got_by) == (pytest.approx(ms, rel=1e-12), by)

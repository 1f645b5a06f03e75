"""The port's cost model (burst_attn_tpu_torch.analysis.costmodel) against
the JAX package's: every hardware-free column — pass pairs, devstats
pairs, FLOPs, stream bytes, send census, rounds, slots — equal for the
same program and shape; the h100 plans equal to the port's own
formulas (ops/tuning.py, ops/ragged_paged.py, the kernels' shared
memory); the headline floors; the cost table's schema."""

import json

import numpy as np
import pytest

from burst_attn_tpu.analysis import costmodel as jcm
from burst_attn_tpu.parallel import schedule as jsched

from burst_attn_tpu_torch.analysis import costmodel as cm
from burst_attn_tpu_torch.ops import ragged_paged, tuning
from burst_attn_tpu_torch.parallel import schedule as sched

# (topology, n_inter, n_intra, r_live): dense and elided programs
PROGRAMS = [("uni", 1, 8, None), ("uni", 1, 4, None), ("bidi", 1, 8, None),
            ("bidi", 1, 5, None), ("double", 2, 4, None),
            ("double", 4, 2, None), ("uni", 1, 8, 3), ("bidi", 1, 8, 3),
            ("double", 2, 4, 3)]


def _both(pass_, topo, n_inter, n_intra, r_live):
    """The same program compiled by both packages' compilers."""
    kw = dict(slots=2, slots1=2, r_live=r_live)
    if pass_ == "fwd":
        return (sched.compile_fwd(topo, n_intra, n_inter, **kw),
                jsched.compile_fwd(topo, n_intra, n_inter, **kw))
    return (sched.compile_bwd(topo, n_intra, n_inter, dq_slots=2, **kw),
            jsched.compile_bwd(topo, n_intra, n_inter, dq_slots=2, **kw))


@pytest.mark.parametrize("prog", PROGRAMS,
                         ids=lambda p: "-".join(str(x) for x in p))
@pytest.mark.parametrize("pass_", cm.PASSES)
def test_hardware_free_columns_equal_jax(prog, pass_):
    topo, n_inter, n_intra, r_live = prog
    ours, theirs = _both(pass_, topo, n_inter, n_intra, r_live)
    assert ours.n_rounds == theirs.n_rounds
    assert tuple(ours.slots) == tuple(theirs.slots)
    assert cm.send_census(ours) == jcm.send_census(theirs)
    s = 64
    world = n_inter * n_intra
    for layout in ("zigzag", "striped", "contig"):
        for causal in (True, False):
            assert (cm.devstats_pass_pairs(ours, layout, s, causal=causal)
                    == jcm.devstats_pass_pairs(theirs, layout, s,
                                               causal=causal))
            assert (cm.pass_pairs(layout, s, world, causal=causal)
                    == jcm.pass_pairs(layout, s, world, causal=causal))
            assert (cm.pass_flops(pass_, layout, b=1, n=4, s=s, d=128,
                                  world=world, causal=causal)
                    == jcm.pass_flops(pass_, layout, b=1, n=4, s=s, d=128,
                                      world=world, causal=causal))
    assert (cm.pass_pairs("contig", s, world, causal=True, window=70)
            == jcm.pass_pairs("contig", s, world, causal=True, window=70))


@pytest.mark.parametrize("pass_", cm.PASSES)
@pytest.mark.parametrize("wire", cm.WIRE_DTYPES)
def test_stream_bytes_equal_jax_and_the_wire_formula(pass_, wire):
    for opt_comm in (True, False):
        for itemsize in (4, 2):
            kw = dict(b=2, n=16, n_kv=4, s=512, d=128, opt_comm=opt_comm,
                      itemsize=itemsize)
            ours = cm.stream_bytes(pass_, wire, **kw)
            assert ours == jcm.stream_bytes(pass_, wire, **kw)
            assert ours == sched.wire_round_bytes(pass_, wire, **kw)


def test_ragged_hbm_bytes_equal_jax():
    for pool in ("fp32", "int8", "fp8"):
        for d_head, n_kv, kv_len in ((128, 4, 2112), (256, 8, 8192)):
            kw = dict(d_head=d_head, n_kv=n_kv, kv_len=kv_len,
                      pool_dtype=pool)
            assert cm.ragged_hbm_bytes(**kw) == jcm.ragged_hbm_bytes(**kw)
    # the port adds the bf16 pool: half of fp32, no scale columns
    kw = dict(d_head=128, n_kv=4, kv_len=100)
    assert (2 * cm.ragged_hbm_bytes(pool_dtype="bf16", **kw)
            == cm.ragged_hbm_bytes(pool_dtype="fp32", **kw))


def test_h100_plans_equal_the_ports_formulas():
    rf = tuning.resolve_fused()
    assert cm.fwd_gate_bytes(rf, 128) == tuning.fused_smem_bytes(64, 64, 128)
    assert cm.bwd_gate_bytes(rf, 128) == tuning.fused_bwd_smem_bytes(64, 64,
                                                                     128)
    # ops/tuning.py's docstring sizes: fp32 99,328 and 170,496 (the gate's
    # plans), bf16 87,040 and 156,160
    assert cm.simt_fwd_smem() == 99328 == cm.fwd_gate_bytes(rf, 128)
    assert cm.simt_bwd_smem() == 170496 == cm.bwd_gate_bytes(rf, 128)
    assert cm.mma_fwd_smem() == 87040
    assert cm.mma_bwd_smem() == 156160
    # the ragged kernel's gate prices the largest pool of each q dtype
    for q, tdt in (("bf16", "bfloat16"), ("fp32", "float32")):
        import torch

        plans = [cm.ragged_plan_bytes(q_dtype=q, pool_dtype=p)
                 for p in (q, "int8", "fp8")]
        assert max(plans) == ragged_paged._smem_plan(128, getattr(torch, tdt))
    for p in cm.kernel_smem_plans():
        assert p.smem <= tuning.SMEM_BUDGET == cm.SMEM_LIMIT, p
        assert p.ctas_by_smem >= p.ctas_assumed >= 1, p


def test_headline_floors_are_the_perf_bounds():
    """Kernels 8 and 9 at bench.py's headline (B1 N32 S65536 D128 bf16,
    causal zigzag, sp=8) on one shared H100: 68.72 G causal pairs at 989
    TFLOP/s, the bound column of PERF.md (35.576 and 88.941 ms)."""
    rf = tuning.resolve_fused()
    pairs = cm.pass_pairs("zigzag", 8192, 8, causal=True) * 32
    assert abs(pairs - 68.72e9) < 0.01e9
    for pass_, want_ms in (("fwd", 35.576), ("bwd", 88.941)):
        prog = cm.compile_program(pass_, "uni", 8, rf)
        est = cm.roofline(pass_, "h100", prog, layout="zigzag", b=1, n=32,
                          n_kv=32, s=8192, d=128, causal=True, itemsize=2)
        assert abs(est.floor_s * 1e3 - want_ms) <= 1e-3 * want_ms
        assert est.t_compute_s >= est.t_comm_s  # bound by operations


def test_shared_card_and_one_position_a_card():
    rf = tuning.resolve_fused()
    prog = cm.compile_program("fwd", "uni", 8, rf)
    kw = dict(layout="zigzag", b=1, n=32, n_kv=32, s=8192, d=128,
              causal=True, itemsize=2)
    shared = cm.roofline("fwd", "h100", prog, **kw)
    apart = cm.roofline("fwd", "h100", prog, shared=False, **kw)
    # one card does all the work: W times the per-card compute floor
    assert shared.t_compute_s == pytest.approx(8 * apart.t_compute_s,
                                               rel=1e-9)
    # a rotation: read and written in HBM on one card, NVLink across cards
    per_send = cm.stream_bytes("fwd", None, b=1, n=32, n_kv=32, s=8192,
                               d=128, itemsize=2)["kv"]
    assert shared.t_comm_s == pytest.approx(
        2 * 7 * 8 * per_send / cm.HW["h100"].hbm_bw)
    assert apart.t_comm_s == pytest.approx(
        7 * per_send / cm.HW["h100"].ici_bw)


def test_ragged_floor_counts_the_live_cache():
    lens = (0, 1, 128, 2112)
    got = cm.ragged_floor_s(lens, n_kv=4, group=4, d_head=128,
                            pool_dtype="bf16", q_itemsize=2)
    kv = 2 * 4 * sum(lens) * 128 * 2
    q_out = 2 * 3 * 4 * 4 * 128 * 2
    assert got == pytest.approx((kv + q_out) / 3.35e12)


def test_peaks_have_one_source():
    import chip_smoke

    from burst_attn_tpu_torch.bench import step_probe

    h = cm.HW["h100"]
    assert (chip_smoke.PEAK_BF16_FLOPS, chip_smoke.PEAK_HBM_BYTES) == (
        h.peak_flops, h.hbm_bw) == (989e12, 3.35e12)
    assert (step_probe.PEAK_BF16_FLOPS, step_probe.HBM_BYTES_PER_S) == (
        h.peak_flops, h.hbm_bw)


def test_cost_json_schema(capsys):
    from burst_attn_tpu_torch.analysis.__main__ import main

    assert main(["--cost-json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["schema"] == "burstcost-v2"
    assert set(d) == {"schema", "world", "shape", "hw", "n_rows", "rows",
                      "ragged", "ragged_hbm"}
    assert list(d["hw"]) == ["h100"]
    assert set(d["hw"]["h100"]) == {"peak_flops", "hbm_bw", "ici_bw"}
    # 1 generation x 3 topologies x 3 wires x 2 passes
    assert d["n_rows"] == len(d["rows"]) == 18
    for row in d["rows"]:
        assert row["generation"] == "h100" and row["fits"] is True, row
        assert row["smem_bytes"] <= row["smem_limit"] == 232448
    assert all(r["fits"] for r in d["ragged"])
    pools = {r["pool_dtype"]: r for r in d["ragged_hbm"]}
    assert set(pools) == {"fp32", "bf16", "int8", "fp8"}
    assert pools["fp32"]["win_vs_fp32"] == 1.0
    assert pools["int8"]["win_vs_fp32"] > 2.0


def test_predict_floors_and_metric():
    tc, tx = cm.predict_floors("fwd", b=1, n=32, n_kv=32, s=8192, d=128,
                               world=8)
    assert 0 < tc < tx
    tcw, txw = cm.predict_floors("fwd", b=1, n=32, n_kv=32, s=8192, d=128,
                                 world=8, layout="contig", window=4096)
    assert txw < tx  # the band does fewer pairs
    got = cm.predict_metric("ring TFLOPs/s/chip @ seq=65536 causal bf16")
    assert got is not None and 0 < got <= 989
    assert cm.predict_metric("tokens/s") is None
    assert np.isfinite(got)

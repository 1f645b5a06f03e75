"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Marked `cuda`; without a CUDA device every test skips.  Run them
on a machine with an NVIDIA GPU (the repository's conftest imports JAX,
which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.analysis import ringcheck
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, init_params, param_leaves,
)
from burst_attn_tpu_torch.ops import (
    flash, fused_ring, fused_ring_bwd, masks, paged_attention, ragged_paged,
    tile,
)
from burst_attn_tpu_torch.parallel import burst, layouts, mesh
from burst_attn_tpu_torch.serving import RaggedServeEngine

pytestmark = pytest.mark.cuda

# fp32: only summation order and exp2-vs-exp differ.  In bf16 each side
# rounds its output once: up to two bf16 ulps (2 * 2^-7) relative, with an
# absolute floor for outputs near zero.
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-3, rtol=1.6e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, dev, dtype, *shape):
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_kv,s_q,s_kv,d,causal", [
    (4, 4, 256, 256, 128, True),
    (8, 2, 200, 200, 128, True),    # GQA, ragged edge
    (4, 1, 96, 333, 128, False),    # cross lengths
])
def test_flash_kernel_matches_plain(dev, dtype, n, n_kv, s_q, s_kv, d,
                                    causal):
    g = torch.Generator(device=dev).manual_seed(0)
    q = _rand(g, dev, dtype, 2, n, s_q, d)
    k, v = (_rand(g, dev, dtype, 2, n_kv, s_kv, d) for _ in range(2))
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    before = flash.flash_fwd.launches
    m, lse, o = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                                emit_o=True)
    torch.cuda.synchronize()
    assert flash.flash_fwd.launches == before + 1
    st = tile.tile_fwd(q, k, v, *tile.init_state(2, n, s_q, d, device=dev),
                       d**-0.5, spec)
    torch.testing.assert_close(o, tile.finalize(*st, dtype), **TOL[dtype])
    torch.testing.assert_close(m, st[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, st[1], atol=1e-4, rtol=0)


def test_flash_kernel_carry_in(dev):
    n, s, d = 4, 160, 128
    g = torch.Generator(device=dev).manual_seed(1)
    q = _rand(g, dev, torch.float32, 1, n, s, d)
    k0, v0, k1, v1 = (_rand(g, dev, torch.float32, 1, 2, s, d)
                      for _ in range(4))
    st = tile.tile_fwd(q, k0, v0, *tile.init_state(1, n, s, d, device=dev),
                       d**-0.5, masks.full_spec(s, s))
    spec = masks.round_spec(0, 0, s, s, True, "contig")
    got = flash.flash_fwd(q, k1, v1, *st, d**-0.5, spec)
    want = tile.tile_fwd(q, k1, v1, *st, d**-0.5, spec)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_paged_kernel_matches_plain(dev, dtype, group):
    page, n_kv, n_pages, width, d = 128, 2, 32, 4, 128  # 7 x 4 pages
    g = torch.Generator(device=dev).manual_seed(2)
    lengths = [0, 1, 37, page, page + 1, 3 * page + 5, 4 * page]
    q = _rand(g, dev, dtype, len(lengths), n_kv, group, d)
    kp, vp = (_rand(g, dev, dtype, n_pages, n_kv, page, d) for _ in range(2))
    perm = np.random.default_rng(0).permutation(n_pages - 1) + 1
    table = torch.from_numpy(
        perm[: len(lengths) * width].reshape(len(lengths), width).astype(
            np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = paged_attention.paged_decode_attention.launches
    o = paged_attention.paged_decode_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention.launches == before + 1
    want = paged_attention.paged_decode_reference(q, kp, vp, table, lens)
    torch.testing.assert_close(o, want, **TOL[dtype])
    assert (o[0] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 64, 128, device=dev)
    spec = masks.full_spec(64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                        None, None, None, 1.0, spec)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 64, 64, device=dev)
        flash.flash_fwd(x, x, x, None, None, None, 1.0, spec)
    with pytest.raises(ValueError, match="takes"):
        h = q.half()
        flash.flash_fwd(h, h, h, None, None, None, 1.0, spec)


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    """fp32 model: the kernels' engine is token-exact with the plain CPU
    engine on the same weights, and both kernels ran."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=512, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (9, 130, 300)]
    out = {}
    for where in ("cpu", dev):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        eng = ServeEngine(p, cfg, slots=2, n_pages=12, max_pages_per_seq=4,
                          device=where)
        for pr in prompts:
            eng.submit(pr, 7)
        before = (flash.flash_fwd.launches,
                  paged_attention.paged_decode_attention.launches)
        out[str(where)] = eng.run()
        moved = [a - b for a, b in zip(
            (flash.flash_fwd.launches,
             paged_attention.paged_decode_attention.launches), before)]
        if str(where) == "cpu":
            assert moved == [0, 0]
        else:
            assert min(moved) > 0
        assert eng.pool.available == 11
    assert out["cpu"] == out[str(dev)]


def _pool(g, dev, dtype, quant, n_pages, n_kv, page, d):
    """k/v pools in `dtype`, or quantized to `quant` with their scales."""
    k, v = (torch.randn(n_pages, n_kv, page, d, generator=g, device=dev)
            for _ in range(2))
    if quant is None:
        return k.to(dtype), v.to(dtype), None, None
    qdt = paged_attention.QUANT_DTYPES[quant][0]
    (k8, ks), (v8, vs) = (paged_attention.quantize_tokens(x, dtype=qdt)
                          for x in (k, v))
    return k8, v8, ks, vs


def _ragged_case(dev, dtype, quant=None, seed=3, group=4, qt=64):
    """A mixed batch over 6 slots: idle, decode, a short first chunk, a
    chunk ending exactly on a page edge, a long chunk, a decode just past
    a page edge."""
    page, n_kv, d, width, n_pages = 128, 2, 128, 5, 40
    g = torch.Generator(device=dev).manual_seed(seed)
    q_lens = [0, 1, min(37, qt), qt, qt, 1]
    kv_lens = [0, 300, 37, 2 * page, 600, page + 1]
    q = _rand(g, dev, dtype, len(q_lens), n_kv * group, qt, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = np.random.default_rng(seed).permutation(n_pages - 1) + 1
    table = torch.from_numpy(perm[: len(q_lens) * width].reshape(
        len(q_lens), width).astype(np.int32)).to(dev)
    lens = [torch.tensor(x, dtype=torch.int32, device=dev)
            for x in (q_lens, kv_lens)]
    return q, kp, vp, table, *lens, ks, vs


@pytest.mark.parametrize("dtype,quant,group,qt", [
    (torch.float32, None, 4, 64), (torch.bfloat16, None, 4, 64),
    (torch.float32, "int8", 4, 64), (torch.bfloat16, "fp8", 4, 64),
    # 2 tokens x 8 heads: a multi-token block of the 16-row instance
    (torch.float32, None, 8, 2)])
def test_ragged_kernel_matches_plain(dev, dtype, quant, group, qt):
    q, kp, vp, table, ql, kl, ks, vs = _ragged_case(dev, dtype, quant,
                                                    group=group, qt=qt)
    before = ragged_paged.ragged_paged_attention.launches
    o = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl,
                                            k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert ragged_paged.ragged_paged_attention.launches == before + 1
    want = ragged_paged.ragged_paged_reference(q, kp, vp, table, ql, kl,
                                               k_scales=ks, v_scales=vs)
    torch.testing.assert_close(o, want, **TOL[dtype])
    assert (o[0] == 0).all() and (o[2, :, int(ql[2]):] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_partials_match_plain(dev, dtype):
    """emit_partials with a page-aligned ctx_lo: the same -inf rows; fp32
    to rounding, bf16 q (the tile's p as two bf16 terms) acc to 1e-4 of
    its largest entry, m to 1e-3, l to 1e-4 relative; two launches
    torch.equal."""
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(dev, dtype)
    lo = torch.tensor([0, 256, 0, 128, 384, 128], dtype=torch.int32,
                      device=dev)
    got = ragged_paged.ragged_paged_attention(
        q, kp, vp, table, ql, kl, ctx_lo=lo, emit_partials=True)
    again = ragged_paged.ragged_paged_attention(
        q, kp, vp, table, ql, kl, ctx_lo=lo, emit_partials=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ragged_paged.ragged_paged_partials_reference(
        q, kp, vp, table, ql, kl, ctx_lo=lo)
    for a, b, what in zip(got, want, ("acc", "m", "l")):
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        fin = torch.isfinite(b)
        if dtype == torch.float32:
            torch.testing.assert_close(a[fin], b[fin], atol=1e-4, rtol=1e-5)
        elif what == "acc":
            err = float((a[fin] - b[fin]).abs().max())
            assert err <= 1e-4 * float(b.abs().max())
        elif what == "m":
            torch.testing.assert_close(a[fin], b[fin], atol=1e-3, rtol=0)
        else:
            torch.testing.assert_close(a[fin], b[fin], atol=0, rtol=1e-4)


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, "int8")])
def test_ragged_decode_rows_equal_paged_decode(dev, dtype, quant):
    """A QT == 1 batch through the ragged kernel is bitwise the paged
    decode kernel's output (one shared online-softmax update)."""
    page, n_kv, group, d, width, n_pages = 128, 2, 4, 128, 4, 24
    g = torch.Generator(device=dev).manual_seed(5)
    lengths = [0, 1, 64, page, page + 1, 3 * page + 5, 4 * page]
    b = len(lengths)
    q = _rand(g, dev, dtype, b, n_kv, group, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = np.random.default_rng(5).permutation(n_pages - 1) + 1
    table = torch.from_numpy(np.resize(perm, (b, width)).astype(
        np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    dec = paged_attention.paged_decode_attention(q, kp, vp, table, lens,
                                                 k_scales=ks, v_scales=vs)
    rag = ragged_paged.ragged_paged_attention(
        q.reshape(b, n_kv * group, 1, d), kp, vp, table,
        (lens > 0).to(torch.int32), lens, k_scales=ks, v_scales=vs)
    assert torch.equal(rag.reshape(b, n_kv, group, d), dec)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4, 16, 64])
def test_ragged_kernel_groups_match_plain(dev, dtype, group):
    """Both paths at G query heads a kv head (at G = 64 a one-token block
    has 64 rows and takes the prefill tile, QT = 1 included): the mixed
    batch and a one-token-a-slot decode batch, against the plain versions,
    two launches torch.equal."""
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(dev, dtype, group=group)
    o = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl)
    assert torch.equal(o, ragged_paged.ragged_paged_attention(
        q, kp, vp, table, ql, kl))
    torch.testing.assert_close(o, ragged_paged.ragged_paged_reference(
        q, kp, vp, table, ql, kl), **TOL[dtype])
    b, n_q, _, d = q.shape
    qd = q[:, :, 0].reshape(b, n_q // group, group, d).contiguous()
    od = paged_attention.paged_decode_attention(qd, kp, vp, table, kl)
    assert torch.equal(od, paged_attention.paged_decode_attention(
        qd, kp, vp, table, kl))
    torch.testing.assert_close(od, paged_attention.paged_decode_reference(
        qd, kp, vp, table, kl), **TOL[dtype])


@pytest.mark.parametrize("dtype,quant", [
    (torch.bfloat16, None), (torch.float32, None), (torch.bfloat16, "fp8")])
def test_paged_kernel_long_context_splits(dev, dtype, quant):
    """Up to 16384 positions on a 128-page table: 32 splits a slot, merged
    in split order (two launches torch.equal), against the plain version;
    the empty slot gives zeros."""
    page, n_kv, group, d, width = 128, 2, 4, 128, 128
    lengths = [16384, 9000, 0, 1, 4097]
    n_pages = sum(-(-n // page) for n in lengths) + 1
    g = torch.Generator(device=dev).manual_seed(12)
    q = _rand(g, dev, dtype, len(lengths), n_kv, group, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = list(np.random.default_rng(12).permutation(n_pages - 1) + 1)
    table = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        for c in range(-(-n // page)):
            table[i, c] = perm.pop()
    table = torch.from_numpy(table).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(k_scales=ks, v_scales=vs)
    o = paged_attention.paged_decode_attention(q, kp, vp, table, lens, **kw)
    assert torch.equal(o, paged_attention.paged_decode_attention(
        q, kp, vp, table, lens, **kw))
    torch.testing.assert_close(o, paged_attention.paged_decode_reference(
        q, kp, vp, table, lens, **kw), **TOL[dtype])
    assert (o[2] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_wide_window_is_unwindowed(dev, dtype):
    """A window at or above every length walks the unwindowed chunks with
    the unwindowed code: bitwise equal, prefill and decode rows alike."""
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(dev, dtype)
    o = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl,
                                            window=1000)
    assert torch.equal(o, ragged_paged.ragged_paged_attention(
        q, kp, vp, table, ql, kl))


def _traced(q, kp, vp, table, ql, kl, **kw):
    """One launch with the kernel's CTA records: (output, records)."""
    s, n_q, qt, d = q.shape
    n_kv, page = kp.shape[1], kp.shape[2]
    width = table.shape[1]
    trace = torch.zeros(ragged_paged.trace_shape(
        s, n_kv, qt, n_q // n_kv, width, page), dtype=torch.int64,
        device=q.device)
    o = ragged_paged.launch(q, kp, vp, table, ql, kl, None, None, d**-0.5,
                            kw.get("ctx_lo"), False, kw.get("window"),
                            "ragged_paged_attention", trace=trace)
    return o, ragged_paged.read_trace(trace.cpu(), qt, n_q // n_kv, width,
                                      page)


@pytest.mark.parametrize("case", ["mixed", "window64", "window1024", "ctx_lo",
                                  "decode16k"])
def test_ragged_grid_matches_cta_plan(dev, case):
    """The host mirror `cta_plan` lists exactly the CTAs the kernel ran,
    by kind, slot, tokens and chunks, for every kv head; every other CTA
    of the grid exits before any math; the output is the plain one."""
    kw = {}
    if case == "decode16k":
        page, n_kv, group, d, width = 128, 2, 4, 128, 128
        lengths = [16384, 9000, 0, 1, 4097]
        g = torch.Generator(device=dev).manual_seed(13)
        q = _rand(g, dev, torch.bfloat16, len(lengths), n_kv * group, 1, d)
        kp, vp, _, _ = _pool(g, dev, torch.bfloat16, None, 8, n_kv, page, d)
        table = torch.from_numpy(np.random.default_rng(13).integers(
            1, 8, size=(len(lengths), width)).astype(np.int32)).to(dev)
        kl = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ql = (kl > 0).to(torch.int32)
    else:
        q, kp, vp, table, ql, kl, _, _ = _ragged_case(dev, torch.bfloat16)
        if case.startswith("window"):
            kw["window"] = int(case[len("window"):])
        if case == "ctx_lo":
            kw["ctx_lo"] = torch.tensor([0, 256, 0, 128, 384, 128],
                                        dtype=torch.int32, device=dev)
    o, recs = _traced(q, kp, vp, table, ql, kl, **kw)
    n_q, qt = q.shape[1], q.shape[2]
    n_kv, page = kp.shape[1], kp.shape[2]
    plan = ragged_paged.cta_plan(
        ql.tolist(), kl.tolist(), qt, n_q // n_kv, page, table.shape[1],
        ctx_lo=None if "ctx_lo" not in kw else kw["ctx_lo"].tolist(),
        window=kw.get("window"), n_kv=n_kv)
    ch = paged_attention.KERNEL_PAGE_MULTIPLE
    for h in range(n_kv):
        ran = sorted((r["kind"], r["slot"], r["t0q"], r["a"] * ch,
                      r["e"] * ch + ch - 1) for r in recs
                     if r["head"] == h and r["kind"] != "exit")
        assert ran == sorted((k, s, t0, lo, hi)
                             for k, s, t0, _, lo, hi in plan), h
    assert sum(r["kind"] != "exit" for r in recs) == n_kv * len(plan)
    assert all(r["t1_ns"] >= r["t0_ns"] > 0 for r in recs)
    torch.testing.assert_close(o, ragged_paged.ragged_paged_reference(
        q, kp, vp, table, ql, kl, **kw), **TOL[torch.bfloat16])


def test_ragged_scratch_is_bounded_at_many_slots(dev):
    """256 slots at the serving engine's defaults (chunk 128, page 128, 64
    pages a sequence, 16 query heads on 4 kv heads): the split partials'
    scratch stays within SPLIT_CTAS's bound (17 MB here, where one
    partial slot per possible (block, split) would be 8.7 GB), the peak
    allocation of a launch is its output plus that scratch, and the first
    slots agree with the plain version run on them alone."""
    s, n_kv, group, qt, d, page, width = 256, 4, 4, 128, 128, 128, 64
    g = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)
    kl = torch.from_numpy(rng.integers(1, width * page, size=s).astype(
        np.int32)).to(dev)
    ql = torch.from_numpy(np.where(rng.random(s) < 0.5, 1, qt).astype(
        np.int32)).to(dev)
    kl = torch.maximum(kl, ql)
    q = _rand(g, dev, torch.bfloat16, s, n_kv * group, qt, d)
    kp, vp, _, _ = _pool(g, dev, torch.bfloat16, None, 33, n_kv, page, d)
    table = torch.from_numpy(rng.integers(1, 33, size=(s, width)).astype(
        np.int32)).to(dev)
    ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl)  # counters
    n_ws = ragged_paged.scratch_floats(s, n_kv, qt, group, d, width, page)
    bound = (2 * ragged_paged.SPLIT_CTAS * (16 + 64) * (d + 2))
    assert 0 < n_ws <= bound and 4 * n_ws < 20e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    o = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak <= o.numel() * o.element_size() + 4 * n_ws + (1 << 20)
    n = 6
    torch.testing.assert_close(o[:n], ragged_paged.ragged_paged_reference(
        q[:n], kp, vp, table[:n], ql[:n], kl[:n]), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,quant", [(torch.float32, "int8"),
                                         (torch.bfloat16, "fp8")])
def test_paged_kernel_quantized_matches_plain(dev, dtype, quant):
    page, n_kv, group, d, width, n_pages = 128, 2, 4, 128, 4, 32
    g = torch.Generator(device=dev).manual_seed(6)
    lengths = [0, 1, 37, page, 3 * page + 5, 4 * page]
    q = _rand(g, dev, dtype, len(lengths), n_kv, group, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = np.random.default_rng(6).permutation(n_pages - 1) + 1
    table = torch.from_numpy(perm[: len(lengths) * width].reshape(
        len(lengths), width).astype(np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    o = paged_attention.paged_decode_attention(q, kp, vp, table, lens,
                                               k_scales=ks, v_scales=vs)
    want = paged_attention.paged_decode_reference(q, kp, vp, table, lens,
                                                  k_scales=ks, v_scales=vs)
    torch.testing.assert_close(o, want, **TOL[dtype])
    assert (o[0] == 0).all()


# kernel vs plain backward: both compute in fp32 from the same inputs and
# differ only in summation order (and exp2 vs exp), so the error is
# rounding relative to the largest gradient entry
def _bwd_close(got, want, what, scale=None):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        err = float((a - b).abs().max())
        tol = 1e-4 * (float(b.abs().max()) if scale is None else scale) \
            + 1e-6
        assert err <= tol, f"{what} {name}: max-abs err {err} > {tol}"


def _bwd_case(dev, dtype, b, n, n_kv, s_q, s_kv, causal, seed=7, d=128,
              window=None, segs=None):
    """(do, q, k, v, delta, lse, scale, spec) of one backward round; lse
    and o from kernel 1 (its WIN / SEG instance with `window`, `segs`)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (_rand(g, dev, dtype, b, n, s_q, d) for _ in range(2))
    k, v = (_rand(g, dev, dtype, b, n_kv, s_kv, d) for _ in range(2))
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                                window=window, segments=segs, emit_o=True)
    delta = (o.float() * do.float()).sum(-1)
    return (do, q, k, v, delta, lse, d**-0.5, spec)


BWD_CASES = [
    (1, 4, 4, 256, 256, True),     # MHA causal
    (2, 8, 2, 200, 200, True),     # GQA causal, ragged edge
    (1, 8, 2, 192, 192, False),    # GQA non-causal
    (1, 4, 1, 96, 333, False),     # cross lengths, group 4
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,n_kv,s_q,s_kv,causal", BWD_CASES)
@pytest.mark.parametrize("fused", [None, False])
def test_flash_bwd_kernels_match_plain(dev, dtype, b, n, n_kv, s_q, s_kv,
                                       causal, fused):
    args = _bwd_case(dev, dtype, b, n, n_kv, s_q, s_kv, causal)
    before = dict(flash.flash_bwd.launches)
    got = flash.flash_bwd(*args, fused=fused)
    torch.cuda.synchronize()
    moved = {r: flash.flash_bwd.launches[r] - before[r]
             for r in flash.BWD_ROUTES}
    assert moved == ({"fused": 0, "dq": 1, "dkdv": 1} if fused is False
                     else {"fused": 1, "dq": 0, "dkdv": 0})
    _bwd_close(got, tile.tile_bwd(*args), f"{dtype} fused={fused}")
    # no atomics in either route's sums: a second launch is bitwise equal
    again = flash.flash_bwd(*args, fused=fused)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the split pair's bf16 instances on rounds that use every MaskSpec field:
# (s_q, s_kv, n, n_kv, (q_lo, q_hi, kv_hi, causal, offset))
SPLIT_ROUNDS = [
    (300, 260, 4, 2, (37, 250, 200, 1, -1)),  # cross lengths, ragged round
    (256, 256, 4, 4, (0, 256, 128, 0, 0)),    # zigzag: the first kv half
    (256, 256, 4, 4, (128, 256, 256, 0, 0)),  # zigzag: the second q half
    (256, 512, 8, 2, (0, 256, 512, 1, 256)),  # a positive offset
]


@pytest.mark.parametrize("s_q,s_kv,n,n_kv,spec", SPLIT_ROUNDS)
def test_flash_bwd_split_bf16_rounds_match_plain(dev, s_q, s_kv, n, n_kv,
                                                 spec):
    """Kernels 4-5 on the tensor cores against tile_bwd at the kernels'
    bar, two launches bitwise equal, and exact zeros for the rows outside
    [q_lo, q_hi) and the columns past kv_hi."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, do = (_rand(g, dev, torch.bfloat16, 1, n, s_q, 128) for _ in range(2))
    k, v = (_rand(g, dev, torch.bfloat16, 1, n_kv, s_kv, 128)
            for _ in range(2))
    spec = masks.MaskSpec(*spec)
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                                emit_o=True)
    args = (do, q, k, v, (o.float() * do.float()).sum(-1), lse, 128**-0.5,
            spec)
    got = flash.flash_bwd(*args, fused=False)
    again = flash.flash_bwd(*args, fused=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_close(got, tile.tile_bwd(*args), f"split bf16 {spec}")
    dq, dk, dv = got
    assert (dq[:, :, :spec.q_lo] == 0).all() and \
        (dq[:, :, spec.q_hi:] == 0).all()
    assert (dk[:, :, spec.kv_hi:] == 0).all() and \
        (dv[:, :, spec.kv_hi:] == 0).all()


def test_flash_bwd_split_bf16_dead_rows_give_zeros(dev):
    """The bf16 split pair on a contig future round (q_hi = 0) and on rows
    whose lse is -inf: every gradient exactly zero."""
    do, q, k, v, delta, lse, scale, _ = _bwd_case(dev, torch.bfloat16, 1, 4,
                                                  2, 128, 128, True)
    future = masks.round_spec(0, 1, 128, 128, True, "contig")
    dead = torch.full_like(lse, float("-inf"))
    for lse_, spec in ((lse, future), (dead, masks.full_spec(128, 128))):
        for a in flash.flash_bwd(do, q, k, v, delta, lse_, scale, spec,
                                 fused=False):
            assert (a == 0).all()


def test_flash_bwd_masked_rows_give_zeros(dev):
    """A contig future round (q_hi = 0) and rows with lse = -inf: every
    gradient is exactly zero on both routes."""
    do, q, k, v, delta, lse, scale, _ = _bwd_case(dev, torch.float32, 1, 4,
                                                  2, 128, 128, True)
    spec = masks.round_spec(0, 1, 128, 128, True, "contig")
    for fused in (None, False):
        for a in flash.flash_bwd(do, q, k, v, delta, lse, scale, spec,
                                 fused=fused):
            assert (a == 0).all()
        dead = torch.full_like(lse, float("-inf"))
        for a in flash.flash_bwd(do, q, k, v, delta, dead, scale,
                                 masks.full_spec(128, 128), fused=fused):
            assert (a == 0).all()


@pytest.mark.parametrize("n,n_kv", [(4, 4), (8, 2)])
def test_flash_bwd_fused_is_deterministic(dev, n, n_kv):
    """20 launches bitwise equal: the CTAs take their kv tiles from
    start-order tickets, and the dq fold order does not depend on the
    dispatch order."""
    args = _bwd_case(dev, torch.bfloat16, 1, n, n_kv, 1000, 1000, True)
    first = flash.flash_bwd(*args)
    for _ in range(19):
        again = flash.flash_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_fused_at_the_train_smoke_length(dev):
    """The fused kernel at the runner's longest shape (benchmarks/
    train_smoke.py: B1 N16 S32768 D128 bf16 causal; 8192 CTAs whose ordered
    dq fold takes its order from their tickets): it finishes, two launches are
    bitwise equal, and it agrees with the split pair (no fold).  Each of
    tile_bwd's fp32 score matrices would take 69 GB at this shape, so the
    split pair is the reference."""
    args = _bwd_case(dev, torch.bfloat16, 1, 16, 16, 32768, 32768, True)
    first = flash.flash_bwd(*args)
    again = flash.flash_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _bwd_close(first, flash.flash_bwd(*args, fused=False), "S=32768")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_plain(dev, causal):
    """Gradients through the autograd flash_attention (kernels) equal
    autograd through tile_fwd + finalize, fp32."""
    g = torch.Generator(device=dev).manual_seed(8)
    q = _rand(g, dev, torch.float32, 2, 8, 300, 128).requires_grad_()
    k = _rand(g, dev, torch.float32, 2, 2, 300, 128).requires_grad_()
    v = _rand(g, dev, torch.float32, 2, 2, 300, 128).requires_grad_()
    w = _rand(g, dev, torch.float32, 2, 8, 300, 128)
    got = torch.autograd.grad((flash.flash_attention(q, k, v, causal=causal)
                               * w).sum(), (q, k, v))
    o = tile.single_device_attention(q, k, v, causal=causal)
    want = torch.autograd.grad((o * w).sum(), (q, k, v))
    _bwd_close(got, want, f"autograd causal={causal}")


# ---------------------------------------------------------------------------
# kernels 1-3's bf16 instances on the tensor cores (csrc/flash_fwd.cu's and
# csrc/flash_bwd.cu's fused kernel's mma.sync tiles)

# chip_smoke.py's kernel-1 tolerances: m, lse (fp32 from bf16 inputs) and
# the raw fp32 accumulator relative to its largest entry
STATS_ATOL_BF16, ACC_RTOL = 1e-3, 1e-4
S_RING = 512  # a scan-ring round's local length


def _fwd_pair(dev, n, n_kv, s_q, s_kv, spec, carry, window=None,
              emit_o=True, seed=20):
    """(kernel, plain) (m, lse, acc-or-o) of one bf16 round, the carry (a
    first round's state over other keys) from the plain tile."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    q = _rand(g, dev, bf16, 1, n, s_q, 128)
    k, v, k0, v0 = (_rand(g, dev, bf16, 1, n_kv, s_kv, 128)
                    for _ in range(4))
    st = tile.init_state(1, n, s_q, 128, device=dev)
    if carry:
        st = tile.tile_fwd(q, k0, v0, *st, 128**-0.5,
                           masks.full_spec(s_q, s_kv))
    before = flash.flash_fwd.launches
    got = flash.flash_fwd(q, k, v, *(st if carry else (None,) * 3),
                          128**-0.5, spec, window=window, emit_o=emit_o)
    torch.cuda.synchronize()
    assert flash.flash_fwd.launches == before + 1
    want = tile.tile_fwd(q, k, v, *st, 128**-0.5, spec, window=window)
    if emit_o:
        want = (*want[:2], tile.finalize(*want, bf16))
    return got, want


def _fwd_close(got, want, emit_o, what):
    (m, lse, x), (wm, wlse, wx) = got, want
    assert torch.equal(torch.isinf(lse), torch.isinf(wlse)), what
    fin = torch.isfinite(wlse)
    if fin.any():
        assert float((lse - wlse)[fin].abs().max()) <= STATS_ATOL_BF16, what
        assert float((m - wm)[fin].abs().max()) <= STATS_ATOL_BF16, what
    if emit_o:
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, wx, **TOL[torch.bfloat16], msg=what)
        assert (x[~fin] == 0).all(), what  # empty rows: 0, not NaN
    else:
        err = float((x - wx).abs().max())
        assert err <= ACC_RTOL * float(wx.abs().max()), (what, err)


# (name, heads, kv heads, s_q, s_kv, spec, carry): causal, ragged S,
# non-causal with a carry, G = 1, 4 and 16, cross lengths, and the scan
# ring's masked rounds at its local length with a carry (zigzag: the
# diagonal, kv < q (the first kv half), kv > q (the second q half);
# striped kv > q: offset -1; contig's future round: every row empty)
def _ring_spec(q_part, kv_part, layout):
    return masks.round_spec(q_part, kv_part, S_RING, S_RING, True, layout)


FWD_BF16_CASES = [
    ("causal", 16, 4, 2048, 2048, masks.MaskSpec(0, 2048, 2048, 1, 0),
     False),
    ("ragged", 16, 4, 1000, 1000, masks.MaskSpec(0, 1000, 1000, 1, 0),
     False),
    ("carry non-causal", 16, 4, 1024, 1024, masks.full_spec(1024, 1024),
     True),
    ("G1", 4, 4, 333, 333, masks.MaskSpec(0, 333, 333, 1, 0), False),
    ("G4", 8, 2, 333, 333, masks.MaskSpec(0, 333, 333, 1, 0), False),
    ("G16", 16, 1, 333, 333, masks.MaskSpec(0, 333, 333, 1, 0), False),
    ("cross", 4, 1, 96, 333, masks.full_spec(96, 333), True),
    ("zigzag diagonal", 16, 4, S_RING, S_RING, _ring_spec(1, 1, "zigzag"),
     True),
    ("zigzag kv < q", 16, 4, S_RING, S_RING, _ring_spec(3, 1, "zigzag"),
     True),
    ("zigzag kv > q", 16, 4, S_RING, S_RING, _ring_spec(1, 3, "zigzag"),
     True),
    ("striped kv > q", 16, 4, S_RING, S_RING, _ring_spec(0, 1, "striped"),
     True),
    ("q_lo q_hi kv_hi offset", 8, 2, 300, 300,
     masks.MaskSpec(37, 250, 290, 1, 5), True),
    ("contig future", 8, 2, 256, 256, masks.MaskSpec(0, 0, 256, 1, 0),
     False),
]


@pytest.mark.parametrize("emit_o", [True, False])
@pytest.mark.parametrize("name,n,n_kv,s_q,s_kv,spec,carry", FWD_BF16_CASES)
def test_flash_kernel_bf16_matches_plain(dev, name, n, n_kv, s_q, s_kv, spec,
                                         carry, emit_o):
    got, want = _fwd_pair(dev, n, n_kv, s_q, s_kv, spec, carry,
                          emit_o=emit_o)
    _fwd_close(got, want, emit_o, name)


@pytest.mark.parametrize("offset,kv_hi,carry", [(0, 2048, False),
                                                (-1, 2011, True)])
def test_flash_kernel_bf16_window_1024(dev, offset, kv_hi, carry):
    """Window 1024 at the serving prefill's length; window >= S is bitwise
    the unwindowed kernel."""
    spec = masks.MaskSpec(0, 2048, kv_hi, 1, offset)
    got, want = _fwd_pair(dev, 16, 4, 2048, 2048, spec, carry, window=1024)
    _fwd_close(got, want, True, f"window 1024 offset {offset}")
    wide, _ = _fwd_pair(dev, 16, 4, 2048, 2048, spec, carry, window=2048)
    full, _ = _fwd_pair(dev, 16, 4, 2048, 2048, spec, carry)
    assert all(torch.equal(a, b) for a, b in zip(wide, full))


# the prefix cache's suffix prefill: t_suf queries (padded to the 128-token
# page) after t_pre cached keys, causal at offset t_pre, GQA 16/4
SUFFIX_SPECS = [(t_pre, t_suf) for t_pre in (128, 1024, 1920)
                for t_suf in (1, 17, 128, 300)]


def _suffix_close(dev, dtype, t_pre, t_suf, window=None):
    t_pad = -(-t_suf // 128) * 128
    spec = masks.MaskSpec(0, t_suf, t_pre + t_suf, 1, t_pre)
    what = f"suffix t_pre {t_pre} t_suf {t_suf} window {window} {dtype}"
    if dtype == torch.bfloat16:
        got, want = _fwd_pair(dev, 16, 4, t_pad, t_pre + t_pad, spec, False,
                              window=window)
        _fwd_close(got, want, True, what)
    else:
        g = torch.Generator(device=dev).manual_seed(t_pre + t_suf)
        q = _rand(g, dev, dtype, 1, 16, t_pad, 128)
        k, v = (_rand(g, dev, dtype, 1, 4, t_pre + t_pad, 128)
                for _ in range(2))
        got = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                              window=window, emit_o=True)
        st = tile.tile_fwd(q, k, v, *tile.init_state(1, 16, t_pad, 128,
                                                     device=dev),
                           128**-0.5, spec, window=window)
        want = (*st[:2], tile.finalize(*st, dtype))
        assert torch.equal(torch.isinf(got[1]), torch.isinf(want[1])), what
        torch.testing.assert_close(got[2], want[2], **TOL[dtype], msg=what)
    assert not got[2][:, :, t_suf:].any(), what  # pad rows give 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_pre,t_suf", SUFFIX_SPECS)
def test_flash_kernel_suffix_specs_match_plain(dev, dtype, t_pre, t_suf):
    _suffix_close(dev, dtype, t_pre, t_suf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_suffix_spec_with_window(dev, dtype):
    _suffix_close(dev, dtype, 1024, 300, window=256)


@pytest.mark.parametrize("b,n,n_kv,s_q,s_kv,causal", BWD_CASES)
def test_flash_bwd_fused_bf16_is_bitwise_repeatable(dev, b, n, n_kv, s_q,
                                                    s_kv, causal):
    """The bf16 fused kernel (tensor cores) against tile_bwd on every
    BWD_CASES shape, and 20 launches bitwise equal."""
    args = _bwd_case(dev, torch.bfloat16, b, n, n_kv, s_q, s_kv, causal,
                     seed=13)
    first = flash.flash_bwd(*args)
    _bwd_close(first, tile.tile_bwd(*args), "bf16 fused")
    for _ in range(19):
        again = flash.flash_bwd(*args)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


@pytest.mark.parametrize("spec", [
    masks.MaskSpec(0, 0, 256, 1, 0),          # contig future round
    masks.MaskSpec(128, 256, 256, 0, 0),      # zigzag kv > q
    masks.MaskSpec(0, 256, 128, 0, 0),        # zigzag kv < q
    masks.MaskSpec(0, 256, 256, 1, -1),       # striped kv > q
    masks.MaskSpec(37, 250, 200, 1, 5),
])
def test_flash_bwd_fused_bf16_masked_rounds(dev, spec):
    """The bf16 fused kernel under the scan ring's masks (and a mask with
    every scalar set) against tile_bwd; rows with lse = -inf give exact
    zeros."""
    do, q, k, v, _, _, scale, _ = _bwd_case(dev, torch.bfloat16, 1, 8, 2,
                                            256, 256, True, seed=14)
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, scale, spec,
                                emit_o=True)
    delta = (o.float() * do.float()).sum(-1)
    args = (do, q, k, v, delta, lse, scale, spec)
    got = flash.flash_bwd(*args)
    _bwd_close(got, tile.tile_bwd(*args), f"bf16 fused {spec}")
    dead = torch.isneginf(lse)
    assert (got[0][dead] == 0).all()
    if not (~dead).any():
        assert all((a == 0).all() for a in got)
    zero = flash.flash_bwd(do, q, k, v, delta, torch.full_like(lse, -math.inf),
                           scale, masks.full_spec(256, 256))
    assert all((a == 0).all() for a in zero)


# (registers, local bytes) a thread of the fused backward tiles' instances
# as built before the split pair moved onto the tensor cores (commit
# e0c6a62, this toolkit): the split pair shares their tile, and their code
# must not move with it
FUSED_TILE_ATTRS = {"flash_bwd": {"bf16 fused": (255, 8),
                                  "fp32 fused": (208, 0)},
                    "fused_ring_bwd": {"bf16": (255, 32),
                                       "bf16 traced": (255, 128),
                                       "fp32": (255, 16)}}


def test_flash_kernel_attributes(dev):
    """cudaFuncGetAttributes of kernels 1-5's instances: registers fit the
    launch, the bf16 tiles keep the shared memory their launches size,
    kernel 1's bf16 instances and kernel 4's keep two CTAs an SM, the
    split pair spills nothing, and the fused tiles' instances (kernels 2-3
    and 9) keep the registers and local bytes they had."""
    fwd, bwd = flash.fwd_attrs(), flash.bwd_attrs()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert [a["instance"] for a in fwd] == ["bf16", "bf16 acc",
                                            "bf16 window", "fp32"]
    assert [a["instance"] for a in bwd] == ["bf16 fused", "fp32 fused",
                                            "bf16 dq", "bf16 dkdv"]
    for a in fwd + bwd:
        assert 0 < a["regs"] <= 255 and a["ctas"] >= sms, a
        print(a)
    for a in fwd[:3]:
        assert a["smem"] == 2 * 5 * 64 * 136 and a["ctas"] == 2 * sms, a
    tile_smem = 2 * (6 * 64 * 136 + 2 * 64 * 72) + 16 * 2048 + 4 * 128
    assert bwd[0]["smem"] == tile_smem
    dq, dkdv = bwd[2:]
    assert dq["smem"] == 2 * 6 * 64 * 136 and dq["ctas"] == 2 * sms, dq
    assert dkdv["smem"] == tile_smem, dkdv
    assert dq["local_bytes"] == 0 and dkdv["local_bytes"] == 0, bwd[2:]
    now = {"flash_bwd": bwd, "fused_ring_bwd": fused_ring_bwd.bwd_attrs()}
    for lib, want in FUSED_TILE_ATTRS.items():
        got = {a["instance"]: (a["regs"], a["local_bytes"]) for a in now[lib]}
        assert {k: got[k] for k in want} == want, (lib, got)


@pytest.mark.parametrize("kw", [{}, {"prefix_cache": True},
                                {"quantize": "int8"},
                                {"pipeline": True, "multi_step": 4},
                                {"prefix_cache": True, "pipeline": True,
                                 "multi_step": 4},
                                {"quantize": "fp8", "pipeline": True,
                                 "multi_step": 4}])
def test_ragged_engine_on_the_card_matches_the_cpu_engine(dev, kw):
    """fp32 model: the ragged engine through the kernel is token-exact
    with the plain CPU engine on the same weights."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_head=128, d_ff=512, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    tmpl = rng.integers(1, cfg.vocab, size=256)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (9, 130, 300)]
    prompts += [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t)])
                for t in (0, 40)]
    out = {}
    for where in ("cpu", dev):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        eng = RaggedServeEngine(p, cfg, slots=3, n_pages=24,
                                max_pages_per_seq=4, chunk=64, device=where,
                                **kw)
        eng.submit(prompts[3], 2)
        eng.run()  # registers the template when the cache is on
        for pr in prompts:
            eng.submit(pr, 7)
        before = ragged_paged.ragged_paged_attention.launches
        out[str(where)] = eng.run()
        moved = ragged_paged.ragged_paged_attention.launches - before
        assert (moved == 0) if str(where) == "cpu" else (moved > 0)
        assert eng.stats["burst.fused_fallback{pass=serve,reason=head-dim}"] \
            == 0
    assert out["cpu"] == out[str(dev)]


def _serving_model(dev, dtype=torch.float32, **kw):
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_head=128, d_ff=512, dtype=dtype, **kw)
    return cfg, init_params(cfg, seed=0, device=dev)


# an MoE serving model: 8 experts, top-2, the dense forward drop-free
MOE_KW = dict(n_experts=8, moe_top_k=2, moe_capacity_factor=4.0)


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_multi_step_graph_replay_matches_eager_ticks(dev, sampling):
    """multi_step_decode's CUDA graph replay against K eager ticks from
    the same state: equal choices, lengths and generator state, twice
    (the second replay reuses the capture); a replay counts K launches a
    layer of kernel 7, the capture none."""
    _check_graph_replay(dev, sampling, {})


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_moe_multi_step_graph_replay_matches_eager_ticks(dev, sampling):
    """The same for an MoE model: its routing (top-k, slot assignment by
    cumsum, gathers) captures with fixed shapes and replays exactly."""
    _check_graph_replay(dev, sampling, MOE_KW)


def _check_graph_replay(dev, sampling, model_kw):
    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.serving import model as sm

    cfg, params = _serving_model(dev, **model_kw)
    st, _ = pd.init_paged_state(cfg, slots=3, n_pages=8, page=128,
                                max_pages_per_seq=3, device=dev)
    for slot, row in ((0, [1, 2, 3]), (1, [4, 5, 6])):
        sm.assign_pages(st, slot, row)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab, (3, 100), generator=g).to(dev)
    q_lens = torch.tensor([100, 37, 0], dtype=torch.int32, device=dev)
    logits, _ = sm.ragged_model_step(params, toks, q_lens, st, cfg)
    first = logits.argmax(-1)
    live = torch.tensor([1, 1, 0], dtype=torch.int32, device=dev)
    lengths = st.lengths.clone()
    gen = torch.Generator(device=dev).manual_seed(3)
    s0 = gen.get_state()
    k = 4
    feed, rows = first, []
    for _ in range(k):
        feed, _ = sm.pipelined_tick(params, feed[:, None], live, st, gen,
                                    cfg, **sampling)
        rows.append(feed)
    eager, eager_len, eager_gen = (torch.stack(rows), st.lengths.clone(),
                                   gen.get_state())
    graphs = sm.DecodeGraphs(params, st, cfg, gen)
    per_replay = k * cfg.n_layers
    for turn in range(2):
        st.lengths.copy_(lengths)
        gen.set_state(s0)
        before = ragged_paged.ragged_paged_attention.launches
        choices, _, _ = sm.multi_step_decode(params, first, live, st, gen,
                                             cfg, k=k, graphs=graphs,
                                             **sampling)
        torch.cuda.synchronize()
        assert torch.equal(choices, eager), turn
        assert torch.equal(st.lengths, eager_len), turn
        assert torch.equal(gen.get_state(), eager_gen), turn
        # the first call's capture warm-up launched k ticks at q_len 0
        moved = ragged_paged.ragged_paged_attention.launches - before
        assert moved == per_replay * (2 if turn == 0 else 1), (turn, moved)
    assert graphs.captures == 1 and graphs.replays == 2


class _SyncChecked(RaggedServeEngine):
    """A pipelined engine whose speculative dispatches run under
    torch.cuda.set_sync_debug_mode("error") once `checking` is set: any
    host sync in them raises."""
    checking = False
    checked = 0

    def _launch_speculative(self, k):
        if not self.checking:
            return super()._launch_speculative(k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            p = super()._launch_speculative(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        self.checked += 1
        return p


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_speculative_dispatch_never_syncs(dev, sampling):
    """A pipelined K=4 engine serves a workload twice (the first run
    captures every graph it needs, since a capture synchronizes); in the
    second every speculative dispatch runs under sync-debug "error".
    Both runs equal the synchronous engine's from the same seed."""
    _check_dispatch_never_syncs(dev, sampling, {})


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_moe_speculative_dispatch_never_syncs(dev, sampling):
    """The same for an MoE model: its routing reads nothing back."""
    _check_dispatch_never_syncs(dev, sampling, MOE_KW)


def _check_dispatch_never_syncs(dev, sampling, model_kw):
    cfg, params = _serving_model(dev, **model_kw)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (40, 130, 77)]
    kw = dict(slots=3, n_pages=16, max_pages_per_seq=4, chunk=64,
              device=dev, **sampling)

    def serve(eng):
        rids = [eng.submit(p, 14) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    eng = _SyncChecked(params, cfg, pipeline=True, multi_step=4,
                       rng=torch.Generator(device=dev).manual_seed(5), **kw)
    ref = RaggedServeEngine(params, cfg,
                            rng=torch.Generator(device=dev).manual_seed(5),
                            **kw)
    assert serve(eng) == serve(ref)
    captures = eng.graphs.captures
    eng.checking = True
    assert serve(eng) == serve(ref)
    assert eng.checked > 0 and eng.graphs.captures == captures
    assert eng.stats["serve.multi_step_launches{k=4}"] > 0


def test_prefix_cache_serve_engine_on_the_card_matches_the_cpu_engine(dev):
    """fp32 ServeEngine(prefix_cache=True): the suffix prefill through
    kernel 1's offset mask gives the plain CPU engine's tokens, and the
    cache-off engine's."""
    cfg, params = _serving_model("cpu")
    rng = np.random.default_rng(8)
    tmpl = rng.integers(1, cfg.vocab, size=256)
    prompts = [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t)])
               for t in (1, 40, 100)] + [tmpl]
    out = {}
    for where, cache in (("cpu", True), (dev, True), (dev, False)):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        eng = ServeEngine(p, cfg, slots=2, n_pages=16, max_pages_per_seq=4,
                          prefix_cache=cache, device=where)
        for pr in prompts:
            eng.submit(pr, 6)
        before = flash.flash_fwd.launches
        out[(str(where), cache)] = eng.run()
        moved = flash.flash_fwd.launches - before
        assert (moved == 0) if str(where) == "cpu" else \
            (moved == cfg.n_layers * len(prompts))
        if cache:
            assert len(eng.cache) == 2
    assert out[("cpu", True)] == out[(str(dev), True)] == \
        out[(str(dev), False)]


@pytest.mark.parametrize("tp,quantize,cache", [(2, False, True),
                                               (2, "int8", True),
                                               (4, False, False)])
def test_tp_serve_engine_on_the_card_matches_unsharded(dev, tp, quantize,
                                                       cache):
    """fp32 ServeEngine(mesh={"tp": T}) on the card (the parameters and the
    pool's kv heads split over T positions): the unsharded engine's tokens
    (and the plain CPU tp engine's), with the prefix cache and an int8
    pool; every tp position launches its own kernels: kernel 1 T times a
    prompt's layer (or its suffix's) and kernel 6 a multiple of T x
    layers."""
    cfg = ModelConfig(vocab=512, d_model=512, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_head=128, d_ff=1024,
                      dtype=torch.float32, batch_axis=None, head_axis=None)
    cfgt = dataclasses.replace(cfg, head_axis="tp")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(17)
    tmpl = rng.integers(1, cfg.vocab, size=256)
    prompts = [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t)])
               for t in (1, 40, 100)]
    kw = dict(slots=2, n_pages=16, max_pages_per_seq=4, quantize=quantize,
              prefix_cache=cache)
    out = {}
    for where, mesh_ in (("cpu", {"tp": tp}), (dev, None), (dev, {"tp": tp})):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        eng = ServeEngine(p, cfgt if mesh_ else cfg, mesh=mesh_,
                          device=where, **kw)
        for pr in prompts:
            eng.submit(pr, 6)
        before = (flash.flash_fwd.launches,
                  paged_attention.paged_decode_attention.launches)
        out[(str(where), mesh_ is not None)] = eng.run()
        moved = [a - b for a, b in zip(
            (flash.flash_fwd.launches,
             paged_attention.paged_decode_attention.launches), before)]
        if str(where) == "cpu":
            assert moved == [0, 0]
        else:
            t = tp if mesh_ else 1
            assert moved[0] == t * cfg.n_layers * len(prompts), moved
            assert moved[1] > 0 and moved[1] % (t * cfg.n_layers) == 0
        assert eng.pool.available == 15 - (len(eng.cache) if cache else 0)
    assert out[(str(dev), True)] == out[(str(dev), False)] == \
        out[("cpu", True)]


def test_mesh_train_step_on_the_card_matches_the_cpu(dev):
    """Two fp32 train steps on a dp=2 sp=2 tp=2 mesh (2 layers, remat, the
    fused ring) on the card equal the same steps on the CPU (loss and grad
    norm to 1e-5) and one device's first loss and grad norm; kernel 8
    launches twice and kernel 9 once a layer and a dp group (the tp
    positions' heads in one launch)."""
    cfg = ModelConfig(vocab=512, d_model=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=1024,
                      dtype=torch.float32, attn_backend="fused_ring")
    mesh_ = train.make_mesh({"dp": 2, "sp": 2, "tp": 2})
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_batch(3, cfg, mesh_, batch=2, seq=512,
                                 device=where)
        metrics = []
        for _ in range(2):
            counts = (fused_ring.fused_ring_fwd.launches,
                      fused_ring_bwd.fused_ring_bwd.launches)
            state, m_ = step(state, batch)
            metrics.append((float(m_["loss"]), float(m_["grad_norm"])))
            got = (fused_ring.fused_ring_fwd.launches - counts[0],
                   fused_ring_bwd.fused_ring_bwd.launches - counts[1])
            per = cfg.n_layers * 2
            assert got == ((0, 0) if where == "cpu" else (2 * per, per)), \
                got
        out[str(where)] = metrics
    np.testing.assert_allclose(out[str(dev)], out["cpu"], rtol=1e-5)
    one_cfg = dataclasses.replace(cfg, layout="contig", attn_backend="auto")
    one = train.init_train_state(0, one_cfg, tcfg, device=dev)
    _, m1 = train.make_train_step(one_cfg, tcfg, device=dev)(
        one, train.make_batch(3, one_cfg, batch=2, seq=512, device=dev))
    np.testing.assert_allclose(
        [float(m1["loss"]), float(m1["grad_norm"])], out[str(dev)][0],
        rtol=1e-5)


@pytest.mark.parametrize("n_heads,n_kv", [(2, 2), (4, 2)])
def test_train_step_on_the_card_matches_the_cpu(dev, n_heads, n_kv):
    """Two fp32 train steps (remat on) through the kernels equal the same
    steps with the plain versions on the CPU, same weights and batch: the
    forward runs twice per layer (remat) and the fused backward once.
    Loss and grad_norm of both steps agree to fp32 summation order, and so
    does every clipped gradient of the first step, relative to its largest
    entry.  Parameters are not compared: AdamW's first update is +-lr for
    any gradient above eps, so an entry whose gradient is near zero takes
    either sign from rounding alone."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=n_heads,
                      n_kv_heads=n_kv, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None)
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, device=where)
        step = train.make_train_step(cfg, tcfg, device=where)
        batch = train.make_batch(1, cfg, batch=2, seq=200, device=where)
        fwd0, bwd0 = flash.flash_fwd.launches, dict(flash.flash_bwd.launches)
        metrics = []
        for i in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        moved = (flash.flash_fwd.launches - fwd0,
                 {r: flash.flash_bwd.launches[r] - bwd0[r]
                  for r in flash.BWD_ROUTES})
        want = (0, dict.fromkeys(flash.BWD_ROUTES, 0)) if where == "cpu" \
            else (2 * 2 * cfg.n_layers, {"fused": 2 * cfg.n_layers, "dq": 0,
                                         "dkdv": 0})
        assert moved == want, moved
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    assert mg[1][0] < mg[0][0]
    for a, b in zip(gg, gc):
        torch.testing.assert_close(
            a, b, atol=1e-4 * float(b.abs().max()) + 1e-12, rtol=0)


# -- the fused ring forward (kernel 8) ---------------------------------------

# (positions, layout, causal, heads, kv heads, local S, dtype, knobs)
FUSED_CASES = [
    (2, "zigzag", True, 4, 2, 256, torch.float32, {}),
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16, {}),
    (4, "striped", True, 4, 4, 256, torch.float32, dict(fused_kv_slots=3)),
    (4, "contig", True, 4, 1, 512, torch.bfloat16, {}),
    (3, "zigzag", False, 4, 2, 256, torch.float32,
     dict(fused_topology="bidi")),
    (5, "striped", True, 4, 2, 256, torch.bfloat16,
     dict(fused_topology="bidi", fused_ccw_slots=3)),
    (4, "zigzag", True, 4, 2, 256, torch.float32, dict(two_axis=(2, 2))),
    (8, "zigzag", True, 4, 2, 256, torch.bfloat16,
     dict(fused_seq_factor=(2, 4))),
    # more q tiles than resident CTAs: the state goes through scratch
    (8, "zigzag", True, 16, 4, 1024, torch.bfloat16, {}),
    (4, "striped", False, 32, 8, 1024, torch.float32, {}),
]


def _fused_case(dev, w, layout, causal, n, n_kv, s, dtype, knobs, seed=0):
    knobs = dict(knobs)
    n_inter, n_intra = knobs.pop("two_axis", (1, w))
    axes = ("inter", "intra") if n_inter > 1 else ("sp",)
    cfg = burst.BurstConfig(causal=causal, layout=layout,
                            backend="fused_ring", intra_axis=axes[-1],
                            inter_axis=axes[0] if n_inter > 1 else None,
                            **knobs)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _rand(g, dev, dtype, w, 1, n, s, 128)
    k, v = (_rand(g, dev, dtype, w, 1, n_kv, s, 128) for _ in range(2))
    assert fused_ring.supported(cfg, q.shape[1:], k.shape[1:], world=n_intra,
                                n_inter=n_inter, dtype=dtype,
                                device=dev) is None
    topo = fused_ring.resolve_topology(cfg, n_intra, n_inter)
    prog = fused_ring._compile_for(cfg, *topo, s=s)
    tables = [fused_ring.build_sched_table(cfg, prog, s, s, p)[0]
              for p in range(w)]
    return cfg, (n_inter, n_intra), (q, k, v), prog, tables


@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs",
                         FUSED_CASES)
def test_fused_ring_kernel_matches_plain(dev, w, layout, causal, n, n_kv, s,
                                         dtype, knobs):
    cfg, ring, qkv, prog, tables = _fused_case(dev, w, layout, causal, n,
                                               n_kv, s, dtype, knobs)
    before = fused_ring.fused_ring_fwd.launches
    o, lse = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
    o2, lse2 = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
    torch.cuda.synchronize()
    assert fused_ring.fused_ring_fwd.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fused_ring.fused_ring_reference(*qkv, prog, tables,
                                               128 ** -0.5)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


def test_fused_ring_kernel_reuses_slots_without_a_race(dev):
    """W=8 on two slots: every slot is rewritten four times a launch; 20
    launches must agree bit for bit."""
    cfg, ring, qkv, _, _ = _fused_case(dev, 8, "zigzag", True, 8, 2, 512,
                                       torch.bfloat16, {}, seed=3)
    first = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
    for _ in range(19):
        again = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("layout", ["zigzag", "striped", "contig"])
def test_burst_attn_fused_matches_scan(dev, layout):
    """burst_attn through kernel 8 against the scan ring over kernel 1
    (bf16, GQA, sp=4): one fused launch, no fallback; the scan ring
    launches kernel 1 once per live round of each position."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = _rand(g, dev, torch.bfloat16, 1, 8, 2048, 128)
    k, v = (_rand(g, dev, torch.bfloat16, 1, 2, 2048, 128) for _ in range(2))
    q, k, v = (layouts.to_layout(t, layout, 4, 2) for t in (q, k, v))
    before = obs.counter_values()
    f0, k0 = flash.flash_fwd.launches, fused_ring.fused_ring_fwd.launches
    fused = burst.burst_attn(q, k, v, mesh={"sp": 4}, causal=True,
                             layout=layout, backend="fused_ring")
    assert (flash.flash_fwd.launches - f0,
            fused_ring.fused_ring_fwd.launches - k0) == (0, 1)
    scan = burst.burst_attn(q, k, v, mesh={"sp": 4}, causal=True,
                            layout=layout, backend="auto")
    live = 10 if layout == "contig" else 16  # contig skips future rounds
    assert flash.flash_fwd.launches - f0 == live
    assert not any(key.startswith("burst.fused_fallback")
                   for key in obs.counter_deltas(before))
    torch.testing.assert_close(fused, scan, **TOL[torch.bfloat16])
    plain = burst.burst_attn(q.float(), k.float(), v.float(), mesh={"sp": 4},
                             causal=True, layout=layout, backend="jnp")
    torch.testing.assert_close(fused.float(), plain, atol=2e-3, rtol=1.6e-2)


# -- the fused ring backward (kernel 9) ---------------------------------------

# (positions, layout, causal, heads, kv heads, local S, dtype, knobs)
FUSED_BWD_CASES = [
    # one kv tile per CTA: dk, dv stay in registers across the rounds
    (2, "zigzag", True, 2, 1, 256, torch.float32, {}),
    (4, "striped", True, 4, 2, 256, torch.bfloat16,
     dict(fused_bwd_slots=3, optimize_bwd_comm=False)),
    (5, "zigzag", True, 4, 2, 256, torch.float32,
     dict(fused_topology="bidi")),
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16, dict(two_axis=(2, 2))),
    # a truncated contig program: 3 live rounds of 4
    (4, "contig", True, 4, 2, 256, torch.float32, dict(max_segment_len=300)),
    (3, "zigzag", False, 4, 4, 256, torch.float32, {}),
    # ragged tiles: S_local 200 is no multiple of the 64-row tiles
    (3, "zigzag", True, 4, 2, 200, torch.float32, {}),
    (2, "contig", True, 8, 2, 200, torch.bfloat16,
     dict(optimize_bwd_comm=False)),
    # more kv tiles than resident CTAs: dk, dv go through the outputs
    (8, "zigzag", True, 16, 4, 1024, torch.bfloat16, {}),
]


def _ring_bwd_case(dev, w, layout, causal, n, n_kv, s, dtype, knobs, seed=0):
    """(cfg, ring, (q, k, v, o, lse, do) stacked, bwd program, tables): o
    and lse from kernel 8."""
    cfg, ring, (q, k, v), _, _ = _fused_case(dev, w, layout, causal, n,
                                             n_kv, s, dtype, knobs, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = _rand(g, dev, dtype, *q.shape)
    assert fused_ring.supported(cfg, q.shape[1:], k.shape[1:], world=ring[1],
                                n_inter=ring[0], pass_="bwd", dtype=dtype,
                                device=dev) is None
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
    prog, tables, _ = fused_ring.ring_plan(cfg, *ring, s, "bwd")
    return cfg, ring, (q, k, v, o, lse, do), prog, tables


def _close_to_max(got, want, rtol=1e-4):
    """Each of got within rtol of the largest entry of its want: fp32
    gradients differing in summation order (chip_smoke's BWD_RTOL)."""
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a, b, atol=rtol * float(b.abs().max()) + 1e-6, rtol=0)


@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs",
                         FUSED_BWD_CASES)
def test_fused_ring_bwd_kernel_matches_plain(dev, w, layout, causal, n, n_kv,
                                             s, dtype, knobs):
    cfg, ring, args, prog, tables = _ring_bwd_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs)
    before = fused_ring_bwd.fused_ring_bwd.launches
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    torch.cuda.synchronize()
    assert fused_ring_bwd.fused_ring_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm)
    _close_to_max(got, want)


def test_fused_ring_bwd_kernel_is_bitwise_repeatable(dev):
    """W=8 on two slots: every bundle and dq slot is rewritten several
    times a launch; 20 launches must agree bit for bit."""
    cfg, ring, args, _, _ = _ring_bwd_case(dev, 8, "zigzag", True, 8, 2,
                                           512, torch.bfloat16, {}, seed=3)
    first = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    for _ in range(19):
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("layout", ["zigzag", "striped", "contig"])
def test_burst_attn_gradients_fused_match_scan(dev, layout):
    """burst_attn's gradients through kernels 8 and 9 (one launch each)
    against the scan ring over the flash kernels (bf16, GQA, sp=4), no
    fallback; both against the plain ring on the same bf16 tensors, whose
    forward rounds o to bf16 as kernel 8 does.  That rounding moves delta
    = sum(o * do) and so the gradients, which is why an fp32 ring is not
    the reference here: the fp32 plain ring's backward run from kernel 8's
    bf16-rounded o holds kernel 9 to fp32 summation order, and the line
    printed says how far the fp32 ring's own o moves the gradients."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = [_rand(g, dev, torch.bfloat16, 1, h, 2048, 128) for h in (8, 2, 2)]
    do = _rand(g, dev, torch.bfloat16, 1, 8, 2048, 128)
    x = [layouts.to_layout(t, layout, 4, 2) for t in x]
    do = layouts.to_layout(do, layout, 4, 2)
    kw = dict(mesh={"sp": 4}, causal=True, layout=layout)

    def grads(backend):
        leaves = [t.detach().requires_grad_() for t in x]
        o = burst.burst_attn(*leaves, backend=backend, **kw)
        return torch.autograd.grad(o, leaves, do)

    before = obs.counter_values()
    counts = lambda: (fused_ring.fused_ring_fwd.launches,  # noqa: E731
                      fused_ring_bwd.fused_ring_bwd.launches,
                      flash.flash_fwd.launches,
                      flash.flash_bwd.launches["fused"])
    c0 = counts()
    fused = grads("fused_ring")
    c1 = counts()
    scan = grads("auto")
    c2 = counts()
    live = 10 if layout == "contig" else 16  # contig skips future rounds
    assert [b - a for a, b in zip(c0, c1)] == [1, 1, 0, 0]
    assert [b - a for a, b in zip(c1, c2)] == [0, 0, live, live]
    assert not any(key.startswith("burst.fused_fallback")
                   for key in obs.counter_deltas(before))
    plain = grads("jnp")
    for a, b, c in zip(fused, scan, plain):
        tol = dict(atol=1e-3 * float(c.float().abs().max()), rtol=1.6e-2)
        torch.testing.assert_close(a, b, **tol)
        torch.testing.assert_close(a, c, **tol)

    cfg = burst.BurstConfig(backend="fused_ring", causal=True, layout=layout)
    qs, ks, vs, dos = (mesh.shard(t, 4) for t in (*x, do))
    o, lse = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, 4)
    k9 = fused_ring_bwd.fused_ring_bwd(qs, ks, vs, o, lse, dos, cfg, 1, 4)
    f32 = [t.float() for t in (qs, ks, vs)]
    fprog, ftables, _ = fused_ring.ring_plan(cfg, 1, 4, 512, "fwd")
    o32, lse32 = fused_ring.fused_ring_reference(*f32, fprog, ftables,
                                                 128 ** -0.5)
    prog, tables, _ = fused_ring.ring_plan(cfg, 1, 4, 512, "bwd")
    from_bf16_o = fused_ring_bwd.fused_ring_bwd_reference(
        *f32, o.float(), lse, dos.float(), prog, tables, 128 ** -0.5)
    from_fp32_o = fused_ring_bwd.fused_ring_bwd_reference(
        *f32, o32, lse32, dos.float(), prog, tables, 128 ** -0.5)
    _close_to_max(k9, from_bf16_o)
    for name, a, b, c in zip(("dq", "dk", "dv"), k9, from_bf16_o,
                             from_fp32_o):
        print(f"{layout} {name}: kernel 9 vs the fp32 ring from fp32 o "
              f"{float((a - c).abs().max()):.3e}, the fp32 ring from bf16 o "
              f"vs from fp32 o {float((b - c).abs().max()):.3e} (max "
              f"{float(c.abs().max()):.3e})")


# Kernels 8 and 9 together (o and lse of kernel 8 feed kernel 9): a GQA
# group of 4, ragged S_local (no multiple of the 64-row tiles), and W=8
# with more items than CTAs a position (the counter deal and the scratch
# hand-over between rounds), in bf16 (the tensor-core tiles) and fp32 (the
# SIMT tiles); each launch twice more, bitwise equal.
RING_PAIR_CASES = [
    (4, "zigzag", True, 16, 4, 512, torch.bfloat16, {}),
    (3, "zigzag", True, 8, 2, 200, torch.bfloat16, {}),
    (3, "striped", True, 8, 2, 333, torch.float32, {}),
    (8, "zigzag", True, 32, 8, 1024, torch.bfloat16, {}),
    (8, "contig", True, 32, 8, 520, torch.bfloat16,
     dict(optimize_bwd_comm=False)),
    (4, "zigzag", True, 32, 8, 1024, torch.float32, {}),
]


@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs",
                         RING_PAIR_CASES)
def test_fused_ring_kernels_hold_their_plain_versions(dev, w, layout, causal,
                                                      n, n_kv, s, dtype,
                                                      knobs):
    cfg, ring, args, prog, tables = _ring_bwd_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs, seed=11)
    q, k, v, o, lse, _ = args
    fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
    ro, rlse = fused_ring.fused_ring_reference(q, k, v, fprog, ftables,
                                               128 ** -0.5)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm)
    _close_to_max(got, want)
    for _ in range(2):
        again = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("n,n_kv,s", [(8, 2, 512), (32, 8, 1024)])
def test_fused_ring_bwd_trace_records_every_cta(dev, n, n_kv, s):
    """A traced launch (bf16) gives the untraced gradients bit for bit and
    one record per CTA: its span holds its waits, and the position's CTAs
    took every item of every round once."""
    cfg, ring, args, _, _ = _ring_bwd_case(
        dev, 4, "zigzag", True, n, n_kv, s, torch.bfloat16, {}, seed=12)
    plain = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    trace = torch.zeros((sms, len(fused_ring_bwd.TRACE_COLS)),
                        dtype=torch.int64, device=dev)
    traced = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, trace=trace)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))
    recs = fused_ring_bwd.read_trace(trace)
    per_pos = len(recs) // 4
    assert len(recs) == 4 * per_pos and per_pos >= 1
    items = n_kv * -(-s // 64)
    for pos in range(4):
        mine = [r for r in recs if r["position"] == pos]
        assert len(mine) == per_pos
        # 4 rounds, each dealing every item once (resident or not)
        assert sum(r["items"] for r in mine) == 4 * items
    for r in recs:
        assert 0 <= r["fold_wait_ns"] + r["phase_wait_ns"] <= \
            r["t1_ns"] - r["t0_ns"]


def test_fused_ring_kernel_attributes(dev):
    """cudaFuncGetAttributes of every instance of kernels 8 and 9: the
    register counts fit the launch (255 at most a thread) and the bf16
    tiles keep the shared-memory footprint the launch sizing assumes."""
    fwd, bwd = fused_ring.fwd_attrs(), fused_ring_bwd.bwd_attrs()
    assert [a["instance"] for a in fwd] == ["bf16", "bf16 scratch", "fp32",
                                            "fp32 scratch"]
    assert [a["instance"] for a in bwd] == ["bf16", "bf16 traced", "fp32"]
    for a in fwd + bwd:
        assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, a
        print(a)
    assert fwd[0]["smem"] == 2 * 5 * 64 * 136
    assert bwd[0]["smem"] == 2 * (6 * 64 * 136 + 2 * 64 * 72) + 16 * 2048 \
        + 4 * 128


def test_ring_train_step_on_the_card_matches_the_cpu(dev):
    """Two fp32 train steps on a ring of 4 positions (mesh {"sp": 4},
    zigzag, the fused ring: kernel 8 twice per layer with remat, kernel 9
    once) equal the same steps with the plain versions on the CPU, as
    test_train_step_on_the_card_matches_the_cpu holds one position."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None,
                      attn_backend="fused_ring")
    mesh = {"sp": 4}
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh, device=where)
        step = train.make_train_step(cfg, tcfg, mesh, device=where)
        batch = train.make_batch(1, cfg, mesh, batch=2, seq=512,
                                 device=where)
        k0 = (fused_ring.fused_ring_fwd.launches,
              fused_ring_bwd.fused_ring_bwd.launches)
        metrics = []
        for i in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        moved = (fused_ring.fused_ring_fwd.launches - k0[0],
                 fused_ring_bwd.fused_ring_bwd.launches - k0[1])
        assert moved == ((0, 0) if where == "cpu"
                         else (2 * 2 * cfg.n_layers, 2 * cfg.n_layers))
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# ---------------------------------------------------------------------------
# sliding-window serving: kernels 1, 6 and 7 with a window; kernel 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window,offset", [
    (300, 1, 0), (300, 100, 0), (333, 64, -1), (256, 4096, 0)])
def test_flash_kernel_window_matches_plain(dev, dtype, s, window, offset):
    n, n_kv, d = 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(s + window)
    q = _rand(g, dev, dtype, 1, n, s, d)
    k, v = (_rand(g, dev, dtype, 1, n_kv, s, d) for _ in range(2))
    spec = masks.MaskSpec(0, s, s - 7, 1, offset)  # a ragged kv_hi too
    m, lse, o = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                                window=window, emit_o=True)
    again = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                            window=window, emit_o=True)
    assert all(torch.equal(a, b) for a, b in zip((m, lse, o), again))
    st = tile.tile_fwd(q, k, v, *tile.init_state(1, n, s, d, device=dev),
                       d**-0.5, spec, window=window)
    torch.testing.assert_close(o, tile.finalize(*st, dtype), **TOL[dtype])
    torch.testing.assert_close(lse, st[1], atol=1e-4, rtol=0)
    if window >= s:  # no band left: bitwise the unwindowed kernel
        full = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                               emit_o=True)
        assert all(torch.equal(a, b) for a, b in zip((m, lse, o), full))


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, None), (torch.bfloat16, None), (torch.float32, "int8"),
    (torch.bfloat16, "fp8")])
@pytest.mark.parametrize("window", [1, 64, 300])
def test_paged_kernel_window_matches_plain(dev, dtype, quant, window):
    page, n_kv, group, d, width, n_pages = 128, 2, 4, 128, 4, 32
    g = torch.Generator(device=dev).manual_seed(window)
    lengths = [0, 1, 37, page, 3 * page + 5, 4 * page]
    q = _rand(g, dev, dtype, len(lengths), n_kv, group, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = np.random.default_rng(window).permutation(n_pages - 1) + 1
    table = torch.from_numpy(perm[: len(lengths) * width].reshape(
        len(lengths), width).astype(np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(k_scales=ks, v_scales=vs, window=window)
    o = paged_attention.paged_decode_attention(q, kp, vp, table, lens, **kw)
    want = paged_attention.paged_decode_reference(q, kp, vp, table, lens,
                                                  **kw)
    torch.testing.assert_close(o, want, **TOL[dtype])
    # QT == 1 through the ragged kernel: bitwise the decode kernel's rows
    b = len(lengths)
    rag = ragged_paged.ragged_paged_attention(
        q.reshape(b, n_kv * group, 1, d), kp, vp, table,
        (lens > 0).to(torch.int32), lens, **kw)
    assert torch.equal(rag.reshape(o.shape), o)


@pytest.mark.parametrize("dtype,quant", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, "int8")])
@pytest.mark.parametrize("window", [1, 50, 200])
def test_ragged_kernel_window_matches_plain(dev, dtype, quant, window):
    q, kp, vp, table, ql, kl, ks, vs = _ragged_case(dev, dtype, quant)
    kw = dict(k_scales=ks, v_scales=vs, window=window)
    o = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl, **kw)
    again = ragged_paged.ragged_paged_attention(q, kp, vp, table, ql, kl,
                                                **kw)
    assert torch.equal(o, again)
    want = ragged_paged.ragged_paged_reference(q, kp, vp, table, ql, kl,
                                               **kw)
    torch.testing.assert_close(o, want, **TOL[dtype])


@pytest.mark.parametrize("window,kv1", [(100, 128 + 64), (16, 400)])
def test_ragged_grouped_window_matches_plain(dev, window, kv1):
    """A two-slot prefix group; with kv1 = 400 and window 16 the shared
    page lies wholly below every row's band."""
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(dev, torch.float32)
    table[2, 0] = table[1, 0]
    ql[1:3] = torch.tensor([1, 37], device=dev, dtype=torch.int32)
    kl[1:3] = torch.tensor([kv1, kv1 - 5], device=dev, dtype=torch.int32)
    grp = dict(group_id=torch.tensor([0, 1, 1, 0, 0, 0], dtype=torch.int32,
                                     device=dev),
               shared_table=torch.stack([torch.zeros_like(table[1, :1]),
                                         table[1, :1]]),
               shared_lens=torch.tensor([0, 128], dtype=torch.int32,
                                        device=dev))
    got = ragged_paged.ragged_paged_attention_grouped(
        q, kp, vp, table, ql, kl, window=window, **grp)
    assert not torch.isnan(got).any()
    want = ragged_paged.ragged_paged_reference(q, kp, vp, table, ql, kl,
                                               window=window)
    # padding rows (t >= q_lens) are the caller's to drop, as in JAX
    real = torch.arange(q.shape[2], device=dev)[None, :] < ql[:, None]
    torch.testing.assert_close(got * real[:, None, :, None], want,
                               **TOL[torch.float32])


@pytest.mark.parametrize("bkv,steps", [(32, 12), (128, 8), (256, 9),
                                       (1024, 5), (40, 700), (1024, 600)])
@pytest.mark.parametrize("matmul", [True, False])
def test_step_probe_kernel_matches_plain(dev, bkv, steps, matmul):
    from burst_attn_tpu_torch.bench import step_probe as sp

    g = torch.Generator(device=dev).manual_seed(bkv)
    q = _rand(g, dev, torch.bfloat16, 1, 200, 128)
    pool = _rand(g, dev, torch.bfloat16, min(steps, 512), bkv, 128)
    before = sp.step_probe.launches
    out, sums = sp.step_probe(q, pool, steps, matmul)
    again = sp.step_probe(q, pool, steps, matmul)
    torch.cuda.synchronize()
    assert sp.step_probe.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(sums, again[1])
    want, want_sums = sp.step_probe_reference(q, pool, steps, matmul)
    top = float(want.abs().max())
    assert float((out - want).abs().max()) <= 1e-5 * top
    assert torch.equal(sums, want_sums)


def test_serve_engines_window_match_the_cpu(dev):
    """A windowed fp32 model: both engines on the card produce the CPU
    engine's tokens (prompts inside and past the window)."""
    cfg = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=256,
                      dtype=torch.float32, window=64, layout="contig")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=t, dtype=np.int32)
               for t in (20, 100, 250)]
    kw = dict(slots=2, n_pages=12, page=128, max_pages_per_seq=3)
    outs = []
    for engine, extra in ((ServeEngine, {}),
                          (RaggedServeEngine, {"chunk": 64})):
        for d in ("cpu", dev):
            p = {k: (v.to(d) if torch.is_tensor(v) else
                     [{n: w.to(d) for n, w in lay.items()} for lay in v])
                 for k, v in params.items()}
            eng = engine(p, cfg, device=d, **kw, **extra)
            rids = [eng.submit(x, 8) for x in prompts]
            res = eng.run()
            outs.append([res[r] for r in rids])
    assert all(o == outs[0] for o in outs[1:])


def _verify_case(dev, dtype, quant, k, seed=12, group=4):
    """A speculative verify batch: k+1 query tokens in every live slot
    (an idle slot, a fresh sequence, a verify ending on a page edge, one
    crossing it, two long contexts)."""
    page, n_kv, d, width, n_pages = 128, 2, 128, 5, 40
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = k + 1
    kv_lens = [0, qt, 2 * page, 2 * page + 2, 600, 5 * page]
    q_lens = [0 if kv == 0 else qt for kv in kv_lens]
    q = _rand(g, dev, dtype, len(q_lens), n_kv * group, qt, d)
    kp, vp, ks, vs = _pool(g, dev, dtype, quant, n_pages, n_kv, page, d)
    perm = np.random.default_rng(seed).permutation(n_pages - 1) + 1
    table = torch.from_numpy(perm[: len(q_lens) * width].reshape(
        len(q_lens), width).astype(np.int32)).to(dev)
    lens = [torch.tensor(x, dtype=torch.int32, device=dev)
            for x in (q_lens, kv_lens)]
    return q, kp, vp, table, *lens, ks, vs


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype,quant", [
    (torch.bfloat16, None), (torch.float32, None), (torch.float32, "int8"),
    (torch.bfloat16, "fp8")])
def test_ragged_kernel_at_the_verify_width(dev, dtype, quant, k):
    """Kernel 7 at QT = k+1 in every live slot (a speculative verify)
    against its plain version; two launches are equal."""
    q, kp, vp, table, ql, kl, ks, vs = _verify_case(dev, dtype, quant, k)

    def kernel():
        return ragged_paged.ragged_paged_attention(
            q, kp, vp, table, ql, kl, k_scales=ks, v_scales=vs)

    o = kernel()
    assert torch.equal(o, kernel())
    want = ragged_paged.ragged_paged_reference(q, kp, vp, table, ql, kl,
                                               k_scales=ks, v_scales=vs)
    torch.testing.assert_close(o, want, **TOL[dtype])
    assert (o[0] == 0).all()


@pytest.mark.parametrize("quant", [False, "int8"])
def test_paged_multi_step_on_the_card_matches_the_cpu(dev, quant):
    """paged_multi_step through kernel 7 against its plain CPU version on
    the same weights and pool: live slots' logits within fp32 rounding,
    the unprovisioned slot NaN on both, equal lengths; one kernel-7
    launch a layer."""
    from burst_attn_tpu_torch.models import paged_decode as pd

    cfg, params = _serving_model("cpu")
    rng = np.random.default_rng(13)
    toks = rng.integers(1, cfg.vocab, size=(4, 5))
    out = {}
    for where in ("cpu", dev):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        st, pool = pd.init_paged_state(cfg, slots=4, n_pages=12, page=128,
                                       max_pages_per_seq=3, quantize=quant,
                                       device=where)
        for slot, t in ((0, 200), (1, 128), (3, 37)):
            pd.paged_prefill(p, np.random.default_rng(slot).integers(
                1, cfg.vocab, size=t), st, pool, slot, cfg)
        for slot in (0, 3):
            pd.provision_capacity(st, pool, slot, 5)
        before = ragged_paged.ragged_paged_attention.launches
        lg, _ = pd.paged_multi_step(p, toks, st, cfg)
        moved = ragged_paged.ragged_paged_attention.launches - before
        assert moved == (0 if where == "cpu" else cfg.n_layers)
        out[str(where)] = (lg.cpu(), st.lengths.cpu())
    (lc, nc), (lg, ng) = out["cpu"], out[str(dev)]
    assert torch.equal(nc, ng) and nc.tolist() == [205, 133, 0, 42]
    assert torch.isnan(lg[1]).all() and torch.isnan(lc[1]).all()
    for slot in (0, 3):
        torch.testing.assert_close(lg[slot], lc[slot], atol=1e-4, rtol=0)


@pytest.mark.parametrize("engine,extra", [
    (ServeEngine, {}), (RaggedServeEngine, {"chunk": 64}),
    (RaggedServeEngine, {"chunk": 64, "prefix_cache": True})])
def test_self_draft_engines_on_the_card_match_the_plain_engines(
        dev, engine, extra):
    """fp32 self-draft engines on the card: token-exact with the plain
    engine, every proposal accepted, the verify through kernel 7 and the
    draft's steps through kernel 6, both pools drained."""
    cfg, params = _serving_model(dev)
    rng = np.random.default_rng(14)
    tmpl = rng.integers(1, cfg.vocab, size=256)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (9, 130, 300)]
    prompts += [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t)])
                for t in (0, 40)]
    kw = dict(slots=3, n_pages=32, max_pages_per_seq=4, device=dev, **extra)
    out = []
    for draft in (False, True):
        spec = dict(draft_params=params, draft_cfg=cfg, spec_k=4) \
            if draft else {}
        eng = engine(params, cfg, **kw, **spec)
        counts = (paged_attention.paged_decode_attention,
                  ragged_paged.ragged_paged_attention)
        before = [f.launches for f in counts]
        rids = [eng.submit(pr, 9) for pr in prompts]
        res = eng.run()
        moved = [f.launches - b for f, b in zip(counts, before)]
        out.append([res[r] for r in rids])
        if eng.cache is not None:
            eng.cache.evict(32)  # the cached template pages
        assert eng.pool.available == 31
        if draft:
            assert eng.draft.pool.available == 31
            assert eng.spec_rounds > 0 and eng.acceptance_rate == 1.0
            assert moved[0] == cfg.n_layers * (4 + 1) * eng.spec_rounds
            assert moved[1] >= cfg.n_layers * eng.spec_rounds
            if engine is RaggedServeEngine:
                assert not any(k.startswith("burst.fused_fallback")
                               for k in eng.stats)
    assert out[0] == out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("engine,extra", [
    (ServeEngine, {}), (RaggedServeEngine, {"chunk": 64}),
    (RaggedServeEngine, {"chunk": 64, "prefix_cache": True})])
def test_snapshot_roundtrip_on_the_card_is_token_exact(dev, tmp_path, dtype,
                                                       engine, extra):
    """A mid-run snapshot restored into a fresh engine on the card
    finishes token-exact with the uninterrupted run, in fp32 and bf16:
    the same kernels run on the same bytes.  The ragged engine's host
    mirrors equal the restored device state."""
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    cfg, params = _serving_model(dev, dtype)
    rng = np.random.default_rng(21)
    tmpl = rng.integers(1, cfg.vocab, size=256)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (9, 130, 300)]
    prompts += [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t)])
                for t in (0, 40)]

    def make():
        return engine(params, cfg, slots=3, n_pages=32, max_pages_per_seq=4,
                      device=dev, **extra)

    eng = make()
    for p in prompts:
        eng.submit(p, 12)
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "snap.npz")
    ckpt.save_snapshot(eng, path)
    expect = eng.run()
    eng2 = make()
    ckpt.restore_into(eng2, ckpt.load_snapshot(path))
    if engine is RaggedServeEngine:
        assert np.array_equal(eng2._lengths, eng2.state.lengths.cpu().numpy())
        assert np.array_equal(eng2._table,
                              eng2.state.page_table.cpu().numpy())
    assert eng2.run() == expect
    if eng2.cache is not None:
        eng2.cache.evict(32)
    assert eng2.pool.available == 31


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_snapshot_into_a_pipelined_engine_keeps_its_graphs(dev, tmp_path,
                                                           sampling):
    """A pipelined K=4 engine restored in the middle of a run finishes
    token-exact with the uninterrupted run and with the synchronous
    engine.  The restore target captured its K=4 decode graph BEFORE the
    restore, and the restore writes into the tensors and the generator
    that graph is bound to, so its replays afterwards read the restored
    state (sampled: the CUDA generator's state, set on the registered
    generator).  The restore captures nothing."""
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    cfg, params = _serving_model(dev)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (40, 130, 77)]

    def make(**pipe):
        return RaggedServeEngine(
            params, cfg, slots=3, n_pages=16, max_pages_per_seq=4, chunk=64,
            device=dev, rng=torch.Generator(device=dev).manual_seed(5),
            **pipe, **sampling)

    target = make(pipeline=True, multi_step=4)
    target.submit(prompts[0], 10)           # warm: captures the K=4 graph
    target.run()
    captures = target.graphs.captures
    assert captures > 0
    eng = make(pipeline=True, multi_step=4)
    for p in prompts:
        eng.submit(p, 14)
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "snap.npz")
    ckpt.save_snapshot(eng, path)
    expect = eng.run()
    replays = target.graphs.replays
    ckpt.restore_into(target, ckpt.load_snapshot(path))
    assert target.graphs.captures == captures
    assert target.run() == expect
    assert target.graphs.replays > replays
    sync = make()
    for p in prompts:
        sync.submit(p, 14)
    assert sync.run() == expect


def test_pipelined_engine_fsyncs_before_it_delivers(dev, tmp_path):
    """The pipelined K=4 engine on the card with a journal: a clean run
    is the proof that every delivered token was fsynced first (the
    journal machine raises otherwise), and the journal's fold equals the
    streams.  With a journal whose sync does nothing, the first delivery
    raises DurabilityViolation."""
    from burst_attn_tpu_torch.protocols.journal import DurabilityViolation
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    cfg, params = _serving_model(dev)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (40, 130, 77)]
    kw = dict(slots=3, n_pages=16, max_pages_per_seq=4, chunk=64,
              pipeline=True, multi_step=4, device=dev)
    path = str(tmp_path / "j.jsonl")
    journal = ckpt.TokenJournal(path, truncate=True)
    eng = RaggedServeEngine(params, cfg, journal=journal, **kw)
    for p in prompts:
        journal.submit(eng.submit(p, 14), 0, p, 14)
    res = eng.run()
    view = ckpt.journal_view(path)
    assert view.tokens == res and view.done == set(res)
    assert eng.graphs.replays > 0

    class NoSync(ckpt.TokenJournal):
        def sync(self):
            pass

    eng = RaggedServeEngine(params, cfg,
                            journal=NoSync(str(tmp_path / "k.jsonl"),
                                           truncate=True), **kw)
    for p in prompts:
        eng.submit(p, 14)
    with pytest.raises(DurabilityViolation):
        eng.run()


# -- slice 14: ring telemetry, the dense-shard decode, obs on the card ------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("world,s", [(4, 2048), (8, 1024)])
def test_fused_ring_stats_instances_bitwise(dev, dtype, world, s):
    """Kernels 8 and 9 with the STATS flag: outputs bitwise those of the
    stats-off instances, slot counts equal to the plain versions' (which
    replay the programs), and the stats instances' registers and spills
    equal the stats-off ones'."""
    cfg = burst.BurstConfig(causal=True, layout="zigzag",
                            backend="fused_ring")
    g = torch.Generator(device=dev).manual_seed(41)
    q = _rand(g, dev, dtype, world, 1, 8, s, 128)
    k, v = (_rand(g, dev, dtype, world, 1, 2, s, 128) for _ in range(2))
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, 1, world)
    o2, lse2, st = fused_ring.fused_ring_fwd(q, k, v, cfg, 1, world,
                                             collect_stats=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    small = (t[:, :, :1, :256].float().cpu().contiguous()
             for t in (q, k, v))
    want = fused_ring.fused_ring_fwd(*small, cfg, 1, world,
                                     collect_stats=True)[2]
    assert torch.equal(st.slot_use.cpu(), want.slot_use)
    assert (st.fused_rounds.cpu() == world).all()
    do = _rand(g, dev, dtype, world, 1, 8, s, 128)
    plain = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, 1, world)
    *grads, slot_use = fused_ring_bwd.fused_ring_bwd(
        q, k, v, o, lse, do, cfg, 1, world, collect_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, grads))
    small = [t[:, :, :1, :256].float().cpu().contiguous()
             for t in (q, k, v)]
    o_s, lse_s = fused_ring.fused_ring_fwd(*small, cfg, 1, world)
    want_bwd = fused_ring_bwd.fused_ring_bwd(
        *small, o_s, lse_s, torch.ones_like(o_s), cfg, 1, world,
        collect_stats=True)[3]
    assert torch.equal(slot_use.cpu(), want_bwd)
    off = {a["instance"]: a for a in fused_ring.fwd_attrs()}
    for a in fused_ring.fwd_attrs(stats=True):
        b = off[a["instance"][:-len(" stats")]]
        assert (a["regs"], a["local_bytes"]) == (b["regs"], b["local_bytes"])
    off = {a["instance"]: a for a in fused_ring_bwd.bwd_attrs()}
    for a in fused_ring_bwd.bwd_attrs(stats=True):
        b = off[a["instance"][:-len(" stats")]]
        assert (a["regs"], a["local_bytes"]) == (b["regs"], b["local_bytes"])


@pytest.mark.parametrize("backend", ["fused_ring", "auto"])
def test_dist_generate_on_the_card(dev, backend):
    """fp32 dist_generate over sp=4 on the card: kernel 8 once a layer
    (fused) or kernel 1 once a live round of every position (scan), no
    fallback, tokens equal to the same model's dist_generate on the CPU
    and to the single-device generate."""
    from burst_attn_tpu_torch.models.decode import generate
    from burst_attn_tpu_torch.models.dist_decode import dist_generate

    cfg, params = _serving_model(dev)
    cfg = dataclasses.replace(cfg, attn_backend=backend, batch_axis=None,
                              head_axis=None)
    prompt = torch.from_numpy(np.random.default_rng(31).integers(
        1, cfg.vocab, size=(1, 1024)))
    f0, k0 = flash.flash_fwd.launches, fused_ring.fused_ring_fwd.launches
    before = obs.counter_values()
    got = dist_generate(params, prompt.to(dev), cfg, {"sp": 4}, steps=8)
    moved = obs.counter_deltas(before)
    if backend == "fused_ring":
        assert (flash.flash_fwd.launches - f0,
                fused_ring.fused_ring_fwd.launches - k0) == (0, cfg.n_layers)
    else:
        assert (flash.flash_fwd.launches - f0,
                fused_ring.fused_ring_fwd.launches - k0) == (
                    cfg.n_layers * 16, 0)
    assert not any(key.startswith("burst.fused_fallback") for key in moved)
    cpu = {k_: (v.cpu() if torch.is_tensor(v) else
                [{n: w.cpu() for n, w in lay.items()} for lay in v])
           for k_, v in params.items()}
    want = dist_generate(cpu, prompt, cfg, {"sp": 4}, steps=8)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, generate(cpu, prompt, cfg, steps=8,
                                      max_seq=1024 + 8))


def test_pipelined_counters_equal_the_synchronous_engine(dev):
    """The pipelined K=4 engine counts its ticks where its deferred
    readback lands (never inside the captured graphs): a K=4 run and the
    synchronous run of one workload give equal serve.tokens_generated,
    serve.engine_steps and serve.requests_retired."""
    cfg, params = _serving_model(dev)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (40, 130, 77, 9)]
    kw = dict(slots=3, n_pages=16, max_pages_per_seq=4, chunk=64,
              device=dev)
    names = ("serve.tokens_generated", "serve.engine_steps",
             "serve.requests_retired{cause=budget}")
    seen = {}
    for extra in ({}, dict(pipeline=True, multi_step=4)):
        eng = RaggedServeEngine(params, cfg, **kw, **extra)
        for p in prompts:
            eng.submit(p, 14)
        out = eng.run()
        seen[bool(extra)] = (out, [eng.stats[n] for n in names])
        if extra:
            assert eng.graphs.replays > 0
    assert seen[True] == seen[False]
    assert seen[False][1][0] == 14 * len(prompts)


def test_span_is_a_noop_inside_graph_capture(dev):
    """obs.span and a trace record entered while a CUDA graph is being
    captured record nothing (they would run once, at capture); the same
    span outside the capture records."""
    from burst_attn_tpu_torch.obs import trace as tracing

    x = torch.zeros(16, device=dev)
    obs.reset_spans()
    before = obs.histogram("span.capture.probe").get()["count"]
    tracing.reset_traces()
    tracing.enable()
    try:
        tc = tracing.start_request(1)
        graph = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            x.add_(1)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(graph):
            with obs.span("capture.probe") as sp:
                assert sp.span_id is None
                tracing.record_span(tc, "serve.queued", 0.0, 1.0)
                x.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        assert obs.completed_spans() == []
        assert obs.histogram("span.capture.probe").get()["count"] == before
        assert tracing.trace_records() == []
    finally:
        tracing.reset_traces()
    with obs.span("capture.probe"):
        pass
    assert [s_.name for s_ in obs.completed_spans()] == ["capture.probe"]


# ---------------------------------------------------------------------------
# packed segments: the SEG instances of kernels 1-5, 8 and 9


def _packed_ids(seed, b, s, n_docs):
    """[b, s] int32 document ids, monotone from 0: n_docs documents a row
    at boundaries drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((b, s), np.int32)
    for i in range(b):
        starts[i, rng.choice(np.arange(1, s), n_docs - 1, replace=False)] = 1
    return np.cumsum(starts, axis=1).astype(np.int32)


def _ids(seed, dev, b, s, n_docs):
    return torch.from_numpy(_packed_ids(seed, b, s, n_docs)).to(dev)


# (heads, kv heads, Sq, Skv, causal, window); cross lengths take their own
# ids on each side, some q ids present on no kv row (rows that see nothing)
SEG_FWD_CASES = [
    (4, 4, 256, 256, True, None),
    (8, 2, 200, 200, True, None),    # GQA, ragged edge
    (8, 2, 192, 192, False, None),   # non-causal
    (4, 1, 96, 333, False, None),    # cross lengths
    (4, 2, 300, 300, True, 64),      # with a window
]


def _seg_fwd_inputs(dev, dtype, n, n_kv, s_q, s_kv, seed=21):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _rand(g, dev, dtype, 2, n, s_q, 128)
    k, v = (_rand(g, dev, dtype, 2, n_kv, s_kv, 128) for _ in range(2))
    if s_q == s_kv:
        ids = _ids(seed, dev, 2, s_q, 5)
        return q, k, v, (ids, ids)
    return q, k, v, (_ids(seed, dev, 2, s_q, 6), _ids(seed + 1, dev, 2, s_kv,
                                                      4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,window", SEG_FWD_CASES)
def test_flash_kernel_segments_match_plain(dev, dtype, n, n_kv, s_q, s_kv,
                                           causal, window):
    q, k, v, segs = _seg_fwd_inputs(dev, dtype, n, n_kv, s_q, s_kv)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    before = flash.flash_fwd.launches
    m, lse, o = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                                window=window, segments=segs, emit_o=True)
    again = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                            window=window, segments=segs, emit_o=True)
    torch.cuda.synchronize()
    assert flash.flash_fwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip((m, lse, o), again))
    st = tile.tile_fwd(q, k, v, *tile.init_state(2, n, s_q, 128, device=dev),
                       128**-0.5, spec, window=window, segments=segs)
    torch.testing.assert_close(o, tile.finalize(*st, dtype), **TOL[dtype])
    torch.testing.assert_close(m, st[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, st[1], atol=1e-4, rtol=0)
    # a carry-in round (the raw accumulator) under the same ids
    got = flash.flash_fwd(q, k, v, *st, 128**-0.5, spec, window=window,
                          segments=segs)
    want = tile.tile_fwd(q, k, v, *st, 128**-0.5, spec, window=window,
                         segments=segs)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0,
                               atol=1e-4 * float(want[2].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emit_o,window", [(True, None), (False, None),
                                           (True, 64)])
def test_flash_kernel_one_segment_is_the_unsegmented_kernel(dev, dtype,
                                                            emit_o, window):
    """One segment covering every row gives bitwise the output of the
    instance without SEG (as a window >= S gives the unwindowed one)."""
    q, k, v, _ = _seg_fwd_inputs(dev, dtype, 8, 2, 333, 333, seed=22)
    one = torch.zeros(2, 333, dtype=torch.int32, device=dev)
    spec = masks.round_spec(0, 0, 333, 333, True, "contig")
    got = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                          window=window, segments=(one, one), emit_o=emit_o)
    want = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                           window=window, emit_o=emit_o)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _seg_bwd_case(dev, dtype, b, n, n_kv, s_q, s_kv, causal, seed=23):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (_rand(g, dev, dtype, b, n, s_q, 128) for _ in range(2))
    k, v = (_rand(g, dev, dtype, b, n_kv, s_kv, 128) for _ in range(2))
    if s_q == s_kv:
        ids = _ids(seed, dev, b, s_q, 4)
        segs = (ids, ids)
    else:
        segs = (_ids(seed, dev, b, s_q, 5), _ids(seed + 1, dev, b, s_kv, 3))
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                                segments=segs, emit_o=True)
    delta = (o.float() * do.float()).sum(-1)
    return (do, q, k, v, delta, lse, 128**-0.5, spec), segs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,n_kv,s_q,s_kv,causal", BWD_CASES)
@pytest.mark.parametrize("fused", [None, False])
def test_flash_bwd_kernels_segments_match_plain(dev, dtype, b, n, n_kv, s_q,
                                                s_kv, causal, fused):
    args, segs = _seg_bwd_case(dev, dtype, b, n, n_kv, s_q, s_kv, causal)
    before = dict(flash.flash_bwd.launches)
    got = flash.flash_bwd(*args, fused=fused, segments=segs)
    again = flash.flash_bwd(*args, fused=fused, segments=segs)
    torch.cuda.synchronize()
    routes = ("dq", "dkdv") if fused is False else ("fused",)
    for r in flash.BWD_ROUTES:
        assert flash.flash_bwd.launches[r] - before[r] == \
            (2 if r in routes else 0)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _bwd_close(got, tile.tile_bwd(*args, segments=segs),
               f"{dtype} fused={fused}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [None, False])
def test_flash_bwd_one_segment_is_the_unsegmented_kernel(dev, dtype, fused):
    args, _ = _seg_bwd_case(dev, dtype, 2, 8, 2, 200, 200, True, seed=24)
    # (the forward above ran with ids; lse is a valid final lse either way)
    one = torch.zeros(2, 200, dtype=torch.int32, device=dev)
    got = flash.flash_bwd(*args, fused=fused, segments=(one, one))
    want = flash.flash_bwd(*args, fused=fused)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_segments_autograd_matches_plain(dev, causal):
    g = torch.Generator(device=dev).manual_seed(25)
    q, k, v = (_rand(g, dev, torch.float32, 2, 4, 256, 128)
               for _ in range(3))
    ids = _ids(25, dev, 2, 256, 4)
    grads = []
    for fn in (lambda a, b, c: flash.flash_attention(
            a, b, c, causal=causal, segment_ids=ids),
               lambda a, b, c: tile.single_device_attention(
            a, b, c, causal=causal, segment_ids=ids)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        (o * o).sum().backward()
        grads.append([o.detach()] + [x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-6)


# (positions, layout, causal, heads, kv heads, local S, dtype, knobs,
# documents in the global row)
RING_SEG_CASES = [
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16, {}, 5),
    (4, "striped", True, 4, 2, 256, torch.float32, {}, 6),
    (4, "contig", True, 4, 1, 256, torch.bfloat16, {}, 3),
    (4, "zigzag", True, 4, 2, 256, torch.float32, dict(two_axis=(2, 2)), 5),
    (3, "zigzag", False, 4, 4, 200, torch.bfloat16, {}, 4),
    # more q tiles than resident CTAs: the state goes through scratch
    (8, "zigzag", True, 32, 8, 1024, torch.bfloat16, {}, 16),
]


def _ring_seg(dev, layout, w, ids):
    """Natural-order ids [B, S] -> the positions' [W, B, S / W] table."""
    x = layouts.to_layout(torch.as_tensor(ids), layout, w, axis=1)
    return mesh.shard(x.to(dev), w, dim=1)


def _ring_seg_case(dev, w, layout, causal, n, n_kv, s, dtype, knobs, docs,
                   seed=26, ids=None):
    cfg, ring, args, prog, tables = _ring_bwd_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs, seed)
    if ids is None:
        ids = _packed_ids(seed, 1, w * s, docs)
    seg = _ring_seg(dev, layout, w, ids)
    q, k, v, _, _, do = args
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    return cfg, ring, (q, k, v, o, lse, do), seg, prog, tables


@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs,docs",
                         RING_SEG_CASES)
def test_fused_ring_kernels_segments_match_plain(dev, w, layout, causal, n,
                                                 n_kv, s, dtype, knobs,
                                                 docs):
    cfg, ring, args, seg, prog, tables = _ring_seg_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs, docs)
    q, k, v, o, lse, do = args
    before = (fused_ring.fused_ring_fwd.launches,
              fused_ring_bwd.fused_ring_bwd.launches)
    again = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
    ro, rlse = fused_ring.fused_ring_reference(q, k, v, fprog, ftables,
                                               128 ** -0.5, seg=seg)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    torch.cuda.synchronize()
    assert (fused_ring.fused_ring_fwd.launches - before[0],
            fused_ring_bwd.fused_ring_bwd.launches - before[1]) == (1, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm, seg=seg,
        head_chunk=8)
    _close_to_max(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ring_kernels_one_segment_are_the_unsegmented_kernels(dev,
                                                                    dtype):
    cfg, ring, args, seg, _, _ = _ring_seg_case(
        dev, 4, "zigzag", True, 8, 2, 256, dtype, {}, 1)
    q, k, v, o, lse, do = args
    plain = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
    assert torch.equal(plain[0], o) and torch.equal(plain[1], lse)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    want = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ring_truncated_program_with_segments(dev, dtype):
    """A contig causal ring truncated by max_segment_len (3 live rounds of
    4) gives the untruncated ring's output and gradients when no document
    is longer than the promise (documents of 200 tokens, promise 300)."""
    ids = (np.arange(4 * 256) // 200)[None].astype(np.int32)
    full = _ring_seg_case(dev, 4, "contig", True, 4, 2, 256, dtype, {}, 0,
                          ids=ids)
    cut = _ring_seg_case(dev, 4, "contig", True, 4, 2, 256, dtype,
                         dict(max_segment_len=300), 0, ids=ids)
    assert fused_ring.ring_plan(cut[0], *cut[1], 256, "fwd")[0].n_rounds == 3
    for a, b in zip(cut[2][3:5], full[2][3:5]):
        torch.testing.assert_close(a, b, **TOL[dtype])
    got = fused_ring_bwd.fused_ring_bwd(*cut[2], cut[0], *cut[1], seg=cut[3])
    want = fused_ring_bwd.fused_ring_bwd(*full[2], full[0], *full[1],
                                         seg=full[3])
    _close_to_max(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ring_stats_instances_with_segments_bitwise(dev, dtype):
    """Kernel 8's STATS + SEG instance: o and lse bitwise the stats-off SEG
    launch, slot counts those of the unsegmented STATS launch."""
    cfg, ring, args, seg, _, _ = _ring_seg_case(
        dev, 4, "zigzag", True, 8, 2, 512, dtype, {}, 6)
    q, k, v, o, lse, _ = args
    so, slse, st = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg,
                                             collect_stats=True)
    assert torch.equal(so, o) and torch.equal(slse, lse)
    plain = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring,
                                      collect_stats=True)[2]
    assert torch.equal(torch.as_tensor(st.slot_use),
                       torch.as_tensor(plain.slot_use))


def test_burst_attn_segments_fused_matches_scan(dev):
    """burst_attn(segment_ids=) on the fused ring (kernels 8, 9) against the
    scan ring (kernels 1-3 a round), output and gradients, bf16 zigzag."""
    g = torch.Generator(device=dev).manual_seed(27)
    q, k, v = (_rand(g, dev, torch.bfloat16, 1, 8, 1024, 128)
               for _ in range(3))
    ids = layouts.to_layout(torch.from_numpy(_packed_ids(27, 1, 1024, 5)),
                            "zigzag", 4, axis=1).to(dev)
    outs = []
    for backend in ("fused_ring", "auto"):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = burst.burst_attn(*xs, mesh={"sp": 4}, causal=True,
                             layout="zigzag", backend=backend,
                             segment_ids=ids)
        o.float().square().sum().backward()
        outs.append([o.detach().float()] + [x.grad.float() for x in xs])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-2 * float(
            b.abs().max()))


# the instances without SEG keep the registers and local (spill) bytes
# they had before the SEG flag existed (NVIDIA H100 80GB HBM3, sm_90a)
NO_SEG_ATTRS = {
    "flash_fwd": {"bf16": (168, 0), "bf16 window": (178, 0)},
    "flash_bwd": {"bf16 fused": (255, 8), "bf16 dq": (242, 0),
                  "bf16 dkdv": (242, 0)},
    "fused_ring_fwd": {"bf16": (174, 0), "bf16 scratch": (176, 0)},
    "fused_ring_bwd": {"bf16": (255, 32)},
}


def test_seg_instances_attributes(dev):
    """Every SEG instance of kernels 1-5, 8 and 9 fits its launch (<= 255
    registers; kernel 1's bf16 and kernel 4's keep two CTAs an SM, their
    stages' ids 512 B beside K and V), and the instances without SEG keep
    their registers and spills."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seg = {"flash_fwd": flash.fwd_attrs(seg=True),
           "flash_bwd": flash.bwd_attrs(seg=True),
           "fused_ring_fwd": fused_ring.fwd_attrs(seg=True)
           + fused_ring.fwd_attrs(stats=True, seg=True),
           "fused_ring_bwd": fused_ring_bwd.bwd_attrs(seg=True)}
    for lib, rows in seg.items():
        for a in rows:
            print(lib, a)
            assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, (lib, a)
    for a in seg["flash_fwd"][:3]:
        assert a["smem"] == 2 * 5 * 64 * 136 + 512 and a["ctas"] == 2 * sms
    dq = seg["flash_bwd"][2]
    assert dq["smem"] == 2 * 6 * 64 * 136 + 512 and dq["ctas"] == 2 * sms
    now = {"flash_fwd": flash.fwd_attrs(), "flash_bwd": flash.bwd_attrs(),
           "fused_ring_fwd": fused_ring.fwd_attrs(),
           "fused_ring_bwd": fused_ring_bwd.bwd_attrs()}
    for lib, want in NO_SEG_ATTRS.items():
        got = {a["instance"]: (a["regs"], a["local_bytes"]) for a in now[lib]}
        assert {k: got[k] for k in want} == want, (lib, got)


@pytest.mark.parametrize("mesh_", [None, {"sp": 4}])
def test_packed_train_step_on_the_card_matches_the_cpu(dev, mesh_):
    """Two fp32 packed train steps (make_packed_batch, remat on) through
    the SEG kernels equal the same steps with the plain versions on the
    CPU: loss and grad norm to 1e-5, the first step's gradients to 1e-4
    of their largest entry; one position (kernels 1-3) and a fused zigzag
    ring of 4 (kernels 8, 9)."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None,
                      attn_backend="fused_ring")
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_packed_batch(3, cfg, mesh_, batch=2, seq=512,
                                        device=where)
        metrics = []
        for i in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# -- slice 16: windowed training: the WIN instances of kernels 2-5, 8, 9 --

# (batch, heads, kv heads, S, window): a one-column band, a band inside
# one 64-row tile, bands crossing tiles (GQA, ragged S), the train step's
WIN_BWD_CASES = [
    (1, 4, 4, 256, 1),
    (2, 8, 2, 200, 40),
    (1, 8, 2, 1000, 200),
    (1, 16, 16, 2048, 1024),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,n_kv,s,window", WIN_BWD_CASES)
@pytest.mark.parametrize("fused", [True, False])
def test_flash_bwd_kernels_window_match_plain(dev, dtype, b, n, n_kv, s,
                                              window, fused):
    """Kernels 2-5's WIN instances against tile_bwd(window=) at the
    kernels' bar, on the route asked for, counted as WIN launches; two
    launches bitwise equal."""
    args = _bwd_case(dev, dtype, b, n, n_kv, s, s, True, seed=61,
                     window=window)
    before = (dict(flash.flash_bwd.launches),
              dict(flash.flash_bwd.win_launches))
    got = flash.flash_bwd(*args, fused=fused, window=window)
    again = flash.flash_bwd(*args, fused=fused, window=window)
    torch.cuda.synchronize()
    routes = ("fused",) if fused else ("dq", "dkdv")
    for r in flash.BWD_ROUTES:
        want_n = 2 if r in routes else 0
        assert flash.flash_bwd.launches[r] - before[0][r] == want_n
        assert flash.flash_bwd.win_launches[r] - before[1][r] == want_n
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    # on the gradients' scale: a one-column band (window 1) has dq = 0 in
    # exact arithmetic (each row sees itself alone, dP_ii = delta_i), so
    # its error is the rounding of that cancellation, not dq's scale
    want = tile.tile_bwd(*args, window=window)
    _bwd_close(got, want, f"{dtype} fused={fused} window {window}",
               scale=max(float(x.abs().max()) for x in want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_flash_bwd_wide_window_is_the_unwindowed_kernel(dev, dtype, fused):
    """A window at or above S leaves every range and value as the
    instance without WIN computes them: bitwise equal."""
    args = _bwd_case(dev, dtype, 2, 8, 2, 333, 333, True, seed=61)
    got = flash.flash_bwd(*args, fused=fused, window=333)
    want = flash.flash_bwd(*args, fused=fused)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_flash_bwd_window_with_segments_match_plain(dev, dtype, fused):
    """WIN + SEG together (the JAX band grid with segments): against
    tile_bwd with both, rows that see nothing exact zeros."""
    ids = _ids(62, dev, 2, 500, 5)
    segs = (ids, ids)
    args = _bwd_case(dev, dtype, 2, 8, 2, 500, 500, True, seed=61,
                     window=96, segs=segs)
    got = flash.flash_bwd(*args, fused=fused, window=96, segments=segs)
    again = flash.flash_bwd(*args, fused=fused, window=96, segments=segs)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _bwd_close(got, tile.tile_bwd(*args, window=96, segments=segs),
               f"{dtype} fused={fused} window + segments")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("q_part,window", [(1, 300), (2, 300), (1, 64),
                                           (3, 700)])
def test_flash_bwd_window_ring_rounds_match_plain(dev, dtype, fused, q_part,
                                                  window):
    """The windowed contig ring's past rounds (offset q_part * S, the band
    crossing into earlier shards or ending before this one): rows whose
    band misses the chunk get exact zeros in dq."""
    s = 256
    spec = masks.round_spec(q_part, 0, s, s, True, "contig", window=window)
    live = masks.spec_live(spec, window)
    args = _bwd_case(dev, dtype, 1, 8, 2, s, s, True, seed=61)[:7] + (spec,)
    got = flash.flash_bwd(*args, fused=fused, window=window)
    _bwd_close(got, tile.tile_bwd(*args, window=window),
               f"{dtype} fused={fused} round {q_part} window {window}")
    rows = torch.arange(s, device=dev)
    blind = rows + spec.offset - window + 1 > s - 1  # band past the chunk
    assert (got[0][:, :, blind] == 0).all()
    if not live:
        assert all((a == 0).all() for a in got)


def test_flash_bwd_route_rule(dev):
    """flash_bwd(fused=None) follows bwd_route: the train step's causal
    sweep fused, a short windowed sweep on the split pair, a long band
    fused; counted on the card."""
    cases = [  # (n, n_kv, s, window, triangular, route)
        (4, 4, 2048, None, True, "fused"),
        (1, 1, 256, 64, False, "split"),
        (8, 2, 256, 64, False, "fused"),
        (1, 1, 2048, 1024, False, "fused"),
        (1, 1, 128, None, False, "split"),
    ]
    for n, n_kv, s, window, tri, route in cases:
        args = _bwd_case(dev, torch.bfloat16, 1, n, n_kv, s, s, True,
                         seed=61, window=window)
        assert flash.bwd_route(args[1].shape, args[2].shape, window=window,
                               triangular=tri) == route
        before = dict(flash.flash_bwd.launches)
        got = flash.flash_bwd(*args, window=window, triangular=tri)
        moved = {r: flash.flash_bwd.launches[r] - before[r]
                 for r in flash.BWD_ROUTES}
        assert moved == ({"fused": 1, "dq": 0, "dkdv": 0} if route ==
                         "fused" else {"fused": 0, "dq": 1, "dkdv": 1})
        _bwd_close(got, tile.tile_bwd(*args, window=window), f"{route}")


def test_flash_attention_window_autograd_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(63)
    q, k, v = (_rand(g, dev, torch.float32, 2, 4, 384, 128)
               for _ in range(3))
    grads = []
    for fn in (lambda a, b, c: flash.flash_attention(a, b, c, causal=True,
                                                     window=100),
               lambda a, b, c: tile.single_device_attention(
                   a, b, c, causal=True, window=100)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        (o * o).sum().backward()
        grads.append([o.detach()] + [x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-6)


# (positions, heads, kv heads, local S, window, dtype, documents or 0):
# a band inside one shard, one crossing a shard boundary, one crossing
# two; the ring step's shape; a band with packed segments
RING_WIN_CASES = [
    (4, 4, 2, 256, 100, torch.float32, 0),
    (4, 4, 2, 256, 300, torch.bfloat16, 0),
    (8, 4, 4, 128, 300, torch.float32, 0),
    (4, 16, 16, 2048, 1024, torch.bfloat16, 0),
    (4, 8, 2, 256, 300, torch.bfloat16, 5),
    (4, 8, 2, 256, 300, torch.float32, 5),
]


@pytest.mark.parametrize("w,n,n_kv,s,window,dtype,docs", RING_WIN_CASES)
def test_fused_ring_kernels_window_match_plain(dev, w, n, n_kv, s, window,
                                               dtype, docs):
    """Kernels 8 and 9's WIN instances (with SEG when `docs`) on the
    truncated program of a windowed contig ring: r_live rounds, against
    the plain versions, two launches bitwise equal, counted as WIN
    launches."""
    cfg, ring, args, prog, tables = _ring_bwd_case(
        dev, w, "contig", True, n, n_kv, s, dtype, dict(window=window))
    q, k, v, _, _, do = args
    r_live = min(w, (s + window - 2) // s + 1)
    fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
    assert fprog.n_rounds == prog.n_rounds == r_live
    seg = None
    if docs:
        seg = _ring_seg(dev, "contig", w, _packed_ids(64, 1, w * s, docs))
    before = (fused_ring.fused_ring_fwd.win_launches,
              fused_ring_bwd.fused_ring_bwd.win_launches)
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    o2, lse2 = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    small = dict(head_chunk=4) if s > 1024 else {}
    ro, rlse = fused_ring.fused_ring_reference(q, k, v, fprog, ftables,
                                               128 ** -0.5, seg=seg,
                                               window=window)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    args = (q, k, v, o, lse, do)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    torch.cuda.synchronize()
    assert (fused_ring.fused_ring_fwd.win_launches - before[0],
            fused_ring_bwd.fused_ring_bwd.win_launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm, seg=seg,
        window=window, **small)
    _close_to_max(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ring_stats_instance_with_window(dev, dtype):
    """Kernel 8's STATS + WIN instance: o and lse bitwise the stats-off
    WIN launch; the stats report the truncated round count (r_live = 3 of
    4: a band of 600 over shards of 512 reaches two shards back), the
    elided round, and the band's pairs."""
    cfg, ring, (q, k, v), _, _ = _fused_case(
        dev, 4, "contig", True, 8, 2, 512, dtype, dict(window=600))
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
    so, slse, st = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring,
                                             collect_stats=True)
    assert torch.equal(so, o) and torch.equal(slse, lse)
    r_live = (512 + 600 - 2) // 512 + 1
    assert r_live == 3
    assert (st.fused_rounds.cpu() == r_live).all()
    assert (st.rounds_elided.cpu() == 4 - r_live).all()
    pairs = [sum(masks.spec_pair_count(
        masks.round_spec(p, p - r, 512, 512, True, "contig", window=600),
        512, 512, window=600) for r in range(r_live) if p - r >= 0)
        for p in range(4)]
    assert st.attn_pairs.cpu().tolist() == [float(x) for x in pairs]
    with pytest.raises(NotImplementedError, match="STATS"):
        fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, o, cfg, *ring,
                                      collect_stats=True)


@pytest.mark.parametrize("backend", ["fused_ring", "auto"])
def test_burst_attn_window_matches_one_position(dev, backend):
    """burst_attn(window=) on a contig ring of 4, fused (kernels 8, 9) and
    scan (kernels 1-5 a live round), output and gradients against
    flash_attention(window=) on one position, bf16."""
    g = torch.Generator(device=dev).manual_seed(65)
    q, k, v = (_rand(g, dev, torch.bfloat16, 1, 8, 2048, 128)
               for _ in range(3))
    outs = []
    for ring in (True, False):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        if ring:
            o = burst.burst_attn(*xs, mesh={"sp": 4}, causal=True,
                                 layout="contig", backend=backend,
                                 window=700)
        else:
            o = flash.flash_attention(*xs, causal=True, window=700)
        o.float().square().sum().backward()
        outs.append([o.detach().float()] + [x.grad.float() for x in xs])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-2 * float(
            b.abs().max()))


def test_win_instances_attributes(dev):
    """Every WIN instance of kernels 2-5, 8 and 9 fits its launch, and the
    instances without WIN keep their registers and spills
    (NO_SEG_ATTRS, FUSED_TILE_ATTRS)."""
    win = {"flash_bwd": flash.bwd_attrs(win=True)
           + flash.bwd_attrs(seg=True, win=True),
           "fused_ring_fwd": fused_ring.fwd_attrs(win=True)
           + fused_ring.fwd_attrs(stats=True, win=True)
           + fused_ring.fwd_attrs(seg=True, win=True)
           + fused_ring.fwd_attrs(stats=True, seg=True, win=True),
           "fused_ring_bwd": fused_ring_bwd.bwd_attrs(win=True)
           + fused_ring_bwd.bwd_attrs(seg=True, win=True)}
    for lib, rows in win.items():
        for a in rows:
            print(lib, a)
            assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, (lib, a)
    now = {"flash_fwd": flash.fwd_attrs(), "flash_bwd": flash.bwd_attrs(),
           "fused_ring_fwd": fused_ring.fwd_attrs(),
           "fused_ring_bwd": fused_ring_bwd.bwd_attrs()}
    for pins in (NO_SEG_ATTRS, FUSED_TILE_ATTRS):
        for lib, want in pins.items():
            got = {a["instance"]: (a["regs"], a["local_bytes"])
                   for a in now[lib]}
            assert {k: got[k] for k in want} == want, (lib, got)


@pytest.mark.parametrize("mesh_,backend", [(None, "auto"),
                                           ({"sp": 4}, "fused_ring"),
                                           ({"sp": 4}, "auto")])
def test_window_train_step_on_the_card_matches_the_cpu(dev, mesh_, backend):
    """Two fp32 windowed train steps (remat on) through the WIN kernels
    equal the same steps with the plain versions on the CPU: loss and grad
    norm to 1e-5, the first step's gradients to 1e-4 of their largest
    entry; one position (kernels 1-3) and contig rings of 4, fused
    (kernels 8, 9) and scan."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None,
                      layout="contig", window=200, attn_backend=backend)
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_batch(3, cfg, mesh_, batch=2, seq=512,
                                 device=where)
        metrics = []
        for i in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# ---------------------------------------------------------------------------
# MoE layers and Ulysses attention

MOE_TRAIN_KW = dict(n_experts=4, moe_top_k=2)  # capacity factor 1.25: drops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ulysses_attn_on_the_card_matches_one_position(dev, dtype):
    """ulysses_attn over sp=4 (GQA 8/4, causal) against flash_attention on
    all heads at once, forward and gradients: each position launches
    kernel 1 once forward and the fused backward once."""
    from burst_attn_tpu_torch.parallel.ulysses import ulysses_attn

    g = torch.Generator(device=dev).manual_seed(51)
    q, do = (_rand(g, dev, dtype, 1, 8, 512, 128) for _ in range(2))
    k, v = (_rand(g, dev, dtype, 1, 4, 512, 128) for _ in range(2))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash.flash_fwd.launches, flash.flash_bwd.launches["fused"]
    o = ulysses_attn(*ins, mesh={"sp": 4}, causal=True)
    grads = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    assert flash.flash_fwd.launches - f0 == 4
    assert flash.flash_bwd.launches["fused"] - b0 == 4
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_ref = flash.flash_attention(*ref, None, True)
    want = torch.autograd.grad(o_ref, ref, do)
    torch.testing.assert_close(o, o_ref, **TOL[dtype])
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, **TOL[dtype])


@pytest.mark.parametrize("ep,cf", [(None, 8.0), (None, 0.5), (4, 0.5)])
def test_moe_apply_on_the_card_matches_the_cpu(dev, ep, cf):
    """moe_apply (fp32) on the card equals the CPU's: the same slot
    assignment and drops, outputs to fp32 rounding."""
    from burst_attn_tpu_torch.parallel import moe

    p = moe.init_moe_params(0, 64, 128, 8, device="cpu")
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(2))
    kw = dict(top_k=2, capacity_factor=cf, mesh=None if ep is None
              else {"ep": ep})
    y_c, aux_c, drop_c = moe.moe_apply(p, x, **kw)
    y_g, aux_g, drop_g = moe.moe_apply(
        moe.MoEParams(*(t.to(dev) for t in p)), x.to(dev), **kw)
    assert float(drop_g) == float(drop_c)
    torch.testing.assert_close(y_g.cpu(), y_c, **TOL[torch.float32])
    torch.testing.assert_close(aux_g.cpu(), aux_c, atol=1e-6, rtol=1e-5)


def test_moe_engines_on_the_card_match_the_cpu(dev):
    """fp32 MoE model: the ServeEngine and the RaggedServeEngine on the
    card give the CPU engines' greedy tokens; the card's prefills launch
    kernel 1 once a layer and request."""
    cfg, params = _serving_model("cpu", **MOE_KW)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, size=t) for t in (40, 130, 77)]
    out = {}
    for where in ("cpu", dev):
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 [{n: w.to(where) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        for cls, extra in ((ServeEngine, {}),
                           (RaggedServeEngine, {"chunk": 64})):
            eng = cls(p, cfg, slots=2, n_pages=16, max_pages_per_seq=4,
                      device=where, **extra)
            rids = [eng.submit(pr, 8) for pr in prompts]
            before = flash.flash_fwd.launches
            res = eng.run()
            if cls is ServeEngine and str(where) != "cpu":
                assert flash.flash_fwd.launches - before == \
                    cfg.n_layers * len(prompts)
            out[(str(where), cls.__name__)] = [res[r] for r in rids]
    assert len({tuple(map(tuple, v)) for v in out.values()}) == 1, out


@pytest.mark.parametrize("kw,mesh_", [
    (MOE_TRAIN_KW, None),
    (dict(attn_strategy="ulysses", layout="contig"), {"sp": 4}),
    (dict(attn_strategy="ulysses", layout="contig", window=200), {"sp": 4}),
    (dict(attn_strategy="ulysses", layout="contig", **MOE_TRAIN_KW),
     {"sp": 2}),
], ids=["moe", "ulysses", "ulysses-window", "ulysses-moe"])
def test_moe_and_ulysses_train_step_on_the_card_matches_the_cpu(dev, kw,
                                                                mesh_):
    """Two fp32 train steps (remat on) of an MoE model (with drops) and of
    Ulysses models on the card equal the same steps on the CPU: loss and
    grad norm to 1e-5, the first step's gradients to 1e-4 of their
    largest entry; a Ulysses step launches kernel 1 twice a layer on
    every position."""
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None,
                      **kw)
    tcfg = train.TrainConfig(lr=1e-3)
    w = 1 if mesh_ is None else mesh_["sp"]
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_batch(3, cfg, mesh_, batch=2, seq=512,
                                 device=where)
        metrics = []
        for i in range(2):
            before = flash.flash_fwd.launches
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if str(where) != "cpu":
                assert flash.flash_fwd.launches - before == \
                    2 * cfg.n_layers * w
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# -- int8 / fp8 ring payloads (wire_dtype): kernels 8 and 9's WIRE
# instances -----------------------------------------------------------------

# tests/test_wire_quant.py's tolerances against the dense ring
WIRE_TOL_FWD = {"int8": 0.04, "fp8": 0.2}
WIRE_TOL_GRAD = {"int8": 0.25, "fp8": 1.5}
# kernel 9 against its plain version under a wire dtype.  The wrapper
# quantizes the bundle once, so both read the same codes: dk and dv differ
# by summation order alone (_close_to_max's BWD_RTOL, as the dense
# instances).  dq's partial is re-quantized per 64-row q tile at every
# hop, and the two sum it in another order, so a code can flip at a
# rounding boundary: each q tile within WIRE_DQ_CODES codes of its own
# scale, one code being the step at the tile's largest entry (1/127 of it
# for int8; 32/448 for fp8, e4m3's spacing at the top of its range), as
# chip_smoke holds it
WIRE_DQ_STEP = {"int8": 1 / 127, "fp8": 32 / 448}
# the largest readings on an H100 (the card tests and the smoke): 2.0 codes
# int8 (two hops each flipping one), 1.5 fp8; the limit about twice that
WIRE_DQ_CODES = {"int8": 4, "fp8": 3}


def _wire_dq_close(got, want, wire):
    """dq [..., S, D] within WIRE_DQ_CODES codes of each 64-row q tile's
    scale (+ 1e-6)."""
    s = want.shape[-2]
    nqt = -(-s // 64)
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if nqt * 64 != s:
        err, ref = (torch.nn.functional.pad(t, (0, 0, 0, nqt * 64 - s))
                    for t in (err, ref))
    err, ref = (t.unflatten(-2, (nqt, 64)).amax((-2, -1))
                for t in (err, ref))
    step = WIRE_DQ_STEP[wire] * ref
    codes = float((err / step.clamp_min(1e-30)).max())
    print(f"{wire} dq: {codes:.3f} codes of its q tile's scale at the worst "
          "tile")
    assert (err <= WIRE_DQ_CODES[wire] * step + 1e-6).all(), \
        f"dq beyond {WIRE_DQ_CODES[wire]} codes of a q tile's scale: " \
        f"{codes:.2f}"
WIRE_CASES = [
    # (positions, layout, causal, heads, kv heads, local S, dtype, knobs)
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16, {}),
    (4, "zigzag", True, 4, 2, 256, torch.float32,
     dict(optimize_bwd_comm=False)),
    (4, "striped", True, 4, 4, 256, torch.bfloat16,
     dict(fused_topology="bidi")),
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16,
     dict(fused_seq_factor=(2, 2))),
    (4, "contig", True, 4, 2, 256, torch.bfloat16, dict(window=300)),
    (4, "zigzag", True, 8, 2, 256, torch.bfloat16,
     dict(optimize_bwd_comm=False)),
    # more tiles than resident CTAs: the scratch state, dk / dv in memory
    (8, "zigzag", True, 16, 4, 1024, torch.bfloat16, {}),
]


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs", WIRE_CASES)
def test_fused_ring_wire_kernels_match_plain(dev, w, layout, causal, n, n_kv,
                                             s, dtype, knobs, wire):
    """Kernels 8 and 9's WIRE instances against their plain versions with
    the same wire dtype (kernel 8 at the dense tolerance: its dequantized
    tiles are the plain version's bit for bit; kernel 9's dk, dv at the
    dense tolerance and dq within WIRE_DQ_CODES codes of each q tile's
    scale), two launches equal, one WIRE
    launch each counted; and against the dense kernels within
    tests/test_wire_quant.py's tolerances."""
    knobs = dict(knobs, wire_dtype=wire)
    cfg, ring, (q, k, v, o, lse, do), prog, tables = _ring_bwd_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs)
    fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
    ro, rlse = fused_ring.fused_ring_reference(
        q, k, v, fprog, ftables, 128 ** -0.5, window=cfg.window, wire=wire)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    n8, n9 = (fused_ring.fused_ring_fwd.wire_launches,
              fused_ring_bwd.fused_ring_bwd.wire_launches)
    o2, lse2 = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
    got = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, *ring)
    again = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, *ring)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert fused_ring.fused_ring_fwd.wire_launches == n8 + 1
    assert fused_ring_bwd.fused_ring_bwd.wire_launches == n9 + 2
    want = fused_ring_bwd.fused_ring_bwd_reference(
        q, k, v, o, lse, do, prog, tables, 128 ** -0.5,
        cfg.optimize_bwd_comm, window=cfg.window, wire=wire)
    _close_to_max(got[1:], want[1:])
    _wire_dq_close(got[0], want[0], wire)
    dense = dataclasses.replace(cfg, wire_dtype=None)
    od, lsed = fused_ring.fused_ring_fwd(q, k, v, dense, *ring)
    assert float((o.float() - od.float()).abs().max()) < WIRE_TOL_FWD[wire]
    gd = fused_ring_bwd.fused_ring_bwd(q, k, v, od, lsed, do, dense, *ring)
    for a, b in zip(got, gd):
        assert float((a - b).abs().max()) < WIRE_TOL_GRAD[wire]


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_burst_attn_wire_fused_matches_scan(dev, wire):
    """burst_attn with a wire dtype through kernels 8 and 9 against the
    scan ring with the same wire (bf16, sp=4, zigzag, GQA): the forward
    at the bf16 tolerance, the gradients within tests/test_wire_quant.py's
    TOL_GRAD; slot counters those of the dense run and quant_absmax the
    positions' max |k|, |v|; the burst.wire_bytes counters the quantized
    bytes."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = _rand(g, dev, torch.bfloat16, 1, 8, 2048, 128)
    k, v = (_rand(g, dev, torch.bfloat16, 1, 2, 2048, 128) for _ in range(2))
    kw = dict(mesh={"sp": 4}, causal=True, layout="zigzag", wire_dtype=wire)
    res = {}
    for backend in ("fused_ring", "auto"):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        before = obs.counter_values()
        o = burst.burst_attn(*ts, backend=backend, **kw)
        grads = torch.autograd.grad(o.float().square().sum(), ts)
        moved = obs.counter_deltas(before)
        assert not any(x.startswith("burst.fused_fallback") for x in moved)
        res[backend] = o.detach(), grads
    torch.testing.assert_close(res["fused_ring"][0], res["auto"][0],
                               **TOL[torch.bfloat16])
    for a, b in zip(res["fused_ring"][1], res["auto"][1]):
        assert float((a.float() - b.float()).abs().max()) < \
            WIRE_TOL_GRAD[wire]
    per = 2048 // 4
    bwd = burst.sched_ir.wire_round_bytes("bwd", wire, b=1, n=8, n_kv=2,
                                          s=per, d=128)
    assert moved["burst.wire_bytes{dir=dq,pass=bwd}"] == bwd["dq"]
    _, st = burst.burst_attn(q, k, v, backend="fused_ring",
                             collect_stats=True, **kw)
    _, st0 = burst.burst_attn(q, k, v, backend="fused_ring",
                              collect_stats=True, mesh={"sp": 4},
                              causal=True, layout="zigzag")
    assert torch.equal(st.slot_use, st0.slot_use)
    assert (st0.quant_absmax == 0).all()
    want = torch.maximum(k.float().abs().reshape(1, 2, 4, per, 128).amax(
        (0, 1, 3, 4)), v.float().abs().reshape(1, 2, 4, per, 128).amax(
        (0, 1, 3, 4)))
    torch.testing.assert_close(st.quant_absmax.cpu(), want.cpu(), atol=0,
                               rtol=0)


def test_wire_combinations_not_built_raise(dev):
    """SEG + WIRE on kernels 8 and 9 runs fused (one launch each of the
    SEG + WIRE instances, finite); the combinations still without an
    instance raise on the card, with a message, and do not fall back:
    collect_stats or a trace of a WIRE backward."""
    cfg, ring, (q, k, v, o, lse, do), _, _ = _ring_bwd_case(
        dev, 4, "zigzag", True, 4, 2, 256, torch.bfloat16,
        dict(wire_dtype="int8"))
    seg = torch.zeros((4, 1, 256), dtype=torch.int32, device=dev)
    counts = (fused_ring.fused_ring_fwd.seg_launches,
              fused_ring.fused_ring_fwd.wire_launches,
              fused_ring_bwd.fused_ring_bwd.seg_launches,
              fused_ring_bwd.fused_ring_bwd.wire_launches)
    so, slse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    grads = fused_ring_bwd.fused_ring_bwd(q, k, v, so, slse, do, cfg, *ring,
                                          seg=seg)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(
        (fused_ring.fused_ring_fwd.seg_launches,
         fused_ring.fused_ring_fwd.wire_launches,
         fused_ring_bwd.fused_ring_bwd.seg_launches,
         fused_ring_bwd.fused_ring_bwd.wire_launches), counts)) == (1, 1, 1, 1)
    # one document: the SEG + WIRE launches are the WIRE launches
    assert torch.equal(so, o) and torch.equal(slse, lse)
    for t in grads:
        assert torch.isfinite(t).all()
    with pytest.raises(NotImplementedError, match="STATS"):
        fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, *ring,
                                      collect_stats=True)
    trace = torch.zeros((1024, len(fused_ring_bwd.TRACE_COLS)),
                        dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match="TRACE"):
        fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, *ring,
                                      trace=trace)
    # the scan ring takes segments with a wire dtype too
    ids = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    o_scan = burst.burst_attn(*(mesh.unshard(t) for t in (q, k, v)),
                              mesh={"sp": 4}, causal=True, segment_ids=ids,
                              wire_dtype="int8")
    assert torch.isfinite(o_scan.float()).all()


# (positions, layout, causal, heads, kv heads, local S, dtype, knobs,
# documents in the global row)
SEG_WIRE_CASES = [
    (4, "zigzag", True, 4, 2, 256, torch.bfloat16, {}, 5),
    (4, "zigzag", True, 4, 2, 256, torch.float32,
     dict(optimize_bwd_comm=False), 5),
    (4, "contig", True, 4, 2, 256, torch.bfloat16, dict(window=300), 3),
    (4, "striped", True, 4, 4, 256, torch.bfloat16,
     dict(fused_topology="bidi"), 6),
    # more tiles than resident CTAs: the scratch state, dk / dv in memory
    (8, "zigzag", True, 16, 4, 1024, torch.bfloat16, {}, 16),
]


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("w,layout,causal,n,n_kv,s,dtype,knobs,docs",
                         SEG_WIRE_CASES)
def test_fused_ring_seg_wire_kernels_match_plain(dev, w, layout, causal, n,
                                                 n_kv, s, dtype, knobs, docs,
                                                 wire):
    """Kernels 8 and 9's SEG + WIRE instances against their plain versions
    with the same ids and wire dtype, at the WIRE tolerances of
    test_fused_ring_wire_kernels_match_plain; two launches equal; each
    launch counted as SEG and as WIRE."""
    knobs = dict(knobs, wire_dtype=wire)
    cfg, ring, args, seg, prog, tables = _ring_seg_case(
        dev, w, layout, causal, n, n_kv, s, dtype, knobs, docs)
    q, k, v, o, lse, do = args
    fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
    ro, rlse = fused_ring.fused_ring_reference(
        q, k, v, fprog, ftables, 128 ** -0.5, seg=seg, window=cfg.window,
        wire=wire)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    counts = (fused_ring.fused_ring_fwd.seg_launches,
              fused_ring.fused_ring_fwd.wire_launches,
              fused_ring_bwd.fused_ring_bwd.seg_launches,
              fused_ring_bwd.fused_ring_bwd.wire_launches)
    o2, lse2 = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert tuple(a - b for a, b in zip(
        (fused_ring.fused_ring_fwd.seg_launches,
         fused_ring.fused_ring_fwd.wire_launches,
         fused_ring_bwd.fused_ring_bwd.seg_launches,
         fused_ring_bwd.fused_ring_bwd.wire_launches), counts)) == (1, 1, 2, 2)
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm, seg=seg,
        window=cfg.window, wire=wire, head_chunk=8)
    _close_to_max(got[1:], want[1:])
    _wire_dq_close(got[0], want[0], wire)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_burst_attn_seg_wire_fused_matches_scan(dev, wire):
    """burst_attn(segment_ids=, wire_dtype=) on the fused route runs
    kernels 8 and 9 (their SEG + WIRE instances, no burst.fused_fallback
    count) and matches the scan ring with the same ids and wire (bf16,
    sp=4, zigzag, GQA): the forward at the bf16 tolerance, the gradients
    within WIRE_TOL_GRAD."""
    g = torch.Generator(device=dev).manual_seed(31)
    q = _rand(g, dev, torch.bfloat16, 1, 8, 2048, 128)
    k, v = (_rand(g, dev, torch.bfloat16, 1, 2, 2048, 128) for _ in range(2))
    ids = layouts.to_layout(torch.from_numpy(_packed_ids(31, 1, 2048, 5)),
                            "zigzag", 4, axis=1).to(dev)
    kw = dict(mesh={"sp": 4}, causal=True, layout="zigzag", wire_dtype=wire,
              segment_ids=ids)
    res = {}
    for backend in ("fused_ring", "auto"):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        before = obs.counter_values()
        counts = (fused_ring.fused_ring_fwd.seg_launches,
                  fused_ring.fused_ring_fwd.wire_launches,
                  fused_ring_bwd.fused_ring_bwd.seg_launches,
                  fused_ring_bwd.fused_ring_bwd.wire_launches)
        o = burst.burst_attn(*ts, backend=backend, **kw)
        grads = torch.autograd.grad(o.float().square().sum(), ts)
        torch.cuda.synchronize()
        moved = obs.counter_deltas(before)
        assert not any(x.startswith("burst.fused_fallback") for x in moved)
        launched = tuple(a - b for a, b in zip(
            (fused_ring.fused_ring_fwd.seg_launches,
             fused_ring.fused_ring_fwd.wire_launches,
             fused_ring_bwd.fused_ring_bwd.seg_launches,
             fused_ring_bwd.fused_ring_bwd.wire_launches), counts))
        assert launched == ((1, 1, 1, 1) if backend == "fused_ring"
                            else (0, 0, 0, 0)), (backend, launched)
        res[backend] = o.detach(), grads
    torch.testing.assert_close(res["fused_ring"][0], res["auto"][0],
                               **TOL[torch.bfloat16])
    for a, b in zip(res["fused_ring"][1], res["auto"][1]):
        assert float((a.float() - b.float()).abs().max()) < \
            WIRE_TOL_GRAD[wire]


def test_wire_instances_attributes(dev):
    """Every WIRE instance of kernels 8 and 9 (the SEG + WIRE ones too)
    fits its launch; the instances without WIRE keep their registers and
    spills."""
    rows = (fused_ring.fwd_attrs(wire=True)
            + fused_ring.fwd_attrs(stats=True, wire=True)
            + fused_ring.fwd_attrs(win=True, wire=True)
            + fused_ring.fwd_attrs(stats=True, win=True, wire=True)
            + fused_ring.fwd_attrs(seg=True, wire=True)
            + fused_ring.fwd_attrs(stats=True, seg=True, wire=True)
            + fused_ring.fwd_attrs(seg=True, win=True, wire=True)
            + fused_ring.fwd_attrs(stats=True, seg=True, win=True,
                                   wire=True)
            + fused_ring_bwd.bwd_attrs(wire=True)
            + fused_ring_bwd.bwd_attrs(win=True, wire=True)
            + fused_ring_bwd.bwd_attrs(seg=True, wire=True)
            + fused_ring_bwd.bwd_attrs(seg=True, win=True, wire=True))
    for a in rows:
        print(a)
        assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, a
    now = {"fused_ring_fwd": fused_ring.fwd_attrs(),
           "fused_ring_bwd": fused_ring_bwd.bwd_attrs()}
    for pins in (NO_SEG_ATTRS, FUSED_TILE_ATTRS):
        for lib, want in pins.items():
            if lib not in now:
                continue
            got = {a["instance"]: (a["regs"], a["local_bytes"])
                   for a in now[lib]}
            assert {k: got[k] for k in want} == want, (lib, got)


# -- the pipeline-parallel model ---------------------------------------------

@pytest.mark.parametrize("mesh_,m", [({"pp": 2, "sp": 1}, 2),
                                     ({"pp": 2, "sp": 2}, 2)])
def test_pp_train_step_on_the_card(dev, mesh_, m):
    """Two fp32 pp train steps (2 layers, remat on) on the card equal the
    same steps on the CPU (loss and grad norm to 1e-5, the first step's
    gradients to 1e-4 of their largest entry), with exact launches: one
    device per stage ring: kernel 1 twice a layer a microbatch (forward
    and remat recompute), the fused backward once; on the sp=2 ring with
    the fused route, kernels 8 (twice) and 9 (once) a layer a
    microbatch."""
    ring = mesh_["sp"] > 1
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_head=128, d_ff=512,
                      dtype=torch.float32, batch_axis=None, head_axis=None,
                      pp_axis="pp", pp_microbatches=m,
                      attn_backend="fused_ring" if ring else "auto")
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_batch(3, cfg, mesh_, batch=2, seq=512,
                                 device=where)
        metrics = []
        for i in range(2):
            counts = (flash.flash_fwd.launches,
                      flash.flash_bwd.launches["fused"],
                      fused_ring.fused_ring_fwd.launches,
                      fused_ring_bwd.fused_ring_bwd.launches)
            state, m_ = step(state, batch)
            metrics.append((float(m_["loss"]), float(m_["grad_norm"])))
            if str(where) != "cpu":
                got = tuple(a - b for a, b in zip(
                    (flash.flash_fwd.launches,
                     flash.flash_bwd.launches["fused"],
                     fused_ring.fused_ring_fwd.launches,
                     fused_ring_bwd.fused_ring_bwd.launches), counts))
                per = cfg.n_layers * m
                assert got == ((0, 0, 2 * per, per) if ring
                               else (2 * per, per, 0, 0)), got
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# the expert axis on dp, the pipeline beside dp, tp and ep, Ulysses with
# tp: (model options, mesh, batch, launches a step per layer: kernel 1,
# the fused backward, kernel 8, kernel 9)
MESH2_CASES = {
    "moe-ep-on-dp": (dict(MOE_TRAIN_KW, expert_axis="dp",
                          attn_backend="fused_ring"),
                     {"dp": 2, "sp": 2, "tp": 2}, 2, (0, 0, 4, 2)),
    "pp-dp-sp-tp": (dict(pp_axis="pp", pp_microbatches=2,
                         attn_backend="fused_ring"),
                    {"pp": 2, "dp": 2, "sp": 2, "tp": 2}, 4, (0, 0, 8, 4)),
    "pp-ep-moe": (dict(MOE_TRAIN_KW, pp_axis="pp", expert_axis="ep",
                       batch_axis=None, head_axis=None,
                       attn_backend="fused_ring"),
                  {"pp": 2, "ep": 2, "sp": 2}, 2, (0, 0, 2, 1)),
    "ulysses-tp": (dict(attn_strategy="ulysses", layout="contig",
                        batch_axis=None),
                   {"sp": 4, "tp": 2}, 2, (8, 4, 0, 0)),
}


@pytest.mark.parametrize("case", list(MESH2_CASES))
def test_mesh_combination_train_step_on_the_card_matches_the_cpu(dev, case):
    """Two fp32 train steps (2 layers, remat on) with the expert axis on
    dp, the pipeline beside dp and tp and beside ep, and Ulysses with tp,
    on the card equal the same steps
    on the CPU (loss and grad norm to 1e-5, the first step's gradients to
    1e-4 of their largest entry), with exact launches: the fused ring's
    kernels 8 (forward, remat recompute) and 9 a layer, microbatch and dp
    group, every tp position's heads in one launch; Ulysses' kernel 1 and
    fused backward a layer and sequence position over both tp groups'
    heads."""
    kw, mesh_, b, per_layer = MESH2_CASES[case]
    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=8, d_head=128, d_ff=512,
                      dtype=torch.float32, **kw)
    tcfg = train.TrainConfig(lr=1e-3)
    out = {}
    for where in ("cpu", dev):
        state = train.init_train_state(0, cfg, tcfg, mesh_, device=where)
        step = train.make_train_step(cfg, tcfg, mesh_, device=where)
        batch = train.make_batch(3, cfg, mesh_, batch=b, seq=512,
                                 device=where)
        metrics = []
        for i in range(2):
            counters = lambda: (flash.flash_fwd.launches,  # noqa: E731
                                flash.flash_bwd.launches["fused"],
                                fused_ring.fused_ring_fwd.launches,
                                fused_ring_bwd.fused_ring_bwd.launches)
            before = counters()
            state, m_ = step(state, batch)
            metrics.append((float(m_["loss"]), float(m_["grad_norm"])))
            if str(where) != "cpu":
                got = tuple(a - c for a, c in zip(counters(), before))
                assert got == tuple(cfg.n_layers * x for x in per_layer), \
                    got
            if i == 0:
                grads = [t.grad.detach().cpu().clone()
                         for t in param_leaves(state[0])]
        out[str(where)] = metrics, grads
    (mc, gc), (mg, gg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    _close_to_max(gg, gc)


# ---------------------------------------------------------------------------
# serving under load on the card: the cluster's and the fleet's fault
# matrix, every worker process on the card (the model spec names no
# device), each run with its own time limits

LOAD_SPEC = dict(vocab=512, d_model=256, n_layers=1, n_heads=2,
                 n_kv_heads=1, d_head=128, d_ff=512, seed=0)
LOAD_LIMITS = dict(start_timeout_s=240.0, restart_timeout_s=240.0)
FLEET_PSPEC = dict(sp=2, page=128, n_pages=4, max_pages_per_seq=8)
FLEET_DSPEC = dict(sp=2, slots=2, page=128, n_pages=8, max_pages_per_seq=4)


def _fleet_trace(n, *, prompt_len=128, seed0=100, max_new=4, dt=0.05,
                 extra=()):
    from burst_attn_tpu_torch.loadgen.trace import Trace, TraceRequest

    reqs = [TraceRequest(rid=i, t_arrival=dt * i, prompt_len=prompt_len,
                         prompt_seed=seed0 + i, max_new_tokens=max_new)
            for i in range(n)]
    return Trace(meta={"vocab": LOAD_SPEC["vocab"]},
                 requests=reqs + list(extra))


def _fleet_exact(rep, oracle):
    for rid, o in rep.outcomes.items():
        assert o.status == "done", (rid, o)
        assert o.tokens == oracle[rid], (rid, o.tokens, oracle[rid])


def _on_card(boots):
    assert boots and all(b["device"].startswith("cuda") for b in boots), \
        boots


def test_cluster_hog_stall_hang_on_card(dev, tmp_path):
    """Ragged workers on the card: a pool hog (sheds, then the unhog lets
    the backlog drain), a stall (slow, not dead) and a hang (caught by
    the heartbeat only); token-exact with the oracle, every worker life's
    kernel 7 launches one a layer a ragged launch."""
    from burst_attn_tpu_torch.loadgen import (
        FaultEvent, LoadGenCluster, assert_token_exact, oracle_replay,
        synthesize_trace,
    )
    from burst_attn_tpu_torch.loadgen.worker import build_engine
    from burst_attn_tpu_torch.obs.aggregate import load_records_tolerant

    spec = dict(kind="ragged", slots=2, n_pages=6, page=128,
                max_pages_per_seq=2, chunk=16, max_queue=16)
    trace = synthesize_trace(8, seed=13, vocab=LOAD_SPEC["vocab"],
                             mean_interarrival_s=0.25, prompt_len_max=40,
                             max_new_min=24, max_new_mean=32, max_new_max=48)
    faults = [FaultEvent(t=0.1, kind="hog", worker=1, arg=5),
              FaultEvent(t=0.3, kind="stall", worker=1, arg=1.0),
              FaultEvent(t=0.4, kind="hang", worker=0),
              FaultEvent(t=2.5, kind="unhog", worker=1)]
    with LoadGenCluster(LOAD_SPEC, spec, n_workers=2, out_dir=str(tmp_path),
                        hb_interval_s=0.25, hb_timeout_s=6.0,
                        **LOAD_LIMITS) as cl:
        rep = cl.replay(trace, faults, speed=1.0, max_wall_s=240)
        cl.stop()
        boots, paths = cl.boot_s, cl.obs_paths
    _on_card(boots)
    assert [k["detected_by"] for k in rep.kills] == ["heartbeat"]
    assert rep.n_done == len(trace.normal())
    assert_token_exact(rep.completed(), oracle_replay(
        trace, lambda: build_engine(LOAD_SPEC, dict(spec, max_queue=None))))
    for path in paths:
        recs, _ = load_records_tolerant(path)
        last = []
        for r in recs:
            last = [] if r["kind"] == "meta" else last + [r]
        k7 = sum(r["value"] for r in last if r["name"] == "kernel.launches"
                 and r["labels"].get("kernel") == "ragged_paged")
        ticks = sum(r["value"] for r in last
                    if r["name"] == "serve.ragged_batch_launches")
        assert k7 == LOAD_SPEC["n_layers"] * ticks > 0, (path, k7, ticks)


def _fleet(tmp_path, requests, faults=(), *, spec=None, speed=25.0, **kw):
    from burst_attn_tpu_torch.fleet import FleetCluster, fleet_oracle

    spec = spec or dict(LOAD_SPEC, attn_backend="fused_ring")
    oracle, _ = fleet_oracle(requests, spec, prefill_spec=FLEET_PSPEC,
                             decode_spec=FLEET_DSPEC)
    kw = dict(dict(n_prefill=1, n_decode=1, out_dir=str(tmp_path)), **kw)
    with FleetCluster(spec, prefill_spec=FLEET_PSPEC,
                      decode_spec=FLEET_DSPEC, **LOAD_LIMITS, **kw) as fc:
        rep = fc.replay(requests, list(faults), speed=speed,
                        max_wall_s=240.0)
        fc.stop()
        boots, stopped = fc.boot_s, fc.stopped
    _on_card(boots)
    _fleet_exact(rep, oracle)
    for info in stopped.values():  # no hog left: every pool drained
        assert info["pool_free"] == info["pool_usable"], stopped
    return rep, fc, stopped


def test_fleet_hog_stall_cross_boundary_on_card(dev, tmp_path):
    """A hogged prefill pool (retryable prefill failures until the unhog)
    and a stalled replica: absorbed by the router's retries."""
    from burst_attn_tpu_torch.fleet import FleetFault

    rep, _, stopped = _fleet(tmp_path, _fleet_trace(3, dt=0.1), [
        FleetFault(t=0.0, pool="prefill", worker=0, kind="hog", arg=3),
        FleetFault(t=50.0, pool="prefill", worker=0, kind="unhog"),
        FleetFault(t=0.0, pool="decode", worker=0, kind="stall", arg=1.5)])
    assert any(o.retries > 0 for o in rep.outcomes.values())
    info = stopped[("prefill", 0)]
    assert info["kernels"]["fused_ring_fwd"] == \
        LOAD_SPEC["n_layers"] * info["ring_prefills"] > 0, info


def test_fleet_hang_heartbeat_both_pools_on_card(dev, tmp_path):
    from burst_attn_tpu_torch.fleet import FleetFault

    rep, _, _ = _fleet(tmp_path, _fleet_trace(3), [
        FleetFault(t=0.0, pool="prefill", worker=0, kind="hang"),
        FleetFault(t=0.3, pool="decode", worker=0, kind="hang")],
        n_prefill=2, n_decode=2, checkpoint_every=1, hb_interval_s=0.5,
        hb_timeout_s=8.0)
    hb = {(k["pool"], k["worker"]) for k in rep.kills
          if k["detected_by"] == "heartbeat"}
    assert ("prefill", 0) in hb and ("decode", 0) in hb, rep.kills


def test_fleet_prefill_kill_and_scan_route_on_card(dev, tmp_path):
    """A busy prefill worker SIGKILLed: its request re-runs on the
    sibling.  The prefill ring here is the scan route (kernel 1 in every
    round): its launches W^2 a layer a pass, no kernel 8."""
    from burst_attn_tpu_torch.fleet import FleetFault

    rep, _, stopped = _fleet(
        tmp_path, _fleet_trace(3, prompt_len=256, seed0=300, dt=0.02),
        [FleetFault(t=0.1, pool="prefill", worker=0, kind="kill")],
        spec=dict(LOAD_SPEC, attn_backend="auto"), n_prefill=2)
    assert any(k["pool"] == "prefill" for k in rep.kills), rep.kills
    info = stopped[("prefill", 1)]
    w = FLEET_PSPEC["sp"]
    assert info["kernels"]["fused_ring_fwd"] == 0
    assert info["kernels"]["flash_fwd"] == \
        LOAD_SPEC["n_layers"] * w * w * info["ring_prefills"] > 0, info


def test_fleet_autoscale_on_card(dev, tmp_path):
    """Sustained pressure (requests waiting, no free decode slot) spawns a
    replica, at most max_decode even while it boots, and the idle fleet
    scales back down.  The card decodes faster than the requests arrive,
    so a stalled replica makes the pressure; the late arrival keeps the
    replay open while the new replica boots, the fleet idles (10 scale
    checks of 0.2 s) and scales down.  Speed 1: the re-ship backoff of the
    transfers the stalled replica refuses runs in wall seconds."""
    from burst_attn_tpu_torch.fleet import FleetFault
    from burst_attn_tpu_torch.loadgen.trace import TraceRequest

    late = TraceRequest(rid=5, t_arrival=30.0, prompt_len=128,
                        prompt_seed=405, max_new_tokens=3)
    rep, _, _ = _fleet(tmp_path, _fleet_trace(5, seed0=400, max_new=6,
                                              dt=0.02, extra=[late]),
                       [FleetFault(t=0.0, pool="decode", worker=0,
                                   kind="stall", arg=3.0)],
                       speed=1.0, autoscale=True, max_decode=2,
                       scale_check_interval_s=0.2, scale_up_after=2,
                       scale_down_after=10)
    ups = [e for e in rep.scale_events if e["action"] == "up"]
    downs = [e for e in rep.scale_events if e["action"] == "down"]
    assert ups and downs, rep.scale_events
    assert len(ups) - len(downs) <= 1, rep.scale_events


def test_fleet_trace_tree_on_card(dev, tmp_path):
    """A traced fleet replay: complete trees across router, prefill,
    transfer and decode processes, whose phases sum to the TTFT."""
    from burst_attn_tpu_torch.obs import trace as tracing
    from burst_attn_tpu_torch.obs.aggregate import build_trace_trees

    try:
        rep, fc, _ = _fleet(tmp_path, _fleet_trace(3, seed0=500),
                            trace=True)
    finally:
        tracing.enable(False)
    _metrics, _spans, meta = fc.merged()
    trees = build_trace_trees(meta.get("traces", ()),
                              meta.get("truncated_processes", ()))
    need = {"fleet.request", "fleet.first_token", "fleet.prefill",
            "fleet.ship", "fleet.transfer", "fleet.commit", "fleet.decode"}
    ok = 0
    for tree in trees:
        names = {s["name"] for s in tree["spans"]}
        procs = {str(s.get("process_index")) for s in tree["spans"]}
        bd = tracing.ttft_breakdown(tree["spans"])
        if not (tree["complete"] and need <= names and len(procs) >= 2
                and bd and bd["ttft_s"] > 0):
            continue
        assert abs(sum(bd["phases"].values()) - bd["ttft_s"]) \
            <= 0.01 * bd["ttft_s"], (tree["trace_id"], bd)
        ok += 1
    assert ok >= 1, [(t["trace_id"], sorted({s["name"] for s in t["spans"]}))
                     for t in trees]


# ---------------------------------------------------------------------------
# the analyzer's card half: the cost model's shared-memory plans against
# the compiled kernels, and fused-ring-fused on the fused route


def test_smem_plans_equal_kernel_attrs(dev):
    """Every instance the cost model plans is one the card reports, with
    exactly the planned shared memory (<= 227 KB) and at least the CTAs an
    SM its design assumes; no instance goes unplanned."""
    from burst_attn_tpu_torch.analysis import costcheck, costmodel

    attrs = costcheck.card_attrs()
    plans = costmodel.kernel_smem_plans()
    assert len(attrs) == len(plans)
    for p in plans:
        a = attrs[(p.lib, p.instance)]
        assert a["smem"] == p.smem <= costmodel.SMEM_LIMIT, (p, a)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    findings = costcheck.check_attrs(attrs, n_sm)
    assert findings == [], [f.format() for f in findings]


def test_smem_plan_mutation_fires_on_the_card(dev):
    """A plan off by one row of a tile is caught against the card."""
    from burst_attn_tpu_torch.analysis import costcheck, costmodel

    attrs = costcheck.card_attrs()
    plans = costmodel.kernel_smem_plans()
    bad = [p._replace(smem=p.smem + 2 * 136) if p.lib == "fused_ring_fwd"
           else p for p in plans]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    findings = costcheck.check_attrs(attrs, n_sm, plans=bad)
    assert findings and all(f.rule == "kernel-smem-budget"
                            for f in findings)


@pytest.mark.parametrize("case", [c[0] for c in ringcheck.CARD_CASES])
def test_fused_ring_fused_on_the_card(dev, case):
    """fused-ring-fused at W=4 (uni, bidi, double 2x2, a windowed elided
    program): zero rotations outside kernels 8 and 9, one launch a pass,
    kernel 8's slot counters the program's."""
    spec = {c[0]: c for c in ringcheck.CARD_CASES}[case]
    findings = ringcheck.verify_fused_case(*spec)
    assert findings == [], [f.format() for f in findings]


def test_fused_ring_fused_catches_a_scan_fallback(dev, monkeypatch):
    """A fused gate that declines (the scan ring rotates in its place) is
    caught: rotations recorded, no kernel launch, the fallback counted."""
    monkeypatch.setattr(fused_ring, "supported",
                        lambda *a, **k: "dtype forced off for the test")
    findings = ringcheck.verify_fused_case(*ringcheck.CARD_CASES[0])
    msgs = " ".join(f.message for f in findings)
    assert "rotations" in msgs and "launches" in msgs, msgs


def test_analysis_cli_card_exits_zero(dev):
    """`python -m burst_attn_tpu_torch.analysis --card` on the card: the
    CPU families and the card half, zero findings, nothing left not run."""
    import json
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-m", "burst_attn_tpu_torch.analysis",
                        "--card", "--json"], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = json.loads(r.stdout)
    assert out["n_findings"] == 0 and out["not_run"] == {}


# ---------------------------------------------------------------------------
# the analyzer's last seven rules on the card (numerics, obscheck,
# servecheck) and the crash-recovery fuzzer on cuda


def test_sass_accumulators_are_f32(dev):
    from burst_attn_tpu_torch.analysis import numerics
    from burst_attn_tpu_torch.ops import _build

    texts = numerics.finish_sass(numerics.start_sass())
    for lib in numerics.TENSOR_CORE_LIBS:
        mmas = [m for fn in numerics.sass_census(texts[lib]).values()
                for m in fn]
        assert mmas and all(".F32" in mods for _, mods in mmas), lib
    assert numerics.check_sass(sass=texts) == []
    assert sorted(texts) == sorted(_build.SIGNATURES)


def test_bf16_ring_stats_stay_fp32_on_the_card(dev):
    from burst_attn_tpu_torch.analysis import numerics

    assert numerics.check_ring("cuda") == []


@pytest.mark.parametrize("check", ["ring", "steps", "decode_graphs", "tick"])
def test_obscheck_card_halves_clean(dev, check):
    from burst_attn_tpu_torch.analysis import obscheck

    fn = getattr(obscheck, f"check_{check}_card")
    assert fn() == []


def test_servecheck_card_half_clean(dev):
    from burst_attn_tpu_torch.analysis import servecheck

    assert servecheck.check_card() == []


def _d2h(out, t):
    """A device-to-host copy seeded into a step: non-blocking into pinned
    memory, so it captures (as a memcpy node) instead of failing."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    out.append(host)


def test_d2h_in_a_captured_step_fires_ckpt(dev, monkeypatch):
    from burst_attn_tpu_torch.analysis import obscheck
    from burst_attn_tpu_torch.serving import model as sm

    real, keep = sm.ragged_model_step, []

    def step(*a, **k):
        logits, state = real(*a, **k)
        _d2h(keep, logits)
        return logits, state

    monkeypatch.setattr(sm, "ragged_model_step", step)
    findings = obscheck.check_steps_card()
    assert {f.rule for f in findings} == {"ckpt-jit-safe"}
    assert any("dtoh" in f.message for f in findings), findings


@pytest.mark.parametrize("seed", ["sync", "d2h"])
def test_seeded_decode_body_fires_pipe_fused(dev, monkeypatch, seed):
    from burst_attn_tpu_torch.analysis import obscheck
    from burst_attn_tpu_torch.serving import model as sm

    real, keep = sm.pipelined_tick, []

    def tick(*a, **k):
        choice, state = real(*a, **k)
        if seed == "sync":
            choice.sum().item()
        else:
            _d2h(keep, choice)
        return choice, state

    monkeypatch.setattr(sm, "pipelined_tick", tick)
    findings = obscheck.check_decode_graphs_card()
    assert {f.rule for f in findings} == {"pipe-fused-pure"}
    needle = "capture failed" if seed == "sync" else "dtoh"
    assert all(needle in f.message for f in findings), findings


def test_k1_graph_equals_the_eager_tick(dev):
    from burst_attn_tpu_torch.analysis import obscheck

    assert obscheck.check_tick_card() == []


def test_fuzz_mid_scale_scatter_on_cuda(dev, tmp_path):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "fuzz_checkpoint.py"
    spec = importlib.util.spec_from_file_location("fuzz_checkpoint", path)
    fz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fz)
    model = fz.load_model(None, dict(vocab=256, d_model=256, n_layers=1,
                                     n_heads=2, n_kv_heads=1, d_head=128,
                                     d_ff=512, seed=0))
    assert model.device.type == "cuda"
    before = ragged_paged.ragged_paged_attention.launches
    res = fz.run_cache_seed(0, 4, str(tmp_path), model)
    r = res["mid-scale-scatter"]
    assert r["exact"] and r["killed"] and r["leak_free"] and r["torn"], r
    assert r["launches"]["ragged_paged_attention"] > 0
    assert ragged_paged.ragged_paged_attention.launches > before
    assert all(fz.mode_ok(v) for v in res.values()), res


# -- two processes sharing the card (utils/multihost.py, gloo) --------------


def test_two_processes_double_ring_bf16_on_card(dev, tmp_path):
    """The bf16 double ring inter=2 (two processes on the one card, gloo,
    the payloads staged through pinned host buffers) x intra=2 (local):
    forward and gradients bitwise the one-process ring's on the card;
    kernel 1 launched in each process; the second call reuses the first
    call's staging buffers."""
    import torch_multiproc_workers as W

    rng = np.random.default_rng(31)
    q, k, v, g = (rng.standard_normal((1, 4, 1024, 128), np.float32)
                  for _ in range(4))
    res = W.spawn(W.ring_op, 2, (q, k, v, g, "cuda", "auto", "bfloat16", 2),
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    tq, tk, tv = (torch.from_numpy(x).to(dev, torch.bfloat16)
                  .requires_grad_() for x in (q, k, v))
    o = burst.burst_attn(tq, tk, tv, mesh={"inter": 2, "intra": 2},
                         seq_axes=("inter", "intra"), causal=True,
                         layout="zigzag", backend="auto")
    gb = torch.from_numpy(g).to(dev, torch.bfloat16).float()
    (o.float() * gb).sum().backward()
    for name, want in (("o", o), ("dq", tq.grad), ("dk", tk.grad),
                       ("dv", tv.grad)):
        got = np.concatenate([r[name] for r in res], axis=2)
        np.testing.assert_array_equal(got, want.detach().float().cpu()
                                      .numpy(), err_msg=name)
    for r in res:
        assert r["allocs"][0] == r["allocs"][1] > 0, r["allocs"]
        assert r["stats"]["hops"] == 2 * 4, r["stats"]
        assert r["flash_fwd_launches"] > 0


def test_two_processes_single_ring_bf16_on_card(dev, tmp_path):
    """The bf16 single ring sp=4 split 2 + 2 between two processes on the
    one card (every hop crosses them): forward and gradients bitwise the
    one-process ring's on the card; kernel 1 launched in each process;
    the fused backend declined (spans-processes)."""
    import torch_multiproc_workers as W

    rng = np.random.default_rng(33)
    q, k, v, g = (rng.standard_normal((1, 4, 1024, 128), np.float32)
                  for _ in range(4))
    res = W.spawn(W.ring_op, 2, (q, k, v, g, "cuda", "fused_ring",
                                 "bfloat16", 2, {"sp": 4}, {}, ("sp",)),
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    tq, tk, tv = (torch.from_numpy(x).to(dev, torch.bfloat16)
                  .requires_grad_() for x in (q, k, v))
    o = burst.burst_attn(tq, tk, tv, mesh={"sp": 4}, seq_axes=("sp",),
                         causal=True, layout="zigzag", backend="auto")
    gb = torch.from_numpy(g).to(dev, torch.bfloat16).float()
    (o.float() * gb).sum().backward()
    for name, want in (("o", o), ("dq", tq.grad), ("dk", tk.grad),
                       ("dv", tv.grad)):
        got = np.concatenate([r[name] for r in res], axis=2)
        np.testing.assert_array_equal(got, want.detach().float().cpu()
                                      .numpy(), err_msg=name)
    for r in res:
        # 3 forward hops, 3 payload and 3 dq hops, dq home: a call
        assert r["stats"]["hops"] == 2 * 10, r["stats"]
        assert r["flash_fwd_launches"] > 0
        assert r["fallback"] == {
            "burst.fused_fallback{pass=fwd,reason=spans-processes}": 2,
            "burst.fused_fallback{pass=bwd,reason=spans-processes}": 2}


def test_two_processes_tp_step_on_card(dev, tmp_path):
    """The bf16 tp=2 (across two processes on the one card) x sp=2 train
    step: every loss, grad norm and first-step gradient bitwise the
    one-process tp=2 x sp=2 step's on the card (Megatron's f and g
    across the processes), the kernels launched in each process."""
    import torch_multiproc_workers as W

    dims = dict(vocab=256, d_model=256, n_layers=1, n_heads=2, n_kv_heads=2,
                d_head=128, d_ff=512)
    tok = np.random.default_rng(7).integers(0, 256, (2, 257)).astype(
        np.int32)
    kw = dict(device="cuda", dtype="bfloat16", steps=2, dims=dims)
    res = W.spawn(
        W.train_steps, 2, (None, tok, W.TP_SP, "auto") + tuple(kw.values()),
        init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    one = W.train_steps(None, tok, W.TP_SP, (), **kw)
    for r in res:
        assert r["losses"] == one["losses"] and r["norms"] == one["norms"]
        for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        assert r["flash_fwd_launches"] > 0
        assert r["stats"]["gathers"] > 0


def test_two_processes_pp_step_on_card(dev, tmp_path):
    """The bf16 pipeline pp=2 (a stage in each of two processes on the one
    card) x sp=2 train step at 2 microbatches: every loss, grad norm and
    first-step gradient bitwise the one-process pp=2 x sp=2 step's on the
    card (the stage hops and their gradients across the processes), the
    kernels launched in each process."""
    import torch_multiproc_workers as W

    dims = dict(vocab=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=2,
                d_head=128, d_ff=512)
    tok = np.random.default_rng(7).integers(0, 256, (2, 257)).astype(
        np.int32)
    sizes = {"pp": 2, "sp": 2}
    kw = dict(device="cuda", dtype="bfloat16", steps=2, dims=dims,
              model=dict(pp_axis="pp", pp_microbatches=2))
    res = W.spawn(
        W.train_steps, 2, (None, tok, sizes, "auto") + tuple(kw.values()),
        init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    one = W.train_steps(None, tok, sizes, (), **kw)
    for r in res:
        assert r["losses"] == one["losses"] and r["norms"] == one["norms"]
        for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        assert r["flash_fwd_launches"] > 0
        assert r["stats"]["hops"] > 0 and r["stats"]["gathers"] > 0


def test_two_processes_dp_step_on_card(dev, tmp_path):
    """The bf16 dp=2 (two processes on the one card) x sp=2 train step:
    every loss, grad norm and first-step gradient bitwise the one-process
    dp=2 x sp=2 step's on the card, the kernels launched in each
    process."""
    import torch_multiproc_workers as W

    dims = dict(vocab=256, d_model=256, n_layers=1, n_heads=2, n_kv_heads=2,
                d_head=128, d_ff=512)
    tok = np.random.default_rng(7).integers(0, 256, (2, 257)).astype(
        np.int32)
    kw = dict(device="cuda", dtype="bfloat16", steps=2, dims=dims)
    res = W.spawn(
        W.train_steps, 2, (None, tok, W.DP_SP, ("dp",)) + tuple(kw.values()),
        init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    one = W.train_steps(None, tok, W.DP_SP, (), **kw)
    for r in res:
        assert r["losses"] == one["losses"] and r["norms"] == one["norms"]
        for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        assert r["flash_fwd_launches"] > 0
        assert r["stats"]["gathers"] > 0

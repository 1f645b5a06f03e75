"""The ragged kernel's split-k on the CPU: the host mirror of its grid
(`cta_plan`, `split_plan`), the plain base-2 merge (`merge_partials`),
and paged decode as the kernel's QT == 1 instance (q_lens None),
against the port's plain versions and the JAX package's kernels in
interpret mode.  Tolerances: fp32 rounding of a reassociated sum (1e-5
relative to the row's magnitude, 1e-6 absolute) for split-vs-unsplit;
tests/test_ragged_paged.py's 2e-6 against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import paged_attention as jpa
from burst_attn_tpu.ops import ragged_paged as jrp
from burst_attn_tpu_torch.ops import paged_attention as pa
from burst_attn_tpu_torch.ops import ragged_paged as rp

TOL = dict(rtol=2e-6, atol=2e-6)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)

# chip_smoke.py's mixed batch at the serving shapes
Q_LENS = (0, 1, 37, 128, 128, 1, 128, 37)
KV_LENS = (0, 2112, 37, 1024, 2048, 1, 700, 1500)


def _coverage(plan, n_slots, qt, n_pos):
    """How many of the plan's CTAs walk each (slot, token, position)."""
    cnt = np.zeros((n_slots, qt, n_pos), np.int64)
    for _, s, t_lo, t_hi, lo, hi in plan:
        cnt[s, t_lo:t_hi, lo:hi + 1] += 1
    return cnt


@pytest.mark.parametrize("window,ctx", [
    (None, None), (64, None), (1024, None),
    (None, (0, 1024, 0, 512, 1024, 0, 256, 1408)),
    (64, (0, 1024, 0, 512, 1024, 0, 256, 1408))])
def test_plan_covers_every_visible_pair_once(window, ctx):
    """Every visible (row, position) pair of the smoke's mixed batch lies in
    exactly one CTA's walk, and every walk stays inside the page table:
    windows 64 and 1024, a page-aligned ctx_lo, idle slots."""
    page, width, group, qt = 128, 17, 4, 128
    q_lens = torch.tensor(Q_LENS, dtype=torch.int32)
    kv_lens = torch.tensor(KV_LENS, dtype=torch.int32)
    ctx_lo = None if ctx is None else torch.tensor(ctx, dtype=torch.int32)
    plan = rp.cta_plan(Q_LENS, KV_LENS, qt, group, page, width,
                       ctx_lo=ctx, window=window, n_kv=4)
    n_pos = width * page
    visible = rp._visible(q_lens, kv_lens, qt, n_pos, page, ctx_lo,
                          window).numpy()
    cnt = _coverage(plan, len(Q_LENS), qt, n_pos)
    np.testing.assert_array_equal(np.where(visible, cnt, 1), 1)
    assert all(hi < n_pos for *_, hi in plan)
    # idle slot 0 and the all-padding tails launch nothing
    assert not any(s == 0 for _, s, *_ in plan)
    # decode slots (q_len 1, 4 rows) take the decode path, chunks the prefill
    kinds = {(s, k) for k, s, *_ in plan}
    assert (1, "decode") in kinds and (1, "prefill") not in kinds
    assert (4, "prefill") in kinds


def test_plan_splits_a_long_decode_context():
    """A 16K-token decode context at page 128 (width 128): 32 splits of 512
    positions (MAX_SPLITS caps 64 of 256), each walked by one CTA."""
    lengths = (0, 1, 16384, 16000, 300)
    assert rp.split_plan(128, 128)[:2] == (4, 32)
    plan = rp.cta_plan([int(n > 0) for n in lengths], lengths, 1, 4, 128,
                       128)
    per_slot = [sum(1 for _, s, *_ in plan if s == i)
                for i in range(len(lengths))]
    assert per_slot == [0, 1, 32, 32, 1]
    assert all(k == "decode" for k, *_ in plan)
    vis = rp._visible(torch.tensor([int(n > 0) for n in lengths]),
                      torch.tensor(lengths), 1, 128 * 128, 128).numpy()
    cnt = _coverage(plan, len(lengths), 1, 128 * 128)
    np.testing.assert_array_equal(np.where(vis, cnt, 1), 1)


@pytest.mark.parametrize("slots", [8, 64, 256, 1000])
def test_split_plan_bounds_the_scratch(slots):
    """At the serving engine's defaults (chunk 128, page 128, 64 pages a
    sequence, 16 query heads on 4 kv heads) the split partials' scratch
    stays within 2 * SPLIT_CTAS * (16 + 64) rows of D + 2 floats whatever
    the slot count (a slot per possible (block, split) would need
    slots * 34 MB); 8 slots keep the uncapped decode plan, and the smoke's
    mixed batch (8 slots, 17 pages a table) the whole uncapped plan."""
    n_kv, group, qt, d, page, width = 4, 4, 128, 128, 128, 64
    n_ws = rp.scratch_floats(slots, n_kv, qt, group, d, width, page)
    assert n_ws <= 2 * rp.SPLIT_CTAS * (16 + 64) * (d + 2)
    plan = rp.split_plan(width, page, slots * n_kv, slots * n_kv * 8)
    assert plan[1] <= rp.MAX_SPLITS and plan[3] <= plan[1]
    if slots == 8:
        assert plan[:2] == rp.split_plan(width, page)[:2]
        assert (rp.split_plan(17, page, slots * n_kv, slots * n_kv * 8)
                == rp.split_plan(17, page))


def test_plan_covers_pairs_when_splits_are_capped():
    """600 slots of short chunks and decodes: SPLIT_CTAS lengthens the
    splits of both kinds, and every visible pair still lies in exactly one
    CTA's walk."""
    rng = np.random.default_rng(9)
    slots, group, qt, page, width = 600, 16, 4, 128, 16
    q_lens = np.where(rng.random(slots) < 0.5, 1, qt)
    q_lens[::50] = 0
    kv_lens = np.maximum(rng.integers(1, width * page, slots), q_lens)
    plan = rp.cta_plan(q_lens, kv_lens, qt, group, page, width)
    ppd, _, ppf, _ = rp.split_plan(width, page, slots, slots)
    assert ppd > rp.split_plan(width, page)[0] and ppf == ppd
    vis = rp._visible(torch.from_numpy(q_lens), torch.from_numpy(kv_lens),
                      qt, width * page, page).numpy()
    cnt = _coverage(plan, slots, qt, width * page)
    np.testing.assert_array_equal(np.where(vis, cnt, 1), 1)
    assert {k for k, *_ in plan} == {"decode", "prefill"}


def _pools(rng, n_pages, n_kv, page, d, quant):
    k = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    if quant is None:
        return torch.from_numpy(k), torch.from_numpy(v), None, None
    qdt = pa.QUANT_DTYPES[quant][0]
    (k8, ks), (v8, vs) = (pa.quantize_tokens(torch.from_numpy(x), dtype=qdt)
                          for x in (k, v))
    return k8, v8, ks, vs


def _split_partials(q, kp, vp, table, q_lens, kv_lens, **kw):
    """The plain partials of each of the plan's decode splits, stacked."""
    width, page = table.shape[1], kp.shape[2]
    pps, n, _, _ = rp.split_plan(width, page)
    span = pps * page
    parts = [rp.ragged_paged_partials_reference(
        q, kp, vp, table, q_lens, kv_lens, kv_range=(i * span,
                                                     (i + 1) * span), **kw)
        for i in range(n)]
    return tuple(torch.stack(x) for x in zip(*parts))


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_split_partials_merge_to_the_unsplit_ones(quant):
    """The plain partials taken per split range and merged in split order
    equal the unsplit partials: m exactly (the same scores), acc and l to
    fp32 rounding; rows that see nothing stay acc 0, m -inf, l 0."""
    rng = np.random.default_rng(11)
    page, width, n_kv, group, d = 128, 9, 2, 4, 32
    q_lens = torch.tensor([0, 1, 37, 64, 1], dtype=torch.int32)
    kv_lens = torch.tensor([0, 1100, 37, 700, 1], dtype=torch.int32)
    kp, vp, ks, vs = _pools(rng, 48, n_kv, page, d, quant)
    table = torch.from_numpy(rng.permutation(47)[: 5 * width].reshape(
        5, width).astype(np.int32) + 1)
    q = torch.from_numpy(rng.standard_normal(
        (5, n_kv * group, 64, d)).astype(np.float32))
    kw = dict(k_scales=ks, v_scales=vs, window=300)
    acc, m, l = rp.merge_partials(*_split_partials(q, kp, vp, table, q_lens,
                                                   kv_lens, **kw))
    want = rp.ragged_paged_partials_reference(q, kp, vp, table, q_lens,
                                              kv_lens, **kw)
    assert torch.equal(m, want[1])
    scale = want[0].abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
    torch.testing.assert_close(acc / scale, want[0] / scale, **SPLIT_TOL)
    torch.testing.assert_close(l, want[2], **SPLIT_TOL)
    empty = torch.isneginf(want[1])
    assert empty.any() and (acc[empty.expand_as(acc)] == 0).all()
    assert (l[empty] == 0).all()


def test_split_and_merge_agrees_with_jax():
    """tests/test_torch_ragged.py's mixed batch (a decode slot at 170, a
    full chunk, a tail chunk past a page edge, an idle slot) split by the
    kernel's plan and merged equals the JAX kernel in interpret mode."""
    rng = np.random.default_rng(0)
    slots, n_kv, group, page, width, n_pages, d, qt = 4, 2, 2, 128, 3, 8, 16, 6
    k = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    table = rng.integers(1, n_pages, size=(slots, width)).astype(np.int32)
    q_lens = np.asarray([1, qt, qt - 2, 0], np.int32)
    kv_lens = np.asarray([170, qt, 130 + qt - 2, 0], np.int32)
    q = rng.standard_normal((slots, n_kv * group, qt, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, table, q_lens, kv_lens)]
    acc, _, l = rp.merge_partials(*_split_partials(*t))
    got = (acc / torch.where(l > 0, l, 1.0)).numpy()
    want = np.asarray(jrp.ragged_paged_attention(
        *map(jnp.asarray, (q, k, v, table, q_lens, kv_lens)),
        interpret=True))
    real = np.arange(qt)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(np.moveaxis(got, 2, 1)[real],
                               np.moveaxis(want, 2, 1)[real], **TOL)


@pytest.mark.parametrize("window", [None, 100])
def test_paged_decode_as_the_qt1_instance(window):
    """Paged decode through the QT=1 reshaping its CUDA path launches (q
    [B, Nkv, G, D] as [B, Nkv*G, 1, D], q_lens None: one token where the
    length is > 0) and the ragged path equals paged_decode_reference,
    which the CPU path of paged_decode_attention runs, and JAX's paged
    decode kernel."""
    rng = np.random.default_rng(4)
    slots, n_kv, group, page, d = 5, 2, 4, 128, 16
    kp = rng.standard_normal((10, n_kv, page, d)).astype(np.float32)
    vp = rng.standard_normal((10, n_kv, page, d)).astype(np.float32)
    table = rng.integers(1, 10, size=(slots, 3)).astype(np.int32)
    lengths = np.asarray([170, 1, 300, 0, 384], np.int32)
    q = rng.standard_normal((slots, n_kv, group, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    rag = rp.ragged_paged_attention(
        t[0].view(slots, n_kv * group, 1, d), t[1], t[2], t[3], None, t[4],
        window=window).reshape(q.shape)
    ref = pa.paged_decode_reference(*t, window=window)
    torch.testing.assert_close(rag, ref, **TOL)
    torch.testing.assert_close(pa.paged_decode_attention(*t, window=window),
                               ref, **TOL)
    want = jpa.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, table,
                                                         lengths)),
                                      window=window, interpret=True)
    np.testing.assert_allclose(rag.numpy(), np.asarray(want), **TOL)
    assert (rag[3] == 0).all()


def test_merge_partials_guards_empty_splits():
    """An empty split (m -inf, l 0, acc 0) adds nothing, two empty ones
    merge to an empty row without NaN, and the order of equal-max splits
    does not matter."""
    acc = torch.tensor([[[1.0, 2.0]], [[0.0, 0.0]], [[3.0, -1.0]]])
    m = torch.tensor([[[0.5]], [[float("-inf")]], [[0.5]]])
    l = torch.tensor([[[2.0]], [[0.0]], [[1.0]]])
    a, mm, ll = rp.merge_partials(acc, m, l)
    torch.testing.assert_close(a, torch.tensor([[4.0, 1.0]]))
    assert mm.item() == 0.5 and ll.item() == 3.0
    a, mm, ll = rp.merge_partials(acc[1:2].repeat(2, 1, 1),
                                  m[1:2].repeat(2, 1, 1),
                                  l[1:2].repeat(2, 1, 1))
    assert not torch.isnan(a).any() and torch.isneginf(mm).all()
    assert (ll == 0).all() and (a == 0).all()

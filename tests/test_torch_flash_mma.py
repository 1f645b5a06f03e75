"""The bf16 flash forward on the tensor cores (csrc/flash_fwd.cu's bf16
instance: mma_tile.cuh's WarpTile walked by mma_fold), modelled on the CPU.

(a) A plain torch emulation of the instance's numerics: bf16 q, k, v,
64-token K/V chunks, base-2 online softmax with fp32 state, P fed to the
P.V product as two bf16 terms (its rounded value, then its rounded
residual), fp32 accumulators, the carry converted from (m, lse, acc) on
the way in and back on the way out.  It is held against the port's
tile_fwd and the JAX package's Pallas flash_fwd in interpret mode (both
fp32 on the same bf16-representable inputs): the raw accumulator within
ACC_RTOL of its largest entry, m and lse within STATS_ATOL, and o rounded
to bf16 within O_TOL["bf16"] (chip_smoke.py's kernel tolerances).

(b) A mirror of the instance's chunk range, the only part of its loop that
decides which columns it reads: the first chunk of the window band, the
end at the last active row's causal diagonal and kv_hi, and each warp's
skip of chunks outside its rows' columns.  Over a sweep of masks every
visible column of masks.dense_mask must fall in a chunk its row's warp
folds; a variant that starts one chunk late must miss some.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu_torch.ops import masks, tile

CHUNK = 64   # K/V tokens a chunk (kTileChunk)
BQ = 64      # q rows a CTA: four warps of 16 (WarpTile)
WARP_ROWS = 16
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# chip_smoke.py's tolerances for kernel 1 against its plain version
O_TOL_BF16 = dict(atol=2e-3, rtol=1.6e-2)
STATS_ATOL_BF16 = 1e-3
ACC_RTOL = 1e-4


def chunk_plan(q0, s_q, s_kv, spec, window=None, late=0):
    """The chunks each warp of the CTA at q row q0 folds, as mma_fold walks
    them: {warp: [chunk, ...]}.  `late` starts the walk that many chunks
    after the band's first (a mutation the sweep must catch)."""
    q_lo, q_hi, kv_hi, causal, offset = spec
    r_lo, r_hi = max(q0, q_lo), min(q0 + BQ, q_hi, s_q)
    c_end = 0
    if r_lo < r_hi:
        c_end = min(kv_hi, s_kv)
        if causal:
            c_end = min(c_end, r_hi + offset)
    i_begin = (max(0, r_lo + offset - window + 1) // CHUNK
               if window is not None else 0) + late
    n = -(-c_end // CHUNK) if c_end > 0 else 0
    plan = {}
    for w in range(BQ // WARP_ROWS):
        hi, lo = [], []
        for qr in range(q0 + WARP_ROWS * w, q0 + WARP_ROWS * (w + 1)):
            ok = q_lo <= qr < q_hi and qr < s_q
            h = min(kv_hi, s_kv) - 1
            if causal:
                h = min(h, qr + offset)
            hi.append(h if ok else -1)
            if window is not None:
                lo.append(qr + offset - window + 1 if ok else math.inf)
        w_hi, w_lo = max(hi), min(lo) if lo else 0
        plan[w] = [i for i in range(i_begin, n)
                   if CHUNK * i <= w_hi and CHUNK * i + CHUNK - 1 >= w_lo]
    return plan


def missed_columns(s_q, s_kv, spec, window=None, late=0):
    """Visible (row, col) pairs of dense_mask whose chunk the row's warp
    does not fold."""
    mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv,
                            window=window).numpy()
    folded = np.zeros_like(mask)
    for q0 in range(0, s_q, BQ):
        for w, chunks in chunk_plan(q0, s_q, s_kv, spec, window,
                                    late).items():
            r0 = q0 + WARP_ROWS * w
            for i in chunks:
                folded[r0:r0 + WARP_ROWS, CHUNK * i:CHUNK * (i + 1)] = True
    return int((mask & ~folded).sum())


def mma_fwd_emulation(q, k, v, carry, scale, spec, window=None,
                      p_terms=2):
    """The bf16 instance's arithmetic on the CPU: returns (m, lse, acc) as
    the kernel writes them without the fused finalize.  q [B,N,Sq,D], k, v
    [B,Nk,Skv,D] in bf16; `carry` (m, lse, acc) in the natural-log domain
    or None.  `p_terms` 1 rounds P once to bf16 (the variant the kernel
    does not use)."""
    b, n, s_q, d = q.shape
    s_kv = k.shape[2]
    qf = q.float()
    kf = tile._expand_kv(k, n).float()
    vf = tile._expand_kv(v, n).float()
    if carry is None:
        m2 = torch.full((b, n, s_q), -math.inf)
        l = torch.zeros(b, n, s_q)
        o = torch.zeros(b, n, s_q, d)
    else:
        m_in, lse_in, acc_in = carry
        m2 = m_in * LOG2E
        l = torch.where(m_in == -math.inf, torch.zeros_like(m_in),
                        torch.exp(lse_in - m_in))
        o = acc_in.clone()
    mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv, window=window)
    factor = scale * LOG2E
    for q0 in range(0, s_q, BQ):
        for w, chunks in chunk_plan(q0, s_q, s_kv, spec, window).items():
            rows = slice(q0 + WARP_ROWS * w,
                         min(q0 + WARP_ROWS * (w + 1), s_q))
            if rows.start >= s_q:
                continue
            for i in chunks:
                cols = slice(CHUNK * i, min(CHUNK * (i + 1), s_kv))
                s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
                s = (s * factor).masked_fill(~mask[rows, cols], -math.inf)
                m_old = m2[:, :, rows]
                m_new = torch.maximum(m_old, s.amax(-1))
                alpha = torch.where(m_old >= m_new, torch.ones_like(m_new),
                                    torch.exp2(m_old - m_new))
                p = torch.where(s == -math.inf, torch.zeros_like(s),
                                torch.exp2(s - m_new[..., None]))
                l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                pv = hi @ vf[:, :, cols]
                if p_terms == 2:
                    pv = pv + (p - hi).to(torch.bfloat16).float() @ \
                        vf[:, :, cols]
                o[:, :, rows] = o[:, :, rows] * alpha[..., None] + pv
                m2[:, :, rows] = m_new
    lse = torch.where(l > 0, m2 * LN2 + torch.log(l),
                      torch.full_like(l, -math.inf))
    return m2 * LN2, lse, o


# ---------------------------------------------------------------------------
# (b) the chunk range

# (s_q, s_kv, q_lo, q_hi, kv_hi, causal, offset, window): the scan ring's
# rounds (zigzag halves, striped offset -1), ragged lengths, cross
# lengths, windows narrower and wider than a chunk, window >= S
RANGE_SWEEP = [
    (256, 256, 0, 256, 256, 1, 0, None),
    (256, 256, 0, 256, 128, 0, 0, None),
    (256, 256, 128, 256, 256, 0, 0, None),
    (256, 256, 0, 256, 256, 1, -1, None),
    (200, 200, 0, 200, 200, 1, 0, None),
    (96, 333, 0, 96, 333, 0, 0, None),
    (1000, 1000, 0, 1000, 1000, 1, 0, None),
    (256, 256, 0, 0, 256, 1, 0, None),
    (300, 300, 0, 300, 293, 1, 0, 1),
    (300, 300, 0, 300, 300, 1, 0, 100),
    (333, 333, 0, 333, 326, 1, -1, 64),
    (512, 512, 0, 512, 512, 1, 0, 130),
    (512, 512, 37, 400, 500, 1, 0, 200),
    (256, 256, 0, 256, 249, 1, 0, 4096),
    (1000, 1000, 0, 1000, 963, 1, -1, 1024),
] + [
    # the prefix cache's suffix prefill: t_suf queries padded to a page
    # (128), after t_pre cached keys; causal at offset t_pre, rows past
    # q_hi = t_suf and keys past kv_hi = t_pre + t_suf masked
    (-(-t_suf // 128) * 128, t_pre + -(-t_suf // 128) * 128, 0, t_suf,
     t_pre + t_suf, 1, t_pre, None)
    for t_pre in (128, 1024, 1920) for t_suf in (1, 17, 128, 300)
] + [(384, 1408, 0, 300, 1324, 1, 1024, 256)]  # ... and with a window


@pytest.mark.parametrize("s_q,s_kv,q_lo,q_hi,kv_hi,causal,offset,window",
                         RANGE_SWEEP)
def test_chunk_range_covers_every_visible_column(s_q, s_kv, q_lo, q_hi,
                                                 kv_hi, causal, offset,
                                                 window):
    spec = (q_lo, q_hi, kv_hi, causal, offset)
    assert missed_columns(s_q, s_kv, spec, window) == 0
    # the walk never reads a chunk past the keys
    for q0 in range(0, s_q, BQ):
        for chunks in chunk_plan(q0, s_q, s_kv, spec, window).values():
            assert all(0 <= CHUNK * i < s_kv for i in chunks)


def test_chunk_range_late_start_misses_columns():
    """Starting the walk one chunk after the band's first drops visible
    columns on every mask of the sweep that has a visible column in its
    first chunk: the sweep can see a wrong start."""
    caught = 0
    for s_q, s_kv, *spec, window in RANGE_SWEEP:
        spec = tuple(spec)
        mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv,
                                window=window)
        if mask.any():
            caught += missed_columns(s_q, s_kv, spec, window, late=1) > 0
        else:
            assert missed_columns(s_q, s_kv, spec, window, late=1) == 0
    assert caught == sum(
        bool(masks.dense_mask(masks.MaskSpec(*c[2:7]), c[0], c[1],
                              window=c[7]).any()) for c in RANGE_SWEEP)


def test_windowed_walk_skips_chunks_below_the_band():
    """With a window the walk costs O(S * window): at S = 4096 and window
    256 a 64-row tile folds at most 6 chunks, not up to 64."""
    s, window = 4096, 256
    spec = (0, s, s, 1, 0)
    most = max(len(set().union(*map(set, chunk_plan(q0, s, s, spec,
                                                    window).values())))
               for q0 in range(0, s, BQ))
    assert most <= window // CHUNK + 2


# ---------------------------------------------------------------------------
# (a) the tile's numerics, N2 Nk1 S256 D128


def _bf16_inputs(seed, n=2, n_kv=1, s=256, d=128):
    """bf16 q, k, v and the same values as fp32 numpy arrays (exact)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(1, h, s, d, generator=g).to(torch.bfloat16)
               for h in (n, n_kv, n_kv))
    return (q, k, v), tuple(x.float().numpy() for x in (q, k, v))


def _jax_fwd(arrays, carry, scale, spec, window):
    jspec = jmasks.MaskSpec(*(jnp.int32(x) for x in spec))
    jcarry = (None,) * 3 if carry is None else tuple(
        jnp.asarray(x.numpy()) for x in carry)
    out = jflash.flash_fwd(*map(jnp.asarray, arrays), *jcarry, scale, jspec,
                           block_q=64, block_kv=64, interpret=True,
                           cast_p=False, window=window)
    return [torch.from_numpy(np.array(x)) for x in out]


def _assert_tile_close(got, want, what):
    m, lse, acc = got
    wm, wlse, wacc = want
    assert torch.equal(torch.isinf(lse), torch.isinf(wlse)), what
    fin = torch.isfinite(wlse)
    assert float((lse - wlse)[fin].abs().max()) <= STATS_ATOL_BF16, what
    assert float((m - wm)[fin].abs().max()) <= STATS_ATOL_BF16, what
    err = float((acc - wacc).abs().max())
    assert err <= ACC_RTOL * float(wacc.abs().max()), (what, err)
    o, wo = (tile.finalize(*x, torch.bfloat16) for x in (got, want))
    torch.testing.assert_close(o, wo, **O_TOL_BF16, msg=what)
    return err / float(wacc.abs().max())


# (name, spec, window, carry): a causal round onto a first full round's
# state; a ragged kv_hi under window 100 (below two chunks); the striped
# ring's offset -1 with a window and a carry
NUMERICS_CASES = [
    ("carry causal", (0, 256, 256, 1, 0), None, True),
    ("window", (0, 256, 249, 1, 0), 100, False),
    ("window carry offset -1", (0, 256, 256, 1, -1), 70, True),
    ("suffix offset", (0, 37, 165, 1, 128), None, False),
]


@pytest.mark.parametrize("name,spec,window,carry", NUMERICS_CASES)
def test_mma_tile_numerics_match_tile_fwd_and_jax(name, spec, window, carry):
    scale = 128**-0.5
    (q, k, v), arrays = _bf16_inputs(5)
    st = None
    if carry:  # a first round's state over other keys, from the plain tile
        (_, k0, v0), _ = _bf16_inputs(6)
        st = tile.tile_fwd(q, k0, v0, *tile.init_state(1, 2, 256, 128),
                           scale, masks.full_spec(256, 256))
    got = mma_fwd_emulation(q, k, v, st, scale, spec, window)
    init = tile.init_state(1, 2, 256, 128) if st is None else st
    want = tile.tile_fwd(*(torch.from_numpy(a) for a in arrays), *init,
                         scale, masks.MaskSpec(*spec), window=window)
    _assert_tile_close(got, want, f"{name} vs tile_fwd")
    _assert_tile_close(got, _jax_fwd(arrays, st, scale, spec, window),
                       f"{name} vs the JAX kernel")


def test_mma_tile_needs_p_as_two_terms():
    """P rounded once to bf16 moves the raw accumulator past ACC_RTOL of
    its largest entry at this shape, the two-term P stays well inside it:
    the emulation resolves the choice the kernel makes."""
    scale = 128**-0.5
    (q, k, v), arrays = _bf16_inputs(7)
    (_, k0, v0), _ = _bf16_inputs(8)
    st = tile.tile_fwd(q, k0, v0, *tile.init_state(1, 2, 256, 128), scale,
                       masks.full_spec(256, 256))
    spec = (0, 256, 256, 1, 0)
    want = tile.tile_fwd(*(torch.from_numpy(a) for a in arrays), *st, scale,
                         masks.MaskSpec(*spec))
    errs = {}
    for terms in (1, 2):
        acc = mma_fwd_emulation(q, k, v, st, scale, spec, p_terms=terms)[2]
        errs[terms] = float((acc - want[2]).abs().max()) / float(
            want[2].abs().max())
    assert errs[2] <= ACC_RTOL / 4, errs
    assert errs[1] > ACC_RTOL, errs

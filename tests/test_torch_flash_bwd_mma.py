"""The split flash backward's bf16 instances on the tensor cores
(csrc/flash_bwd.cu: kernel 4, flash_bwd_dq_mma, on the forward's tile;
kernel 5, flash_bwd_dkdv_mma, on mma_bwd_tile.cuh's step without the dq
fold), modelled on the CPU.

(a) A plain torch emulation of each instance's numerics: bf16 inputs,
64-row tiles in the kernel's order, base-2 P from the final lse (no
running max), P and dS fed to their products as two bf16 terms (the
rounded value, then its rounded residual), fp32 sums, each step's
product added to the accumulator by an fp32 add, the scale applied once
at the store.  It is held against the port's tile_bwd and the JAX
package's split flash_bwd (fused=False, Pallas interpret mode), both fp32
on the same bf16-representable inputs, within BWD_RTOL of the largest
entry + BWD_ATOL (chip_smoke.py's bar for the kernels on the card).

(b) One bf16 rounding of dS (dq) or of P and dS (dk/dv) misses that bar:
the emulation resolves the choice the kernels make.

(c) A mirror of each kernel's tile ranges, the only part of its loops
that decides what it reads: the kv chunks the dq CTA of a q tile visits
(up to the last active row's causal diagonal and kv_hi, each warp
skipping chunks past its rows' last visible column) and the q tiles the
dk/dv CTA of a kv tile visits.  Over a sweep of masks every visible
(row, column) of masks.dense_mask must be covered; a walk one tile short
must miss some.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu_torch.ops import masks, tile

BQ = BKV = CHUNK = 64  # q rows a CTA, kv rows a tile, K/V tokens a chunk
WARP_ROWS = 16         # q rows a warp of the dq kernel
LOG2E = 1.4426950408889634
BWD_RTOL, BWD_ATOL = 1e-4, 1e-6  # chip_smoke.py's backward kernel bar
D = 128


# ---------------------------------------------------------------------------
# (c) the tile ranges


def dq_chunks(q0, s_q, s_kv, spec, short=0):
    """The kv chunks each warp of the dq CTA at q row q0 folds, as
    flash_bwd_dq_mma_kernel walks them: {warp: [chunk, ...]}.  `short`
    ends the walk that many chunks early (a mutation the sweep must
    catch)."""
    q_lo, q_hi, kv_hi, causal, offset = spec
    r_lo, r_hi = max(q0, q_lo), min(q0 + BQ, q_hi, s_q)
    c_end = 0
    if r_lo < r_hi:
        c_end = min(kv_hi, s_kv)
        if causal:
            c_end = min(c_end, r_hi + offset)
    n = (-(-c_end // CHUNK) if c_end > 0 else 0) - short
    plan = {}
    for w in range(BQ // WARP_ROWS):
        hi = []
        for qr in range(q0 + WARP_ROWS * w, q0 + WARP_ROWS * (w + 1)):
            h = min(kv_hi, s_kv) - 1
            if causal:
                h = min(h, qr + offset)
            hi.append(h if q_lo <= qr < q_hi and qr < s_q else -1)
        plan[w] = [i for i in range(n) if CHUNK * i <= max(hi)]
    return plan


def kv_q_tiles(j0, s_q, s_kv, spec, short=0):
    """The q tiles the dk/dv CTA of the kv tile at column j0 visits, in
    flash_bwd_dkdv_mma_kernel's order (from the last down); `short` drops
    that many from the top (a mutation the sweep must catch)."""
    q_lo, q_hi, kv_hi, causal, offset = spec
    i_lo, i_hi = max(q_lo, 0), min(q_hi, s_q)
    if causal:
        i_lo = max(i_lo, j0 - offset)
    if j0 >= min(kv_hi, s_kv):
        i_hi = i_lo
    t_lo = i_lo // BQ
    t_hi = -(-i_hi // BQ) if i_hi > i_lo else t_lo
    return list(range(t_hi - 1 - short, t_lo - 1, -1))


def covered(s_q, s_kv, spec, short=0):
    """(dq, dk/dv) boolean [s_q, s_kv] maps of the (row, column) pairs
    each kernel's walk reaches."""
    dq = np.zeros((s_q, s_kv), bool)
    for q0 in range(0, s_q, BQ):
        for w, chunks in dq_chunks(q0, s_q, s_kv, spec, short).items():
            r0 = q0 + WARP_ROWS * w
            for i in chunks:
                dq[r0:r0 + WARP_ROWS, CHUNK * i:CHUNK * (i + 1)] = True
    kv = np.zeros((s_q, s_kv), bool)
    for j0 in range(0, s_kv, BKV):
        for t in kv_q_tiles(j0, s_q, s_kv, spec, short):
            kv[BQ * t:BQ * (t + 1), j0:j0 + BKV] = True
    return dq, kv


# (s_q, s_kv, q_lo, q_hi, kv_hi, causal, offset): the scan ring's rounds
# (contig causal and full, zigzag's half rounds, striped's offset -1, a
# future round with no rows), ragged and cross lengths, a positive offset
RANGE_SWEEP = [
    (256, 256, 0, 256, 256, 1, 0),
    (256, 256, 0, 256, 128, 0, 0),
    (256, 256, 128, 256, 256, 0, 0),
    (256, 256, 0, 256, 256, 1, -1),
    (256, 256, 0, 0, 256, 1, 0),
    (200, 200, 0, 200, 200, 1, 0),
    (96, 333, 0, 96, 333, 0, 0),
    (300, 260, 37, 250, 200, 1, -1),
    (512, 512, 37, 400, 500, 1, 0),
    (256, 512, 0, 256, 512, 1, 256),
    (1000, 1000, 0, 1000, 1000, 1, 0),
]


@pytest.mark.parametrize("s_q,s_kv,q_lo,q_hi,kv_hi,causal,offset",
                         RANGE_SWEEP)
def test_tile_ranges_cover_every_visible_pair(s_q, s_kv, q_lo, q_hi, kv_hi,
                                              causal, offset):
    spec = (q_lo, q_hi, kv_hi, causal, offset)
    mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv).numpy()
    for name, seen in zip(("dq", "dk/dv"), covered(s_q, s_kv, spec)):
        assert not (mask & ~seen).any(), name
    # neither walk reads past the keys or the queries
    for q0 in range(0, s_q, BQ):
        for chunks in dq_chunks(q0, s_q, s_kv, spec).values():
            assert all(0 <= CHUNK * i < s_kv for i in chunks)
    for j0 in range(0, s_kv, BKV):
        assert all(0 <= BQ * t < s_q for t in kv_q_tiles(j0, s_q, s_kv, spec))


def test_tile_ranges_one_tile_short_miss_pairs():
    """Each walk one tile short (the dq CTA's last chunk, the dk/dv CTA's
    top q tile) drops visible pairs on every mask of the sweep that has
    one: the sweep can see a wrong end."""
    for s_q, s_kv, *spec in RANGE_SWEEP:
        spec = tuple(spec)
        mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv).numpy()
        for name, seen in zip(("dq", "dk/dv"),
                              covered(s_q, s_kv, spec, short=1)):
            assert (mask & ~seen).any() == mask.any(), (name, s_q, spec)


def test_causal_walks_stop_at_the_diagonal():
    """A causal dq CTA reads chunks only up to its diagonal and a dk/dv CTA
    q tiles only from it: at S = 1024 the pair tiles visited are the
    triangle's 136 of 256, not the square."""
    s, spec = 1024, (0, 1024, 1024, 1, 0)
    n = s // BQ
    dq = sum(len(set().union(*map(set, dq_chunks(q0, s, s, spec).values())))
             for q0 in range(0, s, BQ))
    kv = sum(len(kv_q_tiles(j0, s, s, spec)) for j0 in range(0, s, BKV))
    assert dq == kv == n * (n + 1) // 2


# ---------------------------------------------------------------------------
# (a), (b) the numerics


def _terms(x, terms):
    """x as a kernel feeds it to a bf16 product: the rounded value, then
    (two terms) its rounded residual."""
    hi = x.bfloat16().float()
    return [hi] if terms == 1 else [hi, (x - hi).bfloat16().float()]


def _p_ds(qf, kf, vf, dof, lse2, delta, mask, scale):
    """P and dS of one (q rows, kv columns) tile, fp32, base 2."""
    s = qf @ kf.mT
    dp = dof @ vf.mT
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    return p, p * (dp - delta[..., None])


def _base2_lse(lse):
    """lse in base 2, +inf for a row that sees nothing (P = 0)."""
    return torch.where(lse == -math.inf, torch.full_like(lse, math.inf),
                       lse * LOG2E)


def dq_emulation(do, q, k, v, delta, lse, scale, spec, terms=2):
    """flash_bwd_dq_mma_kernel's arithmetic: dq [B,N,Sq,D] fp32."""
    b, n, s_q, d = q.shape
    s_kv = k.shape[2]
    qf, dof = q.float(), do.float()
    kf, vf = (tile._expand_kv(x, n).float() for x in (k, v))
    mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv)
    lse2 = _base2_lse(lse)
    dq = torch.zeros(b, n, s_q, d)
    for q0 in range(0, s_q, BQ):
        for w, chunks in dq_chunks(q0, s_q, s_kv, spec).items():
            r = slice(q0 + WARP_ROWS * w, min(q0 + WARP_ROWS * (w + 1), s_q))
            if r.start >= s_q:
                continue
            for i in chunks:
                c = slice(CHUNK * i, min(CHUNK * (i + 1), s_kv))
                _, ds = _p_ds(qf[:, :, r], kf[:, :, c], vf[:, :, c],
                              dof[:, :, r], lse2[:, :, r], delta[:, :, r],
                              mask[r, c], scale)
                dq[:, :, r] += sum(t @ kf[:, :, c] for t in _terms(ds, terms))
    return dq * scale


def dkdv_emulation(do, q, k, v, delta, lse, scale, spec, terms=2):
    """flash_bwd_dkdv_mma_kernel's arithmetic: dk, dv [B,Nk,Skv,D] fp32,
    the GQA group summed in the CTA."""
    n, s_q = q.shape[1], q.shape[2]
    b, n_kv, s_kv, d = k.shape
    group = n // n_kv
    qf, dof, kf, vf = (x.float() for x in (q, do, k, v))
    mask = masks.dense_mask(masks.MaskSpec(*spec), s_q, s_kv)
    lse2 = _base2_lse(lse)
    dk, dv = torch.zeros(b, n_kv, s_kv, d), torch.zeros(b, n_kv, s_kv, d)
    for j0 in range(0, s_kv, BKV):
        c = slice(j0, min(j0 + BKV, s_kv))
        tiles = kv_q_tiles(j0, s_q, s_kv, spec)
        for hk in range(n_kv):
            for h in range(hk * group, (hk + 1) * group):
                for t in tiles:
                    r = slice(BQ * t, min(BQ * (t + 1), s_q))
                    p, ds = _p_ds(qf[:, h, r], kf[:, hk, c], vf[:, hk, c],
                                  dof[:, h, r], lse2[:, h, r],
                                  delta[:, h, r], mask[r, c], scale)
                    dv[:, hk, c] += sum(x.mT @ dof[:, h, r]
                                        for x in _terms(p, terms))
                    dk[:, hk, c] += sum(x.mT @ qf[:, h, r]
                                        for x in _terms(ds, terms))
    return dk * scale, dv


def _case(seed, n, n_kv, s_q, s_kv, spec):
    """bf16 (do, q, k, v) from seeded numpy, the round's final lse and
    delta from the plain fp32 forward on the same values: the kernels'
    inputs and the same values as fp32 numpy arrays for the JAX side."""
    rng = np.random.default_rng(seed)
    do, q = (torch.from_numpy(rng.standard_normal((1, n, s_q, D),
                                                  np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, n_kv, s_kv, D),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    ms = masks.MaskSpec(*spec)
    m, lse, acc = tile.tile_fwd(q.float(), k.float(), v.float(),
                                *tile.init_state(1, n, s_q, D), D**-0.5, ms)
    o = tile.finalize(m, lse, acc, torch.float32)
    delta = (o * do.float()).sum(-1)
    args = (do, q, k, v, delta, lse, D**-0.5, spec)
    arrays = tuple(x.float().numpy() for x in (do, q, k, v, delta, lse))
    return args, arrays


def _jax_split(arrays, spec):
    jspec = jmasks.MaskSpec(*(jnp.int32(x) for x in spec))
    out = jflash.flash_bwd(*map(jnp.asarray, arrays), D**-0.5, jspec,
                           block_q=BQ, block_kv=BKV, interpret=True,
                           fused=False)
    return [torch.from_numpy(np.array(x)) for x in out]


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _held(got, want):
    return float((got - want).abs().max()) <= \
        BWD_RTOL * float(want.abs().max()) + BWD_ATOL


# (name, n, n_kv, s_q, s_kv, spec): MHA causal; GQA non-causal; GQA
# group 4, causal, a ragged edge; cross lengths under a ragged round
# (q_lo 37, q_hi 250, kv_hi 200, striped offset -1)
NUMERICS_CASES = [
    ("MHA causal", 2, 2, 256, 256, (0, 256, 256, 1, 0)),
    ("GQA non-causal", 4, 2, 192, 192, (0, 192, 192, 0, 0)),
    ("GQA causal ragged", 4, 1, 200, 200, (0, 200, 200, 1, 0)),
    ("ragged round", 2, 1, 300, 260, (37, 250, 200, 1, -1)),
]


@pytest.mark.parametrize("name,n,n_kv,s_q,s_kv,spec", NUMERICS_CASES)
def test_split_mma_numerics_match_tile_bwd_and_jax(name, n, n_kv, s_q, s_kv,
                                                    spec):
    args, arrays = _case(3, n, n_kv, s_q, s_kv, spec)
    got = (dq_emulation(*args), *dkdv_emulation(*args))
    plain = tile.tile_bwd(*(torch.from_numpy(a) for a in arrays), D**-0.5,
                          masks.MaskSpec(*spec))
    jax_split = _jax_split(arrays, spec)
    for want, what in ((plain, "tile_bwd"), (jax_split, "JAX split")):
        for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
            assert _held(g, w), (name, what, grad, _rel_err(g, w))
    # rows that see nothing get exact zeros (q_lo, q_hi; kv_hi's columns)
    q_lo, q_hi, kv_hi = spec[:3]
    assert (got[0][:, :, :q_lo] == 0).all() and \
        (got[0][:, :, q_hi:] == 0).all()
    assert (got[1][:, :, kv_hi:] == 0).all() and \
        (got[2][:, :, kv_hi:] == 0).all()


def test_split_mma_needs_two_bf16_terms():
    """Rounded once to bf16, dS moves dq, and P and dS move dk or dv, past
    BWD_RTOL of their largest entry at N2 S256 D128 causal; the two-term
    feeds stay well inside it."""
    spec = (0, 256, 256, 1, 0)
    args, arrays = _case(8, 2, 2, 256, 256, spec)
    want = tile.tile_bwd(*(torch.from_numpy(a) for a in arrays), D**-0.5,
                         masks.MaskSpec(*spec))
    errs = {}
    for terms in (1, 2):
        got = (dq_emulation(*args, terms=terms),
               *dkdv_emulation(*args, terms=terms))
        errs[terms] = [_rel_err(g, w) for g, w in zip(got, want)]
        print(f"{terms} bf16 term(s): dq, dk, dv off by {errs[terms]} of "
              "their largest entry")
    assert max(errs[2]) <= BWD_RTOL / 4, errs
    assert errs[1][0] > BWD_RTOL, errs            # dq
    assert max(errs[1][1:]) > BWD_RTOL, errs      # dk, dv

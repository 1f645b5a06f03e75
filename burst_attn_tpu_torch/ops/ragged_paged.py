"""Ragged paged attention (port of burst_attn_tpu/ops/ragged_paged.py): ONE
launch for a mixed prefill+decode token batch against the paged KV pool.

Each slot brings its own query token count `q_lens[s]` (0 = idle, 1 =
decode, up to the chunk width = prefill); query token t of slot s sits at
absolute position `kv_lens[s] - q_lens[s] + t` and sees the pool positions
at or below it (with a sliding `window`, only its last `window` of
them).  `ragged_paged_attention` launches the hand-written kernel
in csrc/ragged_paged.cu for CUDA tensors (or raises) and runs the plain
version for CPU tensors.  Paged decode (ops/paged_attention.py) is the
kernel's QT == 1 instance, so a QT == 1 ragged launch is bitwise
`paged_decode_attention` on the same pool.

The kernel's grid (`cta_plan` mirrors it on the host, and the card tests
hold the mirror to the kernel's own record of its CTAs): a block of the
kv head's G query heads times up to 64 // G tokens takes the prefill tile
when more than 16 of its rows are real tokens, else the decode tile;
every block's context is cut into the `split_plan` splits of its kind,
one CTA each, and the block's last split merges their partials in split
order (`merge_partials` is the plain merge).  The q layout
[S, Nq, QT, D] is indexed directly by the kernel: the TPU kernel's group
folding copies and 8-sublane row padding are TPU tiling artefacts and
have no counterpart.  `ragged_paged_attention_grouped` is
the shared-prefix front end: the private band through the kernel's split-k
partials, the shared band and the log-sum-exp merge in plain torch (they
are plain jnp outside any Pallas kernel in the JAX package too).
`ragged_supported` states the kernel's limits with prefix-stable reasons;
the serving engine maps a declined shape to its dense route.
"""

import math

import torch

from . import _build
from .flash import KERNEL_DTYPES, KERNEL_HEAD_DIMS, _check_kernel_operand
from .paged_attention import (
    KERNEL_PAGE_MULTIPLE, check_pool_operands, data_ptr, gather_pages,
)

KERNEL_MAX_ROWS = 64  # query rows per block (csrc/ragged_paged.cu MAXR)
KERNEL_DECODE_ROWS = 16  # a block with at most this many real rows decodes
SPLIT_TOKENS = 256    # context positions per decode split ...
MAX_SPLITS = 32       # ... unless the table would cut into more splits
PREFILL_GROUP = 2     # a prefill split spans this many decode splits ...
SPLIT_CTAS = 2048     # ... and each kind's splits stop multiplying once
#                       its possible blocks times its splits reach this
SMEM_LIMIT = 232448   # dynamic shared memory one block can use on Hopper
LOG2E = math.log2(math.e)


def _smem_plan(d_head: int, dtype=torch.bfloat16) -> int:
    """csrc/ragged_paged.cu smem_bytes() for q's dtype, on its largest
    pool: the larger of the math's plan and the emit buffers.  bf16: q rows
    and two stages of K/V chunks (rows padded by 16 bytes), and for a
    1-byte pool the chunk widened to bf16; fp32: q rows, two stages, the
    scores and per-row rescales in fp32; emit: a block's fp32 rows, their
    (m, l) and the merge weights."""
    rows, ch = KERNEL_MAX_ROWS, KERNEL_PAGE_MULTIPLE

    def stages(esz, quant):  # two stages of K and V, scales of a 1 B pool
        return 2 * 2 * ch * (d_head * esz + 16) + (2 * 2 * ch * 4 if quant
                                                   else 0)

    if dtype == torch.float32:
        math_ = max(4 * rows * d_head + stages(esz, esz == 1)
                    + 4 * rows * ch + 4 * rows for esz in (4, 1))
    else:
        q_tile = 2 * rows * (d_head + 8)
        math_ = max(q_tile + stages(2, False),
                    q_tile + stages(1, True) + 2 * 2 * ch * (d_head + 8))
    emit = 4 * (rows * d_head + 4 * rows + 2 * MAX_SPLITS * rows) + 16
    return max(math_, emit)


def split_plan(width: int, page: int, items: int = 1, blocks: int = 1):
    """(pages a decode split, decode splits, pages a prefill split,
    prefill splits) of the kernel's split-k for a page table `width`
    columns wide, a launch of `items` (slot, kv head) pairs (each holds at
    most one decode block) and `blocks` q-blocks in all.  A decode split
    covers SPLIT_TOKENS positions (at least one page), more when that
    would make more than MAX_SPLITS; a prefill split PREFILL_GROUP times
    that.  Either grows further until its kind's possible CTAs (items or
    blocks times splits) stay within SPLIT_CTAS, past which splitting
    adds no parallelism the grid lacks: that bounds the partials' scratch
    whatever the slot count (`scratch_floats`).  Always at least one
    split.  The wrapper passes the plan to the kernel, which checks it."""
    def cut(pps, cap):
        pps = max(pps, -(-width // cap))
        return pps, max(1, -(-width // pps))

    pps, _ = cut(max(1, SPLIT_TOKENS // page), MAX_SPLITS)
    return (*cut(pps, max(1, -(-SPLIT_CTAS // items))),
            *cut(PREFILL_GROUP * pps, max(1, -(-SPLIT_CTAS // blocks))))


def _grid(s, n_kv, qt, group, width, page):
    """(bq, nqb, split plan) of a launch, from shapes alone."""
    bq = min(qt, KERNEL_MAX_ROWS // group)
    nqb = -(-qt // bq)
    return bq, nqb, split_plan(width, page, s * n_kv, s * n_kv * nqb)


def scratch_floats(s, n_kv, qt, group, d, width, page):
    """fp32 elements of the split partials' scratch a launch needs
    (csrc/ragged_paged.cu ws): (D + 2) floats a row, min(16, bq * G) rows
    for each decode split of each (slot, kv head) when decode blocks
    split, bq * G rows for each prefill split of each q-block when prefill
    blocks split.  SPLIT_CTAS bounds it at ~2 * SPLIT_CTAS * (16 + 64)
    rows, ~170 MB at d 128, whatever the slot count."""
    bq, nqb, (_, nsd, _, nsf) = _grid(s, n_kv, qt, group, width, page)
    rows = bq * group
    n_dec = s * n_kv * nsd * min(KERNEL_DECODE_ROWS, rows) if nsd > 1 else 0
    n_pre = s * n_kv * nqb * nsf * rows if nsf > 1 else 0
    return (n_dec + n_pre) * (d + 2)


def cta_plan(q_lens, kv_lens, qt, group, page, width, ctx_lo=None,
             window=None, n_kv=1):
    """Host mirror of the kernel's grid for one kv head of a launch of
    `n_kv` of them: one tuple (kind, slot, t_lo, t_hi, pos_lo, pos_hi)
    per CTA that computes, "prefill" (more than 16 real rows: the prefill
    tile) or "decode", walking query tokens [t_lo, t_hi) of the slot
    against the 64-token chunks that cover positions [pos_lo, pos_hi]
    (the kernel masks each row within them), one per live split of each
    block.  CTAs that exit at once (idle blocks, splits outside the
    visible positions) are not listed."""
    ch = KERNEL_PAGE_MULTIPLE
    n_slots = len(q_lens)
    bq, _, (ppd, _, ppf, _) = _grid(n_slots, n_kv, qt, group, width, page)
    plan = []
    for s, (q_len, kv) in enumerate(zip(map(int, q_lens), map(int, kv_lens))):
        q_start = kv - q_len
        for t0q in range(0, qt, bq):
            t_end = min(q_len, t0q + bq)
            live = (t_end - t0q) * group
            if live <= 0:
                continue
            hi = min(q_start + t_end - 1, width * page - 1)
            lo = 0 if ctx_lo is None else max(int(ctx_lo[s]), 0) // page * page
            if window is not None:
                lo = max(lo, q_start + t0q - window + 1)
            c_lo, c_hi = lo // ch, (hi // ch if hi >= 0 else -1)
            kind = "decode" if live <= KERNEL_DECODE_ROWS else "prefill"
            span = (ppd if kind == "decode" else ppf) * page // ch
            for sp in range(c_lo // span, c_hi // span + 1):
                a, e = max(c_lo, sp * span), min(c_hi, sp * span + span - 1)
                plan.append((kind, s, t0q, t_end, a * ch, e * ch + ch - 1))
    return plan


def merge_partials(acc, m, l):
    """Merge split-k partials stacked on dim 0 (acc [n, ..., D], m and l
    [n, ..., 1], base 2) in order, as the kernel's last split does: the
    row max over the splits, each split weighted by exp2(m_i - max), and a
    split whose m is not below the max (an empty split against an empty
    row included) weighted 1, so no -inf - -inf NaN is ever formed.
    Returns the merged (acc, m, l)."""
    m_g = m.amax(dim=0)
    w = torch.where(m >= m_g, 1.0, torch.exp2(m - m_g))
    acc_g, l_g = acc[0] * w[0], l[0] * w[0]
    for i in range(1, acc.shape[0]):
        acc_g = acc_g + acc[i] * w[i]
        l_g = l_g + l[i] * w[i]
    return acc_g, m_g, l_g


def ragged_supported(*, n_kv_heads, n_q_heads, q_tokens, d_head, page,
                     dtype=torch.bfloat16, device="cuda"):
    """Capability probe: None when ragged_paged_attention can serve this
    shape, else a reason whose PREFIX is a stable key (the serving engine
    maps it to a bounded fallback-counter label).  The limits are the CUDA
    kernel's; on the CPU (`device="cpu"`) the plain version takes any head
    dim and dtype, as the JAX probe relaxes the head dim in interpret
    mode.  A quantized pool changes no limit.  A launch's split scratch
    (`scratch_floats`) stays under ~170 MB at d_head 128 whatever the
    slot count, so it sets no limit either."""
    if q_tokens < 1:
        return f"empty q chunk: q_tokens {q_tokens} < 1"
    if n_q_heads % n_kv_heads:
        return (f"GQA group mismatch: {n_q_heads} query heads not a "
                f"multiple of {n_kv_heads} kv heads")
    if page % KERNEL_PAGE_MULTIPLE:
        return (f"page size {page} is not a multiple of the "
                f"{KERNEL_PAGE_MULTIPLE}-token chunk")
    group = n_q_heads // n_kv_heads
    if group > KERNEL_MAX_ROWS:
        return (f"q-block rows: group {group} exceeds the "
                f"{KERNEL_MAX_ROWS}-row block")
    plan = _smem_plan(d_head, dtype)
    if plan > SMEM_LIMIT:
        return (f"shared-memory plan {plan} bytes exceeds the {SMEM_LIMIT} "
                f"a block can use (d_head {d_head})")
    if torch.device(device).type == "cpu":
        return None
    if d_head not in KERNEL_HEAD_DIMS:
        return (f"head dim {d_head} is not one the kernel is built for "
                f"{KERNEL_HEAD_DIMS}")
    if dtype not in KERNEL_DTYPES:
        return f"dtype {dtype} is not one of {list(KERNEL_DTYPES)}"
    return None


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                           *, k_scales=None, v_scales=None, window=None,
                           scale=None, ctx_lo=None, emit_partials=False):
    """Mixed prefill+decode ragged attention against a paged KV pool.

    q          [S, Nq, QT, D]    query tokens per slot; rows at or past
                                 q_lens[s] are padding and give zeros
    k_pages    [P, Nkv, page, D] shared pool in q's dtype or int8 / fp8 —
    v_pages    [P, Nkv, page, D] the new tokens' K/V must already be in it
    page_table [S, n_slots] int32 pool page per (slot, table column)
    q_lens     [S] int32         query tokens this launch (0 = idle slot);
                                 None: one token per slot whose kv_lens
                                 is > 0 (a decode step, as paged decode
                                 launches the kernel)
    kv_lens    [S] int32         live tokens INCLUDING this launch's
    k_scales / v_scales          [P, Nkv, page] fp32 per-token dequant
                                 scales of a quantized pool, both or neither
    ctx_lo     [S] int32         page-aligned lower context bound: whole
                                 pages below it are excluded
    window     int >= 1 or None  sliding window: the token at position qp
                                 sees qp - window + 1 .. qp
    emit_partials                return the unnormalized split-k partial
                                 (acc [S,Nq,QT,D], m [S,Nq,QT,1],
                                 l [S,Nq,QT,1], fp32, base-2 softmax
                                 domain) instead of the output

    Returns [S, Nq, QT, D] in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if q.shape[1] % k_pages.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads not grouped by "
                         f"{k_pages.shape[1]} kv heads")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if q_lens is None:
            q_lens = (kv_lens > 0).to(torch.int32)
        acc, m, l = ragged_paged_partials_reference(
            q, k_pages, v_pages, page_table, q_lens, kv_lens,
            k_scales=k_scales, v_scales=v_scales, scale=scale,
            ctx_lo=ctx_lo, window=window)
        if emit_partials:
            return acc, m, l
        return _normalize(acc, l, q.dtype)
    result = launch(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                    k_scales, v_scales, scale, ctx_lo, emit_partials, window,
                    "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return result


ragged_paged_attention.launches = 0


_COUNTERS = {}


def _split_counters(dev, n):
    """The blocks' split-arrival counters for launches on the current
    stream of `dev`: zeroed when allocated and left zero by every launch
    (a block's last split resets its counter), so they are reused.  One
    buffer per stream: launches on one stream never overlap."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = c
    return c


def launch(q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales,
           v_scales, scale, ctx_lo, emit_partials, window, what, trace=None):
    """Check the operands and launch csrc/ragged_paged.cu once (no launch
    count: the caller's wrapper counts it).  q_lens None: one query token
    per slot whose kv_lens is > 0 (paged decode).  `what` names the caller
    in errors.  `trace`, an int64 tensor of `trace_shape(...)`, receives
    each CTA's record (`read_trace`; bf16 q and pool only); None records
    nothing."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    width = page_table.shape[1]
    reason = ragged_supported(n_kv_heads=n_kv, n_q_heads=n_q, q_tokens=qt,
                              d_head=d, page=page, dtype=q.dtype)
    if reason is not None:
        raise ValueError(f"{what} kernel: {reason}")
    _check_kernel_operand("q", q, dev, q.dtype)
    kv_code = check_pool_operands(q, k_pages, v_pages, k_scales, v_scales)
    _check_kernel_operand("page_table", page_table, dev, torch.int32,
                          (s, width))
    for name, t in (("q_lens", q_lens), ("kv_lens", kv_lens),
                    ("ctx_lo", ctx_lo)):
        if t is not None:  # q_lens None: one token where kv_lens > 0
            _check_kernel_operand(name, t, dev, torch.int32, (s,))
    group = n_q // n_kv
    if trace is not None:  # recorded by the bf16 instances
        if q.dtype != torch.bfloat16 or k_pages.dtype != q.dtype:
            raise ValueError(f"{what}: a trace needs bf16 q and pool")
        _check_kernel_operand("trace", trace, dev, torch.int64,
                              trace_shape(s, n_kv, qt, group, width, page))
    out = acc = m = l = None
    if emit_partials:
        acc = torch.empty(q.shape, dtype=torch.float32, device=dev)
        m = torch.empty((s, n_q, qt, 1), dtype=torch.float32, device=dev)
        l = torch.empty((s, n_q, qt, 1), dtype=torch.float32, device=dev)
        result = (acc, m, l)
    else:
        result = out = torch.empty_like(q)
    if q.numel() == 0:
        return result
    _, nqb, plan = _grid(s, n_kv, qt, group, width, page)
    n_ws = scratch_floats(s, n_kv, qt, group, d, width, page)
    ws = counters = None
    if n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
        counters = _split_counters(dev, s * n_kv * nqb)
    lib = _build.load("ragged_paged")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ragged_paged_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            data_ptr(k_scales), data_ptr(v_scales), page_table.data_ptr(),
            data_ptr(q_lens), kv_lens.data_ptr(), data_ptr(ctx_lo),
            data_ptr(out), data_ptr(acc), data_ptr(m), data_ptr(l),
            data_ptr(ws), data_ptr(counters), data_ptr(trace), s, n_kv,
            group, qt, d, page, width, 0 if window is None else int(window),
            *plan, n_ws, KERNEL_DTYPES[q.dtype], kv_code, float(scale),
            stream)
    _build.check(err, what)
    return result


TRACE_FIELDS = ("kind", "a", "e", "t0_ns", "t1_ns", "cycles")
TRACE_KINDS = ("exit", "decode", "prefill")


def trace_shape(s, n_kv, qt, group, width, page):
    """[S, Nkv, grid x, fields] of a launch's CTA records: the grid is
    (nqb * decode splits, Nkv, S)."""
    _, nqb, (_, nsd, _, _) = _grid(s, n_kv, qt, group, width, page)
    return (s, n_kv, nqb * nsd, len(TRACE_FIELDS))


def read_trace(trace, qt, group, width, page):
    """The kernel's CTA records as dicts, one per CTA: slot, kv head,
    kind ("exit": returned before any math; "decode" / "prefill": the
    tile it ran), q-block, its chunks [a, e] (64 positions each), and its
    %globaltimer start and end (ns) and SM cycles (clock64)."""
    s, n_kv, gx, _ = trace.shape
    _, nqb, _ = _grid(s, n_kv, qt, group, width, page)
    nsd = gx // nqb
    bq = min(qt, KERNEL_MAX_ROWS // group)
    recs = []
    for i, row in enumerate(trace.reshape(-1, len(TRACE_FIELDS)).tolist()):
        r = dict(zip(TRACE_FIELDS, row))
        r.update(slot=i // (n_kv * gx), head=i // gx % n_kv,
                 t0q=i % gx // nsd * bq, kind=TRACE_KINDS[r["kind"]])
        recs.append(r)
    return recs


def _normalize(acc, l, dtype):
    """acc / l, with rows that saw nothing (l == 0) giving zeros."""
    return (acc / torch.where(l > 0, l, 1.0)).to(dtype)


def _visible(q_lens, kv_lens, qt, n_pos, page, ctx_lo=None, window=None):
    """[S, QT, n_pos] bool: query token t of slot s sees pool position j.
    Padding rows (t >= q_lens) see nothing; ctx_lo drops whole pages; a
    window drops the positions below each token's band."""
    dev = q_lens.device
    t = torch.arange(qt, device=dev)
    col = torch.arange(n_pos, device=dev)
    qp = (kv_lens - q_lens).long()[:, None] + t[None, :]       # [S, QT]
    valid = col[None, None, :] <= qp[:, :, None]
    if window is not None:
        valid &= col[None, None, :] > qp[:, :, None] - window
    valid &= (t[None, :] < q_lens[:, None])[:, :, None]
    if ctx_lo is not None:
        lo = (ctx_lo.long() // page) * page
        valid &= col[None, None, :] >= lo[:, None, None]
    return valid


def ragged_paged_partials_reference(q, k_pages, v_pages, page_table, q_lens,
                                    kv_lens, *, k_scales=None,
                                    v_scales=None, scale=None, ctx_lo=None,
                                    window=None, kv_range=None):
    """Plain version of the kernel's split-k partials: dequantizes the
    gathered pages, then a masked base-2 softmax in fp32 without the final
    division.  `kv_range=(lo, hi)` keeps positions lo <= j < hi only (one
    decode split's share).  Returns (acc [S,Nq,QT,D], m [S,Nq,QT,1],
    l [S,Nq,QT,1]); rows that see nothing give acc 0, m -inf, l 0.
    O(S·n_slots·page) memory."""
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    group = n_q // n_kv
    if scale is None:
        scale = d**-0.5
    k = gather_pages(k_pages, k_scales, page_table).float()  # [S,Nkv,T,D]
    v = gather_pages(v_pages, v_scales, page_table).float()
    qg = q.reshape(s, n_kv, group, qt, d).float()
    sc = torch.einsum("bngtd,bnjd->bngtj", qg, k) * (scale * LOG2E)
    valid = _visible(q_lens, kv_lens, qt, k.shape[2], page, ctx_lo,
                     window)                                 # [S,QT,T]
    if kv_range is not None:
        col = torch.arange(k.shape[2], device=q.device)
        valid &= (col >= kv_range[0]) & (col < kv_range[1])
    valid = valid[:, None, None]                             # [S,1,1,QT,T]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp2(sc - torch.where(
        torch.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngtj,bnjd->bngtd", p, v)
    return (acc.reshape(s, n_q, qt, d), m.reshape(s, n_q, qt, 1),
            l.reshape(s, n_q, qt, 1))


def ragged_paged_reference(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                           *, k_scales=None, v_scales=None, scale=None,
                           ctx_lo=None, window=None):
    """Plain version of the kernel: dense-gathers every slot's pages and
    runs the masked softmax with the per-row causal (and window) band.
    Padding rows (t >= q_lens) and idle slots give zeros."""
    acc, _, l = ragged_paged_partials_reference(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales=k_scales,
        v_scales=v_scales, scale=scale, ctx_lo=ctx_lo, window=window)
    return _normalize(acc, l, q.dtype)


def ragged_paged_attention_grouped(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, *,
        group_id, shared_table, shared_lens, k_scales=None, v_scales=None,
        window=None, scale=None):
    """Shared-prefix grouped variant: score each group's shared pages ONCE,
    log-sum-exp merge with every member's private-suffix partial.

    group_id     [S] int32        group index per slot (group rows whose
                                  shared_lens is 0 leave the plain result)
    shared_table [G, n_sh] int32  pool pages of each group's shared prefix
                                  (page-0 padded past its length)
    shared_lens  [G] int32        shared tokens per group, a page multiple

    Every member's shared pages are a prefix of its own page table, and
    causal masking is per query row, so a query inside the shared band
    sees exactly the positions at or below its own.  A window masks both
    bands per row; a shared prefix wholly below a row's band leaves that
    row's shared partial empty (m = -inf, l = 0), which the merge adds as
    nothing.  The private band is
    the kernel with `ctx_lo` at the shared boundary and emit_partials; the
    shared band and the merge are plain torch in the kernel's base-2
    domain, with the -inf guards of the kernel's alpha rule.  Returns
    [S, Nq, QT, D] in q's dtype — equal to the plain launch up to the
    merge's reassociation."""
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    group = n_q // n_kv
    n_sh = shared_table.shape[1]
    if scale is None:
        scale = d**-0.5
    gid = group_id.long()
    lens = shared_lens[gid]
    acc_p, m_p, l_p = ragged_paged_attention(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales=k_scales,
        v_scales=v_scales, window=window, scale=scale,
        ctx_lo=lens.to(torch.int32), emit_partials=True)

    # shared band: ONE pool gather per group, then a view per member; the
    # dequant is a column rescale of the scores and of p, as in the kernel
    quant = k_scales is not None
    table = shared_table.long()

    def flat(pages):  # [G, n_sh, Nkv, page, ...] -> [S, Nkv, n_sh*page, ...]
        t = pages[table].movedim(2, 1)
        return t.reshape(t.shape[0], n_kv, n_sh * page, *t.shape[4:])[gid]

    k_s = flat(k_pages).float()
    v_s = flat(v_pages).float()
    qg = q.reshape(s, n_kv, group, qt, d).float() * (scale * LOG2E)
    sc = torch.einsum("bngtd,bnjd->bngtj", qg, k_s)
    if quant:
        sc = sc * flat(k_scales)[:, :, None, None, :]
    qp = (kv_lens - q_lens).long()[:, None] + torch.arange(
        qt, device=q.device)[None, :]                            # [S, QT]
    col = torch.arange(n_sh * page, device=q.device)
    valid = col[None, None, :] <= qp[:, :, None]
    valid &= col[None, None, :] < lens[:, None, None]
    if window is not None:
        valid &= col[None, None, :] > qp[:, :, None] - window
    valid = valid[:, None, None]
    sc = torch.where(valid, sc, float("-inf"))
    m_s = sc.amax(dim=-1, keepdim=True)                       # [S,Nkv,G,QT,1]
    # a row with no shared column keeps m = -inf; subtract 0 there so no
    # -inf - -inf NaN is ever formed
    p = torch.where(valid, torch.exp2(sc - torch.where(
        torch.isfinite(m_s), m_s, 0.0)), 0.0)
    l_s = p.sum(dim=-1, keepdim=True)
    if quant:
        p = p * flat(v_scales)[:, :, None, None, :]
    acc_s = torch.einsum("bngtj,bnjd->bngtd", p, v_s)
    m_s = m_s.reshape(s, n_q, qt, 1)
    l_s = l_s.reshape(s, n_q, qt, 1)
    acc_s = acc_s.reshape(s, n_q, qt, d)

    # the split-k merge of the kernel's decode splits, private band first
    acc_g, _, l_g = merge_partials(torch.stack([acc_p, acc_s]),
                                   torch.stack([m_p, m_s]),
                                   torch.stack([l_p, l_s]))
    return _normalize(acc_g, l_g, q.dtype)

"""Port parity: burst_attn_tpu_torch.ops.flash backward (plain tile_bwd on
the CPU) against the JAX package's Pallas flash backward kernels in
interpret mode, on the same numpy inputs, f32.  Each JAX route is pinned:
the wrapped-diagonal fused kernel (triangular, group 1), the rectangular
fused kernel (GQA, causal and not), and the split dq + dk/dv pair.
Tolerance rtol = atol = 1e-4, as tests/test_pallas.py::test_bwd_matches_tile
holds the JAX kernels to its tile.

The rectangular fused kernel's dq accumulates in place through output
aliasing, which interpret mode does not model (tests/test_fused_bwd.py runs
it on a TPU only; interpreted, its dq is off by O(1)), so for that route dq
is held to the JAX tile_bwd and dk, dv to the kernel.

The fused kernel's dq fold is also simulated here: its CTAs take their kv
tile from a start-order ticket, so no dispatch order can deadlock the
ordered fold, while tiles taken from block ids can."""

import collections
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu.ops import tile as jtile
from burst_attn_tpu_torch.ops import flash, masks, tile

TOL = dict(rtol=1e-4, atol=1e-4)
D = 32


def _inputs(seed, b, n, n_kv, s_q, s_kv, causal):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, n, s_q, D), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, n_kv, s_kv, D), dtype=np.float32)
            for _ in range(2))
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    jspec = jmasks.MaskSpec(*(jnp.int32(x) for x in spec))
    st = jtile.init_state(b, n, s_q, D)
    m, lse, acc = jtile.tile_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), *st, D**-0.5, jspec)
    o = jtile.finalize(m, lse, acc, jnp.float32)
    delta = np.asarray(jnp.sum(o * do, axis=-1))
    return (do, q, k, v, delta, np.array(lse)), spec, jspec


# (n, n_kv, s_q, s_kv, causal, JAX route kwargs)
CASES = [
    (4, 4, 128, 128, True, dict(triangular=True)),   # _bwd_fused_tri_kernel
    (4, 2, 128, 128, True, dict(fused=True)),        # _bwd_fused_kernel
    (4, 2, 128, 128, False, dict(fused=True)),
    (4, 2, 100, 100, True, dict(fused=False)),       # _dq + _dkdv kernels
    (4, 1, 96, 160, False, dict(fused=False)),
]


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,route", CASES)
def test_flash_bwd_matches_jax_kernels(n, n_kv, s_q, s_kv, causal, route):
    args, spec, jspec = _inputs(0, 1, n, n_kv, s_q, s_kv, causal)
    before = dict(flash.flash_bwd.launches)
    got = flash.flash_bwd(*map(torch.from_numpy, args), D**-0.5, spec,
                          fused=route.get("fused"),
                          triangular=route.get("triangular", False))
    assert flash.flash_bwd.launches == before  # the CPU launches nothing
    want = jflash.flash_bwd(*map(jnp.asarray, args), D**-0.5, jspec,
                            block_q=32, block_kv=32, interpret=True, **route)
    want_tile = jtile.tile_bwd(*map(jnp.asarray, args), D**-0.5, jspec)
    if route.get("fused"):  # interpret mode cannot run this kernel's dq
        want = (want_tile[0], *want[1:])
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    for g, w in zip(tile.tile_bwd(*map(torch.from_numpy, args), D**-0.5,
                                  spec), want_tile):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n_kv,causal", [(4, True), (2, True), (2, False)])
def test_flash_attention_grads_match_jax_vjp(n_kv, causal):
    rng = np.random.default_rng(4)
    q, w = (rng.standard_normal((2, 4, 96, D), dtype=np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((2, n_kv, 96, D), dtype=np.float32)
            for _ in range(2))
    o, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_attention(a, b, c, None, causal,
                                               block_q=32, block_kv=32),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(w))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ot = flash.flash_attention(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(w))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(o),
                               atol=1e-5, rtol=0)
    for g, x, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **TOL)


def test_flash_attention_bf16_grads_keep_input_dtypes():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, D, generator=g).bfloat16()
               .requires_grad_() for _ in range(3))
    flash.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    with torch.no_grad():  # the serving call: forward only
        o = flash.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None and o.dtype == torch.bfloat16


def test_flash_bwd_unported_options_and_bad_shapes_raise():
    x = torch.zeros(1, 2, 8, D)
    lse = torch.zeros(1, 2, 8)
    spec = masks.full_spec(8, 8)
    # a window is ported: on the CPU it is tile_bwd's band
    got = flash.flash_bwd(x + 1, x, x, x, lse, lse, 1.0, spec, window=4)
    want = tile.tile_bwd(x + 1, x, x, x, lse, lse, 1.0, spec, window=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="window"):
        flash.flash_bwd(x, x, x, x, lse, lse, 1.0, spec, window=0)
    # packed segments are ported; the ids must be integers of shape [B, S]
    ids = torch.zeros(1, 8, dtype=torch.int32)
    got = flash.flash_bwd(x + 1, x, x, x, lse, lse, 1.0, spec,
                          segments=(ids, ids))
    want = flash.flash_bwd(x + 1, x, x, x, lse, lse, 1.0, spec)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="integers"):
        flash.flash_bwd(x, x, x, x, lse, lse, 1.0, spec,
                        segments=(lse[:, 0], lse[:, 0]))
    with pytest.raises(ValueError, match="do"):
        flash.flash_bwd(x[:, :1], x, x, x, lse, lse, 1.0, spec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        m = x.to("meta")
        flash.flash_bwd(m, m, m, m, lse.to("meta"), lse.to("meta"), 1.0,
                        spec)


# ---------------------------------------------------------------------------
# the fused kernel's dq fold order (csrc/flash_bwd.cu): a CPU simulation of
# its CTAs under an arbitrary dispatch order, with fewer resident slots
# than CTAs


def _simulate_fused_dq_fold(start_order, resident, nkt, heads, tickets,
                            seed):
    """Run the fused kernel's fold protocol on `heads` heads of `nkt` kv
    tiles (square causal: kv tile j sees q tiles j..nkt-1 and walks them
    from the last down; at q tile i it waits until the tile's counter
    reads j, adds its partial, counts).  CTAs start in `start_order` (block
    ids) as `resident` slots free up and advance in a random interleaving.
    A CTA works on the tile its ticket (the count of CTAs started before
    it) decodes to, kv tile fastest, or, with tickets=False, on the tile
    of its block id.  Returns the folds per (head, q tile) in the order
    they landed, or None on a deadlock (every resident CTA waiting)."""
    rng = random.Random(seed)
    counters = collections.Counter()
    folds = collections.defaultdict(list)
    started = set()
    pending = list(start_order)
    running = []  # [head, kv tile, next q tile]
    while pending or running:
        while len(running) < resident and pending:
            block = pending.pop(0)
            t = len(started) if tickets else block
            head, j = divmod(t, nkt)
            started.add((head, j))
            running.append([head, j, nkt - 1])
        ready = [c for c in running if counters[c[0], c[2]] >= c[1]]
        for head, j, _ in running:
            if tickets and j > 0:  # a wait is on a CTA that has started
                assert (head, j - 1) in started
        if not ready:
            return None
        c = rng.choice(ready)
        head, j, i = c
        folds[head, i].append(j)
        counters[head, i] += 1
        if i == j:
            running.remove(c)
        else:
            c[2] -= 1
    return folds


@pytest.mark.parametrize("nkt,heads", [(4, 3), (7, 2)])
def test_fused_dq_fold_tickets_never_deadlock(nkt, heads):
    n = nkt * heads
    rng = random.Random(nkt)
    for seed in range(60):
        order = list(range(n))
        rng.shuffle(order)
        resident = rng.randint(1, n - 1)
        folds = _simulate_fused_dq_fold(order, resident, nkt, heads, True,
                                        seed)
        assert folds is not None, (order, resident)
        # every q tile received each kv tile's partial once, in increasing
        # kv tile order: the fold order that makes two launches bitwise equal
        assert dict(folds) == {(h, i): list(range(i + 1))
                               for h in range(heads) for i in range(nkt)}


def test_fused_dq_fold_block_ids_can_deadlock():
    """Without tickets, a dispatch order the CUDA model allows (here the
    highest block id first, one resident slot) leaves kv tile j waiting on
    tile j-1, which never gets an SM; random orders hit it too."""
    nkt, heads = 4, 2
    n = nkt * heads
    assert _simulate_fused_dq_fold(list(range(n))[::-1], 1, nkt, heads,
                                   False, 0) is None
    assert _simulate_fused_dq_fold(list(range(n))[::-1], 1, nkt, heads,
                                   True, 0) is not None
    rng = random.Random(1)
    stuck = 0
    for seed in range(40):
        order = list(range(n))
        rng.shuffle(order)
        stuck += _simulate_fused_dq_fold(order, 2, nkt, heads, False,
                                         seed) is None
    assert stuck > 0

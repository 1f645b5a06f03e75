"""Port parity for the ring backward: gradients of the port's `burst_attn`
(the scan ring and the fused ring's plain version) against jax.grad of
the JAX package's scan ring (backend="jnp") on the 8-device CPU mesh of
conftest.py, jitted; the fused backward's plain version against the
port's scan backward; the fused backward kernel's counter protocol under
random interleavings; and the kernel's table columns against the
schedule's.  The JAX package's interpreted fused kernel is not used.

Tolerance: rtol = atol = 2e-4 in fp32, what tests/test_burst.py pins for
the JAX ring's gradients against dense attention (the two rings sum the
same terms in another order)."""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd, masks, tile
from burst_attn_tpu_torch.parallel import burst, mesh, ring, schedule

TOL = dict(rtol=2e-4, atol=2e-4)


def _jmesh(shape):
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devs, tuple(shape))


# -- gradients against the JAX ring ----------------------------------------

GRAD_CASES = [
    # (layout, causal, heads, kv heads, s_kv / s, mesh, options)
    ("zigzag", True, 4, 2, 1, {"sp": 4}, {}),
    ("striped", True, 4, 4, 1, {"sp": 4}, {}),
    ("contig", True, 2, 1, 1, {"sp": 4}, dict(optimize_bwd_comm=False)),
    ("zigzag", False, 4, 2, 1, {"sp": 4}, dict(optimize_bwd_comm=False)),
    ("zigzag", True, 4, 2, 1, {"inter": 2, "intra": 2}, {}),
    ("striped", True, 2, 1, 1, {"inter": 2, "intra": 2},
     dict(optimize_bwd_comm=False)),
    # a truncated contig program: max_segment_len reaches one chunk
    ("contig", True, 2, 2, 1, {"sp": 4}, dict(max_segment_len=16)),
    # cross-attention: the kv shards are twice the q shards
    ("contig", False, 2, 1, 2, {"sp": 4}, {}),
]


@pytest.mark.parametrize("layout,causal,n,n_kv,kv_mul,shape,kw", GRAD_CASES)
def test_ring_gradients_match_jax(layout, causal, n, n_kv, kv_mul, shape,
                                  kw):
    rng = np.random.default_rng(11)
    s, d = 64, 16
    q = rng.standard_normal((1, n, s, d), np.float32)
    k = rng.standard_normal((1, n_kv, kv_mul * s, d), np.float32)
    v = rng.standard_normal((1, n_kv, kv_mul * s, d), np.float32)
    g = rng.standard_normal((1, n, s, d), np.float32)
    seq_axes = tuple(shape)
    jm = _jmesh(shape)
    common = dict(seq_axes=seq_axes, causal=causal, layout=layout, **kw)

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, backend="jnp", batch_axes=None,
                            head_axes=None, **common)
        return jnp.sum(o * g)

    want = [np.asarray(x) for x in jax.jit(jax.grad(
        jloss, argnums=(0, 1, 2)))(q, k, v)]
    before = obs.counter_values()
    for backend in ("jnp", "fused_ring"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = burst_attn(tq, tk, tv, mesh=shape, backend=backend, **common)
        got = torch.autograd.grad((o * torch.from_numpy(g)).sum(),
                                  (tq, tk, tv))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), b, **TOL,
                                       err_msg=f"{backend} {name}")
    moved = obs.counter_deltas(before)
    fused = moved["burst.dispatch{backend=fused_ring,path=fused,"
                  "tile=pallas}"]
    if kv_mul == 1:  # forward and backward through the fused ring
        assert fused == 2, dict(moved)
        assert not any(x.startswith("burst.fused_fallback") for x in moved)
    else:
        assert moved["burst.fused_fallback{pass=bwd,"
                     "reason=cross-attn}"] == 1


def test_backward_counts_and_declines():
    """The backward counts its own dispatch, rounds and hops; a program
    the backward compiler declines (a truncated ring with one live round)
    takes the scan ring under the bwd fallback label, with the same
    gradients."""
    q = torch.randn(1, 2, 32, 16)
    before = obs.counter_values()
    x = q.clone().requires_grad_()
    burst_attn(x, x, x, mesh={"sp": 4}, causal=True).sum().backward()
    rounds, intra, _ = ring.ring_round_counts(1, 4)
    moved = obs.counter_deltas(before)
    assert moved["burst.dispatch{backend=auto,path=scan,"
                 "tile=pallas}"] == 2
    assert moved["burst.ring_rounds"] == 2 * rounds
    assert moved["burst.ring_hops{axis=intra}"] == 2 * intra
    grads = {}
    for backend in ("fused_ring", "jnp"):
        before = obs.counter_values()
        x = q.clone().requires_grad_()
        burst_attn(x, x, x, mesh={"sp": 4}, causal=True, layout="contig",
                   backend=backend, max_segment_len=1).sum().backward()
        grads[backend] = x.grad
        if backend == "fused_ring":
            moved = obs.counter_deltas(before)
            assert moved["burst.fused_fallback{pass=bwd,"
                         "reason=schedule-compiler}"] == 1
            assert moved["burst.dispatch{backend=fused_ring,"
                         "path=fused,tile=pallas}"] == 1
    assert torch.allclose(grads["fused_ring"], grads["jnp"], atol=1e-6)


# -- the fused backward's plain version against the scan backward ----------

FUSED_BWD_PROGRAMS = [
    ("zigzag", True, {"sp": 2}, {}),
    ("zigzag", True, {"sp": 3}, dict(fused_bwd_slots=3)),
    ("striped", True, {"sp": 4}, dict(fused_bwd_slots=3)),
    ("zigzag", True, {"sp": 5}, dict(fused_topology="bidi")),
    ("contig", False, {"sp": 4},
     dict(fused_topology="bidi", fused_bwd_slots=3, fused_bwd_ccw_slots=3)),
    ("zigzag", True, {"inter": 2, "intra": 2}, {}),
    ("striped", True, {"sp": 8}, dict(fused_seq_factor=(2, 4),
                                      fused_bwd_slots=3)),
    ("contig", True, {"sp": 4}, dict(max_segment_len=24)),
]


@pytest.mark.parametrize("layout,causal,shape,kw", FUSED_BWD_PROGRAMS)
def test_fused_bwd_plain_version_matches_the_scan_ring(layout, causal, shape,
                                                      kw):
    """fused_ring_bwd (its plain version on the CPU) against _bwd_impl's
    scan ring on the same residuals, uni, bidi and double, 2 and 3 slots;
    both optimize_bwd_comm payloads."""
    w = int(np.prod(list(shape.values())))
    n_inter = shape.get("inter", 1)
    n_intra = w // n_inter
    g = torch.Generator().manual_seed(w)
    s = 16
    q, do = (torch.randn(w, 1, 4, s, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(w, 1, 2, s, 16, generator=g) for _ in range(2))
    axes = tuple(shape)
    for opt in (True, False):
        cfg = burst.BurstConfig(causal=causal, layout=layout,
                                backend="fused_ring", intra_axis=axes[-1],
                                inter_axis=axes[0] if n_inter > 1 else None,
                                optimize_bwd_comm=opt, **kw)
        assert fused_ring.supported(cfg, q.shape[1:], k.shape[1:],
                                    world=n_intra, n_inter=n_inter,
                                    pass_="bwd") is None
        o, lse = burst._fwd_impl(q, k, v, cfg, n_inter, n_intra)
        got = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg,
                                            n_inter, n_intra)
        scan = burst._bwd_impl(q, k, v, o, lse, do,
                               burst.BurstConfig(**{
                                   **cfg.__dict__, "backend": "jnp"}),
                               n_inter, n_intra)
        for name, a, b in zip(("dq", "dk", "dv"), got, scan):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0,
                                       msg=lambda m: f"{name} opt={opt}: {m}")
        # head chunks of the plain version compute the same
        chunked = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg,
                                                n_inter, n_intra,
                                                head_chunk=2)
        assert all(torch.allclose(a, b, atol=1e-6)
                   for a, b in zip(chunked, got))


def test_plain_version_catches_a_faulty_bwd_program():
    """fused_ring_bwd_reference asserts what the kernel relies on: a dq
    send into the wrong slot, a lost dq take, or a lost dq receive fails
    on the CPU."""
    cfg = burst.BurstConfig(causal=True, layout="zigzag",
                            backend="fused_ring")
    prog, tables, _ = fused_ring.ring_plan(cfg, 1, 4, 8, "bwd")
    x = torch.randn(4, 1, 2, 8, 16)
    lse = torch.zeros(4, 1, 2, 8)
    fused_ring_bwd.fused_ring_bwd_reference(x, x, x, x, lse, x, prog,
                                            list(tables), 0.25)
    table = prog.to_table()
    r_take = int(np.flatnonzero(table[:, schedule.DQ_TAKE0])[0])
    for col, r, val, match in (
            (schedule.DQ_DST_SLOT, 0, 0, "dq"),
            (schedule.DQ_TAKE0, r_take, 0, "without a take"),
            (schedule.DQ_RECV, 1, 0, "DQ_RECV")):
        bad = [t.copy() for t in tables]
        for t in bad:
            t[r, col] = val
        with pytest.raises(AssertionError, match=match):
            fused_ring_bwd.fused_ring_bwd_reference(x, x, x, x, lse, x, prog,
                                                    bad, 0.25)


# -- the kernel's counter protocol, under every interleaving ---------------


def _simulate_bwd_kernel(prog, ktab, seed, ctas=2, tiles=3, wire=False):
    """Run the fused backward kernel's protocol with `ctas` CTAs per
    position, each an independent stream of steps, in a random
    interleaving.  Per round: S, each bundle send (wait the source's
    arrivals and the dst slot's grants, write this CTA's share, count
    it); A, wait the bundle (and the arriving dq partial, or on a seeding
    round the previous round's dq sends), read every share, then fold the
    CTA's contribution into each q tile of the dq slot behind that tile's
    per-round counter, count the round's A; B, once all of the position's
    CTAs counted A (and the dst slot is granted, and the held inter
    partial arrived), send this CTA's share of the tiles (plus the held
    inter partial) to the target and count it, then count the round's B,
    whose last CTA grants the dq credits.  Fails on a deadlock, a consume
    of a wrong or torn bundle, a fold or send that finds a partial of the
    wrong partition or without the contributions it should hold, an
    overwrite before the last read, or a home output missing a
    contribution.  `wire`: the WIRE instances' dq protocol, where each CTA
    first dequantizes its share of an arriving partial's tiles into the
    fold slot and counts the tile's fold counter, so the kv-tile
    contributors fold from count 1 on."""
    world, n_rounds = len(ktab), prog.n_rounds
    fr = fused_ring
    shares, reads = {}, {}
    arrive, free, done_a, done_b, folds = {}, {}, {}, {}, {}
    dq_arrive, dq_free, dq, homes = {}, {}, {}, {}
    mine = lambda p: [(p, i) for i in range(ctas)]  # noqa: E731

    def write_share(p, j, b, s, part):
        key = (p, b, s)
        sh = shares.setdefault(key, [[None, -1] for _ in range(ctas)])
        old = sh[j][1]
        if old >= 0:
            assert reads.get(key + (old,), 0) == ctas or (
                old == 0 and (b, s) in prog.copy_in), \
                "bundle share overwritten before every CTA read it"
        sh[j] = [part, old + 1]
        arrive[key] = arrive.get(key, 0) + 1

    def consume(p, cb, cs, want):
        sh = shares[(p, cb, cs)]
        assert all(x[0] == want for x in sh), "wrong partition consumed"
        assert len({x[1] for x in sh}) == 1, "torn version consumed"
        key = (p, cb, cs, sh[0][1])
        reads[key] = reads.get(key, 0) + 1

    def convert(p, bank, slot, t, want):
        tile = dq.get((p, bank, slot, t))
        assert tile is not None and tile["part"] == want, "wrong dq arrival"
        assert tile["remote"] and not tile["done"], "no dq arrival"
        tile["remote"] = False
        tile["converted"] = True

    def fold(p, j, bank, slot, t, want, recv):
        tile = dq.get((p, bank, slot, t))
        if j == 0 and not recv:
            assert tile is None or tile["done"], "seed over an unsent partial"
            dq[(p, bank, slot, t)] = dict(part=want, contrib=[(p, 0)],
                                          remote=False, done=False)
            return
        assert tile is not None and tile["part"] == want, "wrong dq partial"
        if j == 0 and wire:
            assert tile.get("converted") and not tile["done"], \
                "fold before the arrival's dequantization"
        elif j == 0:
            assert tile["remote"] and not tile["done"], "no dq arrival"
            tile["remote"] = False
        else:
            assert tile["contrib"][-j:] == mine(p)[:j], "fold out of order"
        tile["contrib"] = tile["contrib"] + [(p, j)]

    def send(p, j, r, row, meta, want):
        kind, sbank, dslot, meta_col = fr.dq_send_target(row)
        dst = int(meta[meta_col])
        for t in range(j, tiles, ctas):
            src = dq[(p, row[schedule.DQ_BANK], row[schedule.DQ_SLOT], t)]
            assert src["part"] == want and src["contrib"][-ctas:] == mine(p)
            contrib = list(src["contrib"])
            src["done"] = True
            if row[schedule.DQI_RECV]:
                held = dq[(p, 1, row[schedule.DQI_SLOT], t)]
                assert held["remote"] and not held["done"] \
                    and held["part"] == want, "no inter partial held"
                held["done"] = True
                contrib += held["contrib"]
            if dslot < 0:
                assert (dst, sbank, t) not in homes, "home twice"
                homes[(dst, sbank, t)] = (want, contrib)
                continue
            old = dq.get((dst, sbank, dslot, t))
            assert old is None or old["done"], "dq overwrite before read"
            dq[(dst, sbank, dslot, t)] = dict(part=want, contrib=contrib,
                                              remote=True, done=False)
        if dslot >= 0:
            dq_arrive[(dst, sbank, dslot)] = \
                dq_arrive.get((dst, sbank, dslot), 0) + 1

    def grant(counter, p, banks_cols, row):
        for b, col in enumerate(banks_cols):
            if row[col]:
                key = (p, b, int(row[col]) - 1)
                counter[key] = counter.get(key, 0) + 1

    def steps(p, j):
        for cb, cs in prog.copy_in:
            yield None, lambda cb=cb, cs=cs: write_share(p, j, cb, cs, p)
        for r in range(n_rounds):
            row, meta = ktab[p][r], ktab[p][n_rounds]
            for ch in range(2):
                if not row[fr._SEND[ch]]:
                    continue
                sb = row[schedule.SRC_BANK0] if ch == 0 else 1
                ss = row[fr._SRC_SLOT[ch]]
                dst, ds = meta[fr._META_DST[ch]], row[fr._DST_SLOT[ch]]
                need = row[fr.BWD_SRC_NEED[ch]] * ctas
                take = row[fr.BWD_TAKE_NEED[ch]] if row[fr._TAKE[ch]] else 0
                yield (lambda sb=sb, ss=ss, need=need, key=(dst, ch, ds),
                       take=take: arrive.get((p, sb, ss), 0) >= need
                       and free.get(key, 0) >= take), \
                    (lambda sb=sb, ss=ss, dst=dst, ch=ch, ds=ds: write_share(
                        dst, j, ch, ds, shares[(p, sb, ss)][j][0]))
            cb, cs = row[schedule.CONSUME_BANK], row[schedule.CONSUME_SLOT]
            dqb, dqs = row[schedule.DQ_BANK], row[schedule.DQ_SLOT]
            recv = bool(row[schedule.DQ_RECV])
            ii, si = ring.ring_coords(p, prog.n_inter, prog.n_intra)
            want = schedule.partition_for_round(prog, r, ii, si)
            need = row[fr.BWD_ARRIVE_NEED] * ctas
            dq_need = row[fr.DQ_ARRIVE_NEED] * ctas
            yield (lambda cb=cb, cs=cs, need=need, dqb=dqb, dqs=dqs,
                   dq_need=dq_need, recv=recv, r=r:
                   arrive.get((p, cb, cs), 0) >= need
                   and (dq_arrive.get((p, dqb, dqs), 0) >= dq_need if recv
                        else r == 0 or done_b.get((p, r - 1), 0) >= ctas)), \
                (lambda cb=cb, cs=cs, want=want: consume(p, cb, cs, want))
            shift = int(wire and recv)
            for t in range(j, tiles, ctas) if shift else ():
                key = (p, r, t)
                yield None, (lambda key=key, t=t, dqb=dqb, dqs=dqs, want=want:
                             (convert(p, dqb, dqs, t, want),
                              folds.__setitem__(key, folds.get(key, 0) + 1)))
            for t in reversed(range(tiles)):
                key = (p, r, t)
                yield (lambda key=key, shift=shift:
                       folds.get(key, 0) >= j + shift), \
                    (lambda key=key, t=t, dqb=dqb, dqs=dqs, want=want,
                     recv=recv: (fold(p, j, dqb, dqs, t, want, recv),
                                 folds.__setitem__(key, folds.get(key, 0)
                                                   + 1)))

            def finish_a(r=r, row=row):
                done_a[(p, r)] = done_a.get((p, r), 0) + 1
                if done_a[(p, r)] == ctas:
                    grant(free, p, fr._GRANT, row)

            yield None, finish_a
            kind, sbank, dslot, meta_col = fr.dq_send_target(row)
            dst = meta[meta_col]
            take_col = schedule.DQ_TAKE1 if sbank else schedule.DQ_TAKE0
            take = row[fr.DQ_TAKE_NEED] if dslot >= 0 and row[take_col] \
                else 0
            dqi_need = row[fr.DQI_ARRIVE_NEED] * ctas
            yield (lambda r=r, key=(dst, sbank, dslot), take=take,
                   dqi=(p, 1, row[schedule.DQI_SLOT]), dqi_need=dqi_need,
                   has_dqi=bool(row[schedule.DQI_RECV]):
                   done_a.get((p, r), 0) >= ctas
                   and dq_free.get(key, 0) >= take
                   and (not has_dqi or dq_arrive.get(dqi, 0) >= dqi_need)), \
                (lambda r=r, row=row, meta=meta, want=want: send(
                    p, j, r, row, meta, want))

            def finish_b(r=r, row=row):
                done_b[(p, r)] = done_b.get((p, r), 0) + 1
                if done_b[(p, r)] == ctas:
                    grant(dq_free, p, (schedule.DQ_GRANT0,
                                       schedule.DQ_GRANT1), row)

            yield None, finish_b

    rng = random.Random(seed)
    gens = [steps(p, j) for p in range(world) for j in range(ctas)]
    pending = [next(g, None) for g in gens]
    while any(x is not None for x in pending):
        ready = [i for i, x in enumerate(pending)
                 if x is not None and (x[0] is None or x[0]())]
        assert ready, "deadlock"
        i = rng.choice(ready)
        pending[i][1]()
        pending[i] = next(gens[i], None)
    n_homes = len(fused_ring_bwd.bwd_statics(prog))
    for p in range(world):
        for t in range(tiles):
            got = [homes[(p, b, t)] for b in range(2) if (p, b, t) in homes]
            assert len(got) == n_homes, "a home output never arrived"
            assert all(part == p for part, _ in got), "home of a wrong part"
            contrib = [c for _, cs in got for c in cs]
            assert len(contrib) == len(set(contrib)) == n_rounds * ctas
            assert len({c[0] for c in contrib}) == n_rounds


BWD_PROGRAMS = [("uni", 1, w) for w in (2, 3, 4)] + \
    [("bidi", 1, w) for w in (3, 5)] + \
    [("double", 2, 2), ("double", 2, 3), ("double", 3, 1)]


def _bwd_tables(prog):
    cfg = burst.BurstConfig(causal=True, layout="zigzag")
    return [fused_ring.kernel_table_bwd(
        prog, fused_ring.build_sched_table(cfg, prog, 8, 8, p,
                                           swap_roles=True)[0])
            for p in range(prog.world)]


@pytest.mark.parametrize("topology,n_inter,n_intra", BWD_PROGRAMS)
def test_bwd_kernel_protocol_delivers_under_any_interleaving(
        topology, n_inter, n_intra):
    for slots in (2, 3):
        prog = schedule.compile_bwd(topology, n_intra, n_inter, slots=slots,
                                    slots1=slots)
        ktab = _bwd_tables(prog)
        for seed in range(8):
            _simulate_bwd_kernel(prog, ktab, seed)
    if topology == "uni" and n_intra > 2:  # the truncated programs
        for r_live in range(2, n_intra):
            prog = schedule.compile_bwd("uni", n_intra, r_live=r_live)
            ktab = _bwd_tables(prog)
            for seed in range(8):
                _simulate_bwd_kernel(prog, ktab, seed)


@pytest.mark.parametrize("topology,n_inter,n_intra", [
    ("uni", 1, 4), ("bidi", 1, 3), ("double", 2, 2)])
def test_bwd_wire_protocol_delivers_under_any_interleaving(
        topology, n_inter, n_intra):
    """The WIRE instances' dq protocol (an arrival dequantized as fold
    contributor 0 by each CTA's share) delivers under random
    interleavings, the truncated uni programs included."""
    progs = [schedule.compile_bwd(topology, n_intra, n_inter, slots=2,
                                  slots1=2)]
    if topology == "uni":
        progs += [schedule.compile_bwd("uni", n_intra, r_live=r)
                  for r in range(2, n_intra)]
    for prog in progs:
        ktab = _bwd_tables(prog)
        for seed in range(4):
            _simulate_bwd_kernel(prog, ktab, seed, ctas=3, tiles=4,
                                 wire=True)


def test_bwd_protocol_simulation_catches_a_mutated_program():
    """A dq send that lost its credit take overwrites a partial before its
    owner sent it on, in some interleaving; a dq send into the wrong slot
    starves its receiver."""
    prog = schedule.compile_bwd("uni", 4, slots=2)
    ktab = _bwd_tables(prog)
    r_take = int(np.flatnonzero(prog.to_table()[:, schedule.DQ_TAKE0])[0])
    no_take = [t.copy() for t in ktab]
    for t in no_take:
        t[r_take, schedule.DQ_TAKE0] = 0
        t[r_take, fused_ring.DQ_TAKE_NEED] = 0
    with pytest.raises(AssertionError, match="overwrite before read"):
        for seed in range(200):
            _simulate_bwd_kernel(prog, no_take, seed)
    wrong = [t.copy() for t in ktab]
    for t in wrong:
        t[0, schedule.DQ_DST_SLOT] = 0
    with pytest.raises(AssertionError):
        _simulate_bwd_kernel(prog, wrong, 0)


# -- the tensor-core tile's rounding ---------------------------------------

BWD_RTOL, BWD_ATOL = 1e-4, 1e-6  # chip_smoke.py's kernel-9 tolerance


def _bf16_terms(x, terms):
    """x as the tile feeds it to a bf16 product: one rounding, or two bf16
    terms (the rounded value, then its rounded residual: split_bf16)."""
    hi = x.bfloat16().float()
    return [hi] if terms == 1 else [hi, (x - hi).bfloat16().float()]


@pytest.mark.parametrize("terms", [2, 1])
def test_two_bf16_terms_keep_the_fp32_tolerance(terms):
    """Kernel 9's bf16 tile (csrc/mma_bwd_tile.cuh) computes P and dS in
    fp32 and feeds them to the dV, dK and dQ products as bf16 terms with
    fp32 accumulation; Q, K, V and dO are bf16 and exact.  Emulated in
    plain torch on the CPU (N2 S256 D128, causal), two terms keep dq, dk,
    dv within BWD_RTOL of their largest entry + BWD_ATOL of the fp32
    backward from the same bf16 inputs (the tolerance that holds the
    kernel to its plain version on the card); one rounding does not."""
    rng = np.random.default_rng(8)
    n, s, d = 2, 256, 128
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, n, s, d), np.float32)).bfloat16().float()
        for _ in range(4))
    scale = d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.einsum("bnid,bnjd->bnij", q, k) * scale
    sc = sc.masked_fill(~causal, float("-inf"))
    lse = torch.logsumexp(sc, -1)
    o = torch.einsum("bnij,bnjd->bnid", torch.exp(sc - lse[..., None]), v)
    delta = (o.bfloat16().float() * do).sum(-1)
    spec = masks.round_spec(0, 0, s, s, True, "contig")
    want = tile.tile_bwd(do, q, k, v, delta, lse, scale, spec)

    p = torch.exp(sc - lse[..., None])  # 0 where masked
    dp = torch.einsum("bnid,bnjd->bnij", do, v)
    ds = p * (dp - delta[..., None])
    dv = sum(torch.einsum("bnij,bnid->bnjd", t, do)
             for t in _bf16_terms(p, terms))
    dk = sum(torch.einsum("bnij,bnid->bnjd", t, q)
             for t in _bf16_terms(ds, terms)) * scale
    dq = sum(torch.einsum("bnij,bnjd->bnid", t, k)
             for t in _bf16_terms(ds, terms)) * scale
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip((dq, dk, dv), want)]
    held = all(float((a - b).abs().max()) <= BWD_RTOL * float(b.abs().max())
               + BWD_ATOL for a, b in zip((dq, dk, dv), want))
    print(f"{terms} bf16 term(s): dq, dk, dv off by {errs} of their "
          f"largest entry")
    assert held == (terms == 2), errs


# -- the kernel reads the schedule's columns -------------------------------


def test_bwd_kernel_reads_the_table_columns_of_the_schedule():
    """csrc/fused_ring_bwd.cu hard-codes the backward op table's columns;
    they must be parallel/schedule.py's and ops/fused_ring.py's."""
    src = (Path(fused_ring.__file__).parent.parent / "csrc"
           / "fused_ring_bwd.cu").read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"\b(k[A-Z]\w*) = (\d+)", src)}
    want = dict(
        kConsumeBank=schedule.CONSUME_BANK,
        kConsumeSlot=schedule.CONSUME_SLOT, kSrcBank0=schedule.SRC_BANK0,
        kDqBank=schedule.DQ_BANK, kDqRecv=schedule.DQ_RECV,
        kDqSlot=schedule.DQ_SLOT, kDqSend=schedule.DQ_SEND,
        kDqDstSlot=schedule.DQ_DST_SLOT, kDqiRecv=schedule.DQI_RECV,
        kDqiSlot=schedule.DQI_SLOT, kDqiDstSlot=schedule.DQI_DST_SLOT,
        kArriveNeed=fused_ring.BWD_ARRIVE_NEED,
        kDqArriveNeed=fused_ring.DQ_ARRIVE_NEED,
        kDqiArriveNeed=fused_ring.DQI_ARRIVE_NEED,
        kDqTakeNeed=fused_ring.DQ_TAKE_NEED, kPart=fused_ring.BWD_PART,
        kMetaCh1Dst=schedule.META_CH1_DST, kMetaHome0=schedule.META_HOME0,
        kMetaHome1=schedule.META_HOME1, kDqRing=schedule.DQ_RING,
        kDqHome=schedule.DQ_HOME, kDqBoundary=schedule.DQ_BOUNDARY,
        kDqFinal=schedule.DQ_FINAL, kNPtr=fused_ring_bwd._N_PTRS)
    assert {k: consts[k] for k in want} == want
    per = {name: (int(c0), int(c1)) for name, c1, c0 in re.findall(
        r"int (\w+)\(int (?:ch|b)\) \{ return (?:ch|b) \? (\d+) : (\d+); \}",
        src)}
    assert per == dict(
        col_send=(schedule.SEND0, schedule.SEND1),
        col_src_slot=(schedule.SRC_SLOT0, schedule.SRC_SLOT1),
        col_dst_slot=(schedule.DST_SLOT0, schedule.DST_SLOT1),
        col_grant=(schedule.GRANT0, schedule.GRANT1),
        col_take=(schedule.TAKE0, schedule.TAKE1),
        col_src_need=fused_ring.BWD_SRC_NEED,
        col_take_need=fused_ring.BWD_TAKE_NEED,
        meta_dst=(schedule.META_CH0_DST, schedule.META_CH1_DST),
        col_dq_grant=(schedule.DQ_GRANT0, schedule.DQ_GRANT1),
        col_dq_take=(schedule.DQ_TAKE0, schedule.DQ_TAKE1))
    assert fused_ring.BWD_PART == fused_ring.DQ_TAKE_NEED + 1
    assert fused_ring.BWD_KERNEL_COLS == fused_ring.BWD_PART + 1
    assert "const Mask mk{row[0], row[1], row[2], row[3], row[4], S, S};" \
        in src


def test_stacked_shards_and_ring_rotation_keep_the_grad_path():
    """burst_attn's autograd path takes the global tensors' shards and
    returns gradients on the global tensors in their dtypes."""
    q = torch.randn(1, 2, 32, 16, dtype=torch.float64).float()
    x = q.clone().requires_grad_()
    burst_attn(x, x, x, mesh={"sp": 2}, causal=True).sum().backward()
    assert x.grad.shape == q.shape and x.grad.dtype == q.dtype
    assert torch.isfinite(x.grad).all()
    assert torch.equal(mesh.unshard(mesh.shard(q, 2)), q)

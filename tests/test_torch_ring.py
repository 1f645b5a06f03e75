"""Port parity for the ring forward: the port's mask specs, schedule
programs, op tables and `burst_attn` (the scan ring and the fused ring's
plain version) against the JAX package's, on the CPU.  The JAX side runs
its scan ring (backend="jnp") on the 8-device CPU mesh of conftest.py,
jitted; its interpreted fused kernel is not used."""

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
from burst_attn_tpu.ops import fused_ring as jfr
from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.parallel import burst as jburst
from burst_attn_tpu.parallel import schedule as jsched
from burst_attn_tpu.utils.compat import shard_map
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.ops import fused_ring, masks
from burst_attn_tpu_torch.ops.tile import single_device_attention
from burst_attn_tpu_torch.parallel import burst, mesh, ring, schedule

ATOL = 1e-5  # fp32; the two rings sum in another order
# fp32 ring gradients: the tolerance the reference pins for them
# (tests/test_burst.py); a ring folds dq over its rounds, one position in
# one sum, so seeds exist whose entries differ by more than ATOL
GRAD_ATOL = 2e-4


def _jmesh(shape):
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devs, tuple(shape))


# -- masks -----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contig", "zigzag", "striped"])
def test_mask_specs_match_jax(layout):
    s, world = 16, 4
    for causal in (True, False):
        for qp in range(world):
            for kp in range(world):
                got = masks.round_spec(qp, kp, s, s, causal, layout)
                want = jmasks.round_spec(jnp.int32(qp), jnp.int32(kp), s, s,
                                         causal, layout)
                assert tuple(got) == tuple(int(x) for x in want)
                assert masks.spec_live(got) == bool(jmasks.spec_live(want))
                assert masks.spec_pair_count(got, s, s) == int(
                    jmasks.spec_pair_count(want, s, s))
                assert masks.spec_pair_count(got, s, s) == int(
                    masks.dense_mask(got, s, s).sum())
                assert masks._host_round_pairs(layout, qp, kp, s, causal) \
                    == jmasks._host_round_pairs(layout, qp, kp, s, causal)
        for msl in (None, 1, 17, 40):
            kw = dict(causal=causal, max_segment_len=msl)
            assert masks.live_delta_table(layout, s, world, **kw) == \
                jmasks.live_delta_table(layout, s, world, **kw)
            assert masks.live_round_prefix(layout, s, world, **kw) == \
                jmasks.live_round_prefix(layout, s, world, **kw)


# -- schedule programs and op tables ---------------------------------------

PROGRAMS = [("uni", 1, w) for w in (2, 3, 4, 8)] + \
    [("bidi", 1, w) for w in (3, 5, 8)] + \
    [("double", 2, 2), ("double", 2, 4), ("double", 4, 2)]


@pytest.mark.parametrize("topology,n_inter,n_intra", PROGRAMS)
def test_compiled_programs_match_jax(topology, n_inter, n_intra):
    for slots in (2, 3):
        for compile_ in ("compile_fwd", "compile_bwd"):
            got = getattr(schedule, compile_)(topology, n_intra, n_inter,
                                              slots=slots)
            want = getattr(jsched, compile_)(topology, n_intra, n_inter,
                                             slots=slots)
            np.testing.assert_array_equal(got.to_table(), want.to_table())
            for f in ("slots", "channels", "copy_in", "rot_inter",
                      "rot_intra", "dq_slots", "home_offsets"):
                assert getattr(got, f) == getattr(want, f), f
            assert schedule.hop_totals(got) == jsched.hop_totals(want)
    if topology == "uni":
        for r_live in range(1, n_intra + 1):
            got = schedule.compile_fwd("uni", n_intra, r_live=r_live)
            want = jsched.compile_fwd("uni", n_intra, r_live=r_live)
            np.testing.assert_array_equal(got.to_table(), want.to_table())
    assert ring.ring_round_counts(n_inter, n_intra) == \
        __import__("burst_attn_tpu.parallel.ring",
                   fromlist=["x"]).ring_round_counts(n_inter, n_intra)


def _jax_tables(jcfg, prog, s, jm, axes):
    spec = jax.sharding.PartitionSpec(axes)

    def per_device(x):
        t, _ = jfr.build_sched_table(jcfg, prog, s, s)
        return t[None]

    world = int(np.prod([jm.shape[a] for a in axes]))
    f = jax.jit(shard_map(per_device, mesh=jm, in_specs=spec,
                          out_specs=spec, check_vma=False))
    return np.asarray(f(jnp.zeros(world)))


@pytest.mark.parametrize("layout,topo,shape,kw", [
    ("zigzag", "uni", {"sp": 4}, {}),
    ("striped", "bidi", {"sp": 5}, dict(fused_topology="bidi")),
    ("contig", "double", {"inter": 2, "intra": 2}, {}),
    ("zigzag", "double", {"sp": 8}, dict(fused_seq_factor=(2, 4))),
])
def test_sched_tables_match_jax(layout, topo, shape, kw):
    s = 32
    axes = tuple(shape)
    inter = axes[0] if len(axes) == 2 else None
    common = dict(causal=True, layout=layout, intra_axis=axes[-1],
                  inter_axis=inter, backend="fused_ring",
                  mesh_axes=tuple(shape.items()), **kw)
    cfg = burst.BurstConfig(**common)
    jcfg = jburst.BurstConfig(**common)
    n_inter = shape[inter] if inter else 1
    n_intra = shape[axes[-1]]
    topology, t_inter, t_intra = fused_ring.resolve_topology(cfg, n_intra,
                                                             n_inter)
    assert (topology, t_inter, t_intra) == jfr.resolve_topology(
        jcfg, n_intra, n_inter)
    assert topology == topo
    prog = fused_ring._compile_for(cfg, topology, t_inter, t_intra, s=s)
    jprog = jfr._compile_for(jcfg, topology, t_inter, t_intra, s=s)
    want = _jax_tables(jcfg, jprog, s, _jmesh(shape), axes)
    for p in range(n_inter * n_intra):
        got, _ = fused_ring.build_sched_table(cfg, prog, s, s, p)
        np.testing.assert_array_equal(got, want[p])
    assert fused_ring.kernel_statics(prog) == jfr.kernel_statics(jprog)


# -- the kernel's need columns, under every interleaving -------------------


def test_kernel_reads_the_table_columns_of_the_schedule():
    """csrc/fused_ring_fwd.cu hard-codes the op table's columns; they
    must be parallel/schedule.py's and ops/fused_ring.py's, since a drift
    would show only on the card (as a wrong mask, a deadlock or a trap)."""
    src = (Path(fused_ring.__file__).parent.parent / "csrc"
           / "fused_ring_fwd.cu").read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"\b(k[A-Z]\w*) = (\d+)", src)}
    assert {k: consts[k] for k in ("kConsumeBank", "kConsumeSlot",
                                   "kSrcBank0", "kArriveNeed",
                                   "kPart")} == dict(
        kConsumeBank=schedule.CONSUME_BANK, kConsumeSlot=schedule.CONSUME_SLOT,
        kSrcBank0=schedule.SRC_BANK0, kArriveNeed=fused_ring.ARRIVE_NEED,
        kPart=fused_ring.PART)
    per_ch = {name: (int(c0), int(c1)) for name, c1, c0 in re.findall(
        r"int (\w+)\(int ch\) \{ return ch \? (\d+) : (\d+); \}", src)}
    assert per_ch == dict(
        col_send=(schedule.SEND0, schedule.SEND1),
        col_src_slot=(schedule.SRC_SLOT0, schedule.SRC_SLOT1),
        col_dst_slot=(schedule.DST_SLOT0, schedule.DST_SLOT1),
        col_grant=(schedule.GRANT0, schedule.GRANT1),
        col_take=(schedule.TAKE0, schedule.TAKE1),
        col_src_need=fused_ring.SRC_NEED,
        col_take_need=fused_ring.TAKE_NEED,
        meta_dst=(schedule.META_CH0_DST, schedule.META_CH1_DST))
    # the five mask scalars lead each row (row[0] .. row[4]); both tiles
    # pass them: the SEG, the WIRE and the other instances
    assert schedule.SPEC0 == 0 and schedule.CONSUME_BANK == 5
    assert len(re.findall(r"row\[0\],\s*row\[1\],\s*row\[2\],\s*row\[3\],"
                          r"\s*row\[4\],", src)) == 6
    # the consumed partition (packed segments) is the last column
    assert fused_ring.PART == max(fused_ring.TAKE_NEED) + 1
    assert fused_ring.KERNEL_COLS == fused_ring.PART + 1


def _simulate_kernel(prog, tables, seed, ctas=2, items=0, wait=True):
    """Run the fused kernel's protocol with `ctas` CTAs per position, each
    an independent stream of steps, in a random interleaving: the copy-in
    share; per round each send (wait the source's arrivals, wait the dst
    slot's grants, write this CTA's share, count it), the consume (wait
    the arrivals, read every share), the round's `items` q tiles, then the
    round's done count, whose last CTA grants.  Items: with no more items
    than CTAs (RESIDENT) CTA j folds item j every round; else each CTA
    takes the round's items in increasing order from the position's
    per-round counter, one take a step, and folds each as two steps (read
    the state, then write it and count the item's version); a round r > 0
    fold waits until the item's version reads r (`wait=False` drops that
    wait: the mutated protocol).  Fails on a deadlock, a consume that finds
    any share of a wrong partition, a share overwritten before every CTA
    of the receiver read its version, a fold that reads an item's state
    before its previous round's fold wrote it, or an item not folded
    exactly once a round."""
    world, n_rounds = len(tables), prog.n_rounds
    ktab = [fused_ring.kernel_table(prog, t) for t in tables]
    shares = {}   # (pos, bank, slot) -> per share [partition, version]
    reads = {}    # (pos, bank, slot, version) -> consumes by the CTAs
    arrive, free, done = {}, {}, {}
    resident = items <= ctas
    taken, version, folded, reading = {}, {}, {}, {}

    def deal(p, j, r):
        """The CTA's items of round r: the steps that take and fold them."""
        cell = {}
        while True:
            if resident:
                it = j if not cell else items
                cell["it"] = it
            else:
                yield None, lambda: cell.__setitem__("it", take(p, r))
            it = cell["it"]
            if it >= items:
                return
            gate = (None if resident or r == 0 or not wait else
                    (lambda it=it: version.get((p, it), 0) >= r))
            yield gate, lambda it=it: fold_read(p, r, it)
            yield None, lambda it=it: fold_write(p, r, it)

    def take(p, r):
        it = taken.get((p, r), 0)
        taken[(p, r)] = it + 1
        return min(it, items)

    def fold_read(p, r, it):
        assert folded.get((p, it), 0) == r, \
            "item state read before its previous round's fold wrote it"
        reading[(p, it)] = r

    def fold_write(p, r, it):
        assert reading.pop((p, it)) == r
        folded[(p, it)] = r + 1
        version[(p, it)] = r + 1

    def steps(p, j):
        for cb, cs in prog.copy_in:
            yield None, lambda cb=cb, cs=cs: write(p, j, cb, cs, p)
        for r in range(n_rounds):
            row, meta = ktab[p][r], ktab[p][n_rounds]
            for ch in range(2):
                if not row[fused_ring._SEND[ch]]:
                    continue
                sb = row[schedule.SRC_BANK0] if ch == 0 else 1
                ss = row[fused_ring._SRC_SLOT[ch]]
                dst = meta[fused_ring._META_DST[ch]]
                ds = row[fused_ring._DST_SLOT[ch]]
                need = row[fused_ring.SRC_NEED[ch]] * ctas
                take = row[fused_ring.TAKE_NEED[ch]] \
                    if row[fused_ring._TAKE[ch]] else 0
                yield (lambda sb=sb, ss=ss, need=need, key=(dst, ch, ds),
                       take=take: arrive.get((p, sb, ss), 0) >= need
                       and free.get(key, 0) >= take), \
                    (lambda sb=sb, ss=ss, dst=dst, ch=ch, ds=ds: write(
                        dst, j, ch, ds, shares[(p, sb, ss)][j][0]))
            cb, cs = row[schedule.CONSUME_BANK], row[schedule.CONSUME_SLOT]
            ii, si = ring.ring_coords(p, prog.n_inter, prog.n_intra)
            want = schedule.partition_for_round(prog, r, ii, si)
            need = row[fused_ring.ARRIVE_NEED] * ctas
            yield (lambda cb=cb, cs=cs, need=need:
                   arrive.get((p, cb, cs), 0) >= need), \
                (lambda cb=cb, cs=cs, want=want: consume(p, cb, cs, want))
            if items:
                yield from deal(p, j, r)
            yield None, lambda r=r, row=row: finish(p, r, row)

    def write(p, j, b, s, part):
        key = (p, b, s)
        sh = shares.setdefault(key, [[None, -1] for _ in range(ctas)])
        old = sh[j][1]
        if old >= 0:
            assert reads.get(key + (old,), 0) == ctas or (
                old == 0 and (b, s) in prog.copy_in), \
                "share overwritten before every CTA read it"
        sh[j] = [part, sh[j][1] + 1]
        arrive[key] = arrive.get(key, 0) + 1

    def consume(p, cb, cs, want):
        sh = shares[(p, cb, cs)]
        assert all(x[0] == want for x in sh), "wrong partition consumed"
        assert len({x[1] for x in sh}) == 1, "torn version consumed"
        key = (p, cb, cs, sh[0][1])
        reads[key] = reads.get(key, 0) + 1

    def finish(p, r, row):
        done[(p, r)] = done.get((p, r), 0) + 1
        if done[(p, r)] == ctas:
            for b in range(prog.n_banks):
                g = row[fused_ring._GRANT[b]]
                if g:
                    free[(p, b, g - 1)] = free.get((p, b, g - 1), 0) + 1

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
    if items:
        assert folded == {(p, it): n_rounds for p in range(world)
                          for it in range(items)}, "an item not folded " \
            "exactly once a round"


@pytest.mark.parametrize("topology,n_inter,n_intra", PROGRAMS)
def test_kernel_protocol_delivers_under_any_interleaving(topology, n_inter,
                                                         n_intra):
    for slots in (2, 3):
        cfg = burst.BurstConfig(causal=True, layout="zigzag",
                                fused_kv_slots=slots, fused_ccw_slots=slots)
        prog = schedule.compile_fwd(topology, n_intra, n_inter, slots=slots,
                                    slots1=slots)
        tables = [fused_ring.build_sched_table(cfg, prog, 8, 8, p)[0]
                  for p in range(n_inter * n_intra)]
        for seed in range(20):
            _simulate_kernel(prog, tables, seed)


@pytest.mark.parametrize("topology,n_inter,n_intra", PROGRAMS)
def test_kernel_counter_deal_folds_each_item_once_a_round(topology, n_inter,
                                                          n_intra):
    """Kernel 8's items through the protocol: RESIDENT (2 items, 3 CTAs) and
    dealt from the per-(position, round) counter (7 items, 3 CTAs), in
    random interleavings: every item folded once a round, never before its
    previous round's fold wrote its state."""
    cfg = burst.BurstConfig(causal=True, layout="zigzag")
    prog = schedule.compile_fwd(topology, n_intra, n_inter, slots=2,
                                slots1=2)
    tables = [fused_ring.build_sched_table(cfg, prog, 8, 8, p)[0]
              for p in range(n_inter * n_intra)]
    for items in (2, 7):
        for seed in range(6):
            _simulate_kernel(prog, tables, seed, ctas=3, items=items)


def test_counter_deal_simulation_catches_a_missing_version_wait():
    """Without the wait on the item's version, a CTA that left round r can
    take item x of round r + 1 while another CTA still folds x in round
    r: some interleaving reads the state before it is written."""
    cfg = burst.BurstConfig(causal=True, layout="zigzag")
    prog = schedule.compile_fwd("uni", 4, slots=2)
    tables = [fused_ring.build_sched_table(cfg, prog, 8, 8, p)[0]
              for p in range(4)]
    for seed in range(20):  # the protocol as built holds
        _simulate_kernel(prog, tables, seed, ctas=3, items=7)
    with pytest.raises(AssertionError, match="before its previous round"):
        for seed in range(200):
            _simulate_kernel(prog, tables, seed, ctas=3, items=7,
                             wait=False)


def test_plain_version_catches_a_faulty_program():
    """fused_ring_reference asserts what the kernel relies on: a table
    whose send lost its credit take, or whose send targets the wrong
    slot, fails on the CPU."""
    cfg = burst.BurstConfig(causal=True, layout="zigzag")
    prog = schedule.compile_fwd("uni", 4, slots=2)
    tables = [fused_ring.build_sched_table(cfg, prog, 8, 8, p)[0]
              for p in range(4)]
    x = torch.randn(4, 1, 2, 8, 16)
    fused_ring.fused_ring_reference(x, x, x, prog, tables, 0.25)
    r_take = int(np.flatnonzero(prog.to_table()[:, schedule.TAKE0])[0])
    no_take = [t.copy() for t in tables]
    for t in no_take:
        t[r_take, schedule.TAKE0] = 0
    with pytest.raises(AssertionError, match="without a take"):
        fused_ring.fused_ring_reference(x, x, x, prog, no_take, 0.25)
    wrong_slot = [t.copy() for t in tables]
    for t in wrong_slot:
        t[0, schedule.DST_SLOT0] = 0
    with pytest.raises(AssertionError):
        fused_ring.fused_ring_reference(x, x, x, prog, wrong_slot, 0.25)


# -- burst_attn against the JAX scan ring ----------------------------------

CASES = [
    # (layout, causal, heads, kv heads, mesh, fused knobs)
    ("zigzag", True, 4, 2, {"sp": 4}, {}),
    ("striped", True, 4, 2, {"sp": 4}, dict(fused_kv_slots=3)),
    ("contig", True, 4, 1, {"sp": 4}, {}),
    ("zigzag", False, 4, 4, {"sp": 4}, dict(fused_topology="bidi")),
    ("zigzag", True, 4, 2, {"inter": 2, "intra": 2}, {}),
]


@pytest.mark.parametrize("layout,causal,n,n_kv,shape,kw", CASES)
def test_burst_attn_matches_jax(layout, causal, n, n_kv, shape, kw):
    rng = np.random.default_rng(3)
    s, d = 64, 32
    q = rng.standard_normal((2, n, s, d), np.float32)
    k = rng.standard_normal((2, n_kv, s, d), np.float32)
    v = rng.standard_normal((2, n_kv, s, d), np.float32)
    seq_axes = tuple(shape)
    jm = _jmesh(shape)
    want = np.asarray(jax.jit(lambda q, k, v: jbat.burst_attn(
        q, k, v, mesh=jm, seq_axes=seq_axes, causal=causal, layout=layout,
        backend="jnp", batch_axes=None, head_axes=None))(q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = obs.counter_values()
    for backend in ("jnp", "auto", "fused_ring"):
        got = burst_attn(tq, tk, tv, mesh=shape, seq_axes=seq_axes,
                         causal=causal, layout=layout, backend=backend,
                         **(kw if backend == "fused_ring" else {}))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=backend)
    moved = obs.counter_deltas(before)
    assert moved["burst.dispatch{backend=fused_ring,path=fused,"
                 "tile=pallas}"] == 1
    assert not any(k.startswith("burst.fused_fallback") for k in moved)
    rounds, intra, inter = ring.ring_round_counts(
        shape.get("inter", 1), shape[seq_axes[-1]])
    assert moved["burst.ring_rounds"] == 3 * rounds
    assert moved["burst.ring_hops{axis=intra}"] == 3 * intra


def test_contig_ring_skips_dead_rounds_and_truncates():
    """A contig causal scan ring launches no tile for a future round, and
    max_segment_len truncates it to the live prefix (whose pairs it keeps
    exactly when no segment is longer: here the bound covers a chunk)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 2, 64, 16), np.float32))
    ref = burst_attn(q, q, q, mesh={"sp": 4}, causal=True, layout="contig",
                     backend="jnp")
    calls = []
    orig = burst.flash_fwd
    burst.flash_fwd = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        got = burst_attn(q, q, q, mesh={"sp": 4}, causal=True,
                         layout="contig", backend="auto")
    finally:
        burst.flash_fwd = orig
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    assert len(calls) == 4 + 3 + 2 + 1  # position p has p + 1 live rounds
    before = obs.counter_values()
    burst_attn(q, q, q, mesh={"sp": 4}, causal=True, layout="contig",
               backend="fused_ring", max_segment_len=2)
    assert obs.counter_deltas(before)["burst.ring_rounds"] == 2


def test_burst_attn_declines_and_rejects():
    # a generator of its own: drawn from the global one, the inputs (and
    # the gradient check's fp32 rounding) depended on the test files that
    # ran before in the same worker
    q = torch.randn(1, 2, 32, 16, generator=torch.Generator().manual_seed(0))
    before = obs.counter_values()
    # one position: nothing to rotate, the fused config takes the scan ring
    got = burst_attn(q, q, q, mesh={"sp": 1}, causal=True, layout="zigzag",
                     backend="fused_ring")
    want = burst_attn(q, q, q, mesh={"sp": 1}, causal=True,
                      layout="zigzag", backend="jnp")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert obs.counter_deltas(before)[
        "burst.fused_fallback{pass=fwd,reason=world-lt-2}"] == 1
    # cross-attention lengths: the scan ring, non-causal only
    kx = torch.randn(1, 2, 64, 16)
    burst_attn(q, kx, kx, mesh={"sp": 2}, layout="contig",
               backend="fused_ring")
    assert obs.counter_deltas(before)[
        "burst.fused_fallback{pass=fwd,reason=cross-attn}"] == 1
    with pytest.raises(ValueError, match="cross-attention"):
        burst_attn(q, kx, kx, mesh={"sp": 2}, causal=True, layout="contig")
    # under grad the ring backward runs: a contig ring's gradient is
    # one-position attention's
    x = q.clone().requires_grad_()
    burst_attn(x, x, x, mesh={"sp": 2}, causal=True,
               layout="contig").sum().backward()
    y = q.clone().requires_grad_()
    burst_attn(y, y, y, mesh={"sp": 1}, causal=True,
               layout="contig").sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                               atol=GRAD_ATOL, rtol=0)
    with torch.no_grad():  # no grad asked for: the forward alone runs
        burst_attn(q.clone().requires_grad_(), q, q, mesh={"sp": 2})
    # a window runs on the contig ring: one position's banded attention
    got = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig",
                     window=8)
    want = single_device_attention(q, q, q, causal=True, window=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    # int8 / fp8 ring payloads are ported (tests/test_torch_wire.py): an
    # int8 ring stays within its quantization tolerance of the dense one;
    # a wire dtype the quantizer lacks is refused
    dense = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig")
    wired = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig",
                       wire_dtype="int8")
    assert float((wired - dense).abs().max()) < 0.04
    with pytest.raises(ValueError, match="wire_dtype"):
        burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig",
                   wire_dtype="int4")
    # packed segments are ported: one segment is the unsegmented ring; a
    # cross-attention ring takes none
    one = torch.zeros(1, 32, dtype=torch.int32)
    assert torch.equal(
        burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig",
                   segment_ids=one),
        burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig"))
    with pytest.raises(ValueError, match="cross-attention"):
        burst_attn(q, kx, kx, mesh={"sp": 2}, layout="contig",
                   segment_ids=one)
    # ring telemetry is ported: (o, DevStats), o the plain call's
    o, st = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, layout="contig",
                       collect_stats=True)
    assert torch.equal(o, burst_attn(q, q, q, mesh={"sp": 2}, causal=True,
                                     layout="contig"))
    assert st.rounds.tolist() == [2, 2]
    # the tp groups' rings run in the one launch over all heads; an axis
    # that is neither the ring's nor a named batch / head axis is refused
    assert torch.equal(
        burst_attn(q, q, q, mesh={"sp": 2, "tp": 2}, head_axes="tp"),
        burst_attn(q, q, q, mesh={"sp": 2}))
    with pytest.raises(ValueError, match="neither"):
        burst_attn(q, q, q, mesh={"sp": 2, "tp": 2})
    with pytest.raises(ValueError, match="backend"):
        burst_attn(q, q, q, mesh={"sp": 2}, backend="xla")


@pytest.mark.parametrize("kw", [
    dict(block_q=64), dict(block_kv=64), dict(block_q_bwd=64),
    dict(block_kv_bwd=64), dict(fused_block_q_bwd=64),
    dict(fused_block_kv_bwd=64),
])
def test_unhonoured_options_raise(kw):
    """An option the port does not honour (the flash kernels' fixed tile
    sizes) raises on a value other than its default instead of being
    ignored; its default runs."""
    q = torch.randn(1, 2, 32, 16)
    (name, _), = kw.items()
    with pytest.raises(NotImplementedError, match=name):
        burst_attn(q, q, q, mesh={"sp": 2}, causal=True, **kw)
    default = burst.BurstConfig.__dataclass_fields__[name].default
    burst_attn(q, q, q, mesh={"sp": 2}, causal=True, **{name: default})


@pytest.mark.parametrize("kw", [
    dict(optimize_bwd_comm=False), dict(fused_bwd_slots=3),
    dict(fused_bwd_ccw_slots=3, fused_topology="bidi"),
])
def test_backward_options_are_honoured(kw):
    """The ring backward's options: the other payload, more slots for
    the fused backward's bundle (and its ccw bank) give the gradients of
    the defaults, through the fused backward's program with those
    slots."""
    (name, value), = list(kw.items())[:1]
    q = torch.randn(1, 2, 48, 16)
    grads = []
    for opts in ({}, kw):
        x = q.clone().requires_grad_()
        burst_attn(x, x, x, mesh={"sp": 3}, causal=True,
                   backend="fused_ring", **opts).sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               atol=ATOL, rtol=0)
    cfg = burst.BurstConfig(causal=True, backend="fused_ring", **kw)
    prog = fused_ring.ring_plan(cfg, 1, 3, 16, "bwd")[0]
    if name == "fused_bwd_slots":
        assert prog.slots == (3,)
    if name == "fused_bwd_ccw_slots":
        assert prog.topology == "bidi" and prog.slots[1] == 2  # 1 ccw hop
    assert getattr(cfg, name) == value


def test_reference_entry_points_check_their_options():
    """burst_attn_func(_striped) accept deterministic=False as the JAX
    package does (both backward routes are deterministic: the gradients
    are the same); case_split takes both values, which compute the same
    rounds here."""
    q = torch.randn(1, 2, 32, 16)
    for f in (burst.burst_attn_func, burst.burst_attn_func_striped):
        grads = []
        for det in (True, False):
            x = q.clone().requires_grad_()
            f(x, x, x, causal=True, deterministic=det,
              mesh={"sp": 2}).sum().backward()
            grads.append(x.grad)
        assert torch.equal(grads[0], grads[1])
    split = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, case_split=True)
    whole = burst_attn(q, q, q, mesh={"sp": 2}, causal=True, case_split=False)
    assert torch.equal(split, whole)


def test_ring_rotation_copies():
    """mesh.ppermute moves each payload to its ring neighbour as a copy
    (the traffic a ring has to move is moved), along either axis of a
    double ring."""
    parts = [(torch.full((2,), float(p)),) for p in range(6)]
    intra = mesh.ppermute(parts, "intra", 2, 3)
    assert [int(t[0][0]) for t in intra] == [2, 0, 1, 5, 3, 4]
    inter = mesh.ppermute(parts, "inter", 2, 3)
    assert [int(t[0][0]) for t in inter] == [3, 4, 5, 0, 1, 2]
    assert all(a[0].data_ptr() != b[0].data_ptr()
               for a, b in zip(intra, parts))
    sched = ring.ring_schedule(3, 2)
    jring = __import__("burst_attn_tpu.parallel.ring", fromlist=["x"])
    np.testing.assert_array_equal(sched, jring.ring_schedule(3, 2))
    np.testing.assert_array_equal(ring.fused_slot_schedule(8, 3),
                                  jring.fused_slot_schedule(8, 3))

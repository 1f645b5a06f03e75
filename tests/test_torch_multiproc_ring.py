"""Port parity for rings and Ulysses whose sequence axis spans processes
(parallel/mesh.py's process-major layout, parallel/burst.py's scan ring
across processes, parallel/ulysses.py's all-to-all across processes):
two gloo processes spawned on the CPU (tests/torch_multiproc_workers.py)
against the JAX package on the 8-device CPU mesh of conftest.py and
against the port's own one-process run on the same inputs.

  * burst_attn forward and backward on a single ring over "sp": sp=4
    split between the two processes (positions 0-1 in rank 0, 2-3 in
    rank 1) and sp=2 one position a process, causal zigzag, contig and
    striped, a window (the truncated contig ring), packed documents and
    int8 payloads, fp32: JAX's burst_attn at ATOL 1e-5 / GRAD_ATOL 2e-4
    (tests/test_torch_ring.py's; the int8 wire against the one-process
    run alone), the port's one-process run bit for bit,
    the same collectives recorded, the fused backend declined and counted
    (spans-processes), every hop across the processes counted;
  * ulysses_attn on "sp" split 2 + 2 (N 8, Nkv 4) and one a process, a
    packed row of documents in one case: JAX's ulysses_attn at FWD 1e-4 /
    GRAD 2e-4 (tests/test_torch_ulysses.py's), the one-process run bit
    for bit, the same all-to-alls recorded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_multiproc_workers as W
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu.parallel.ulysses import ulysses_attn as j_ulysses
from burst_attn_tpu_torch import burst_attn
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.parallel.ulysses import ulysses_attn

ATOL = 1e-5  # tests/test_torch_ring.py: fp32 forward
GRAD_ATOL = 2e-4  # tests/test_torch_ring.py: fp32 ring gradients
FWD_TOL, GRAD_TOL = 1e-4, 2e-4  # tests/test_torch_ulysses.py

# packed documents of the ring cases' sequence: three, in layout order
SEG = np.repeat(np.arange(3, dtype=np.int32), [100, 90, 66])[None]
# (dcn, ici, layout, burst_attn options): sp=4 split 2 + 2, sp=2 one
# position a process; a window (the contig ring truncated to r_live 2 of
# 4: the backward's payload jumps 3 positions, across the processes),
# packed documents, int8 ring payloads
RING_CASES = [({"sp": 4}, {}, "zigzag", {}), ({"sp": 4}, {}, "contig", {}),
              ({"sp": 2}, {}, "zigzag", {}), ({"sp": 2}, {}, "striped", {}),
              ({"sp": 4}, {}, "contig", {"window": 24}),
              ({"sp": 4}, {}, "zigzag", {"seg": SEG}),
              ({"sp": 4}, {}, "zigzag", {"wire_dtype": "int8"})]
# (dcn, ici, packed): Ulysses over sp split 2 + 2 and one a process
ULY_CASES = [({"sp": 4}, {}, False), ({"sp": 2}, {}, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, as the children run (the same GEMM blocking
    on both sides)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every RING_CASES case's two processes, spawned once."""
    q, k, v, g = _inputs((1, 4, 256, 32), 21)
    rdzv = tmp_path_factory.mktemp("ring") / "rdzv"
    res = W.spawn(W.ring_cases, 2, (q, k, v, g, RING_CASES),
                  init_method=f"file://{rdzv}", timeout_s=240)
    return (q, k, v, g), res


@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=["sp4-split-zigzag", "sp4-split-contig",
                              "sp2-zigzag", "sp2-striped", "sp4-window",
                              "sp4-segments", "sp4-wire-int8"])
def test_single_ring_across_processes(ring_runs, case):
    """The two processes' parts, joined, equal JAX's ring (but for the
    int8 wire, held to the one-process run alone) and the port's
    one-process ring (bitwise); each process recorded the one-process
    collectives; the fused backend declined both passes, counted under
    spans-processes; the forward's hops, the backward's payload hops and
    its dq hops (and the return home) crossed the processes (a window's
    truncated ring the live rounds' only)."""
    (q, k, v, g), res = ring_runs
    dcn, ici, layout, kw = RING_CASES[case]
    kw = dict(kw)
    seg = kw.pop("seg", None)
    shape = dict(dcn, **ici)
    w = shape["sp"]
    got = {n: np.concatenate([r[case][n] for r in res], axis=2)
           for n in ("o", "dq", "dk", "dv")}
    jm = JMesh(np.asarray(jax.devices()[:w]), ("sp",))

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, backend="jnp", batch_axes=None,
                            head_axes=None, seq_axes=("sp",), causal=True,
                            layout=layout, segment_ids=None if seg is None
                            else jnp.asarray(seg), **kw)
        return jnp.sum(o * g), o

    if "wire_dtype" not in kw:
        (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
        np.testing.assert_allclose(got["o"], np.asarray(jo), atol=ATOL,
                                   rtol=0)
        for name, want in zip(("dq", "dk", "dv"), jg):
            np.testing.assert_allclose(got[name], np.asarray(want),
                                       atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                       err_msg=name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with pmesh.record_collectives() as ev:
        o = burst_attn(tq, tk, tv, mesh=shape, seq_axes=("sp",),
                       causal=True, layout=layout, backend="auto",
                       segment_ids=None if seg is None
                       else torch.from_numpy(seg), **kw)
        (o * torch.from_numpy(g)).sum().backward()
    for name, want in (("o", o), ("dq", tq.grad), ("dk", tk.grad),
                       ("dv", tv.grad)):
        np.testing.assert_array_equal(got[name], want.detach().numpy(),
                                      err_msg=name)
    # a dense ring, contig causal too: (W-1) forward hops, (W-1) payload
    # and (W-1) dq hops backward, then dq's return home; the window's
    # r_live 2: one forward hop, the payload's jump, a dq hop and home
    hops = 4 if "window" in kw else 3 * (w - 1) + 1
    for r in res:
        assert r[case]["events"] == list(ev)
        assert r[case]["stats"]["hops"] == hops, r[case]["stats"]
        assert r[case]["fallback"] == {
            "burst.fused_fallback{pass=fwd,reason=spans-processes}": 1,
            "burst.fused_fallback{pass=bwd,reason=spans-processes}": 1}


def _ids(s):
    """A packed row of three documents."""
    cut = [s // 2 - 10, s // 4 + 6]
    return np.repeat(np.arange(3, dtype=np.int32),
                     cut + [s - sum(cut)])[None]


@pytest.fixture(scope="module")
def ulysses_runs(tmp_path_factory):
    """Every ULY_CASES case's two processes, one spawn a case."""
    q, k, v, g = _inputs((1, 8, 128, 16), 5)
    k, v = k[:, :4], v[:, :4]
    out = []
    for dcn, ici, packed in ULY_CASES:
        rdzv = tmp_path_factory.mktemp("uly") / "rdzv"
        out.append(W.spawn(W.ulysses_op, 2, (q, k, v, g, _ids(128) if packed
                                             else None, dcn, ici),
                           init_method=f"file://{rdzv}", timeout_s=240))
    return (q, k, v, g), out


@pytest.mark.parametrize("case", range(len(ULY_CASES)),
                         ids=["sp4-split", "sp2-packed"])
def test_ulysses_across_processes(ulysses_runs, case):
    """Ulysses over a sequence axis across the processes: the parts,
    joined, equal JAX's ulysses_attn and the one-process run (bitwise),
    with the one-process all-to-alls recorded; the packed row's ids reach
    every position whole."""
    (q, k, v, g), runs = ulysses_runs
    res = runs[case]
    dcn, ici, packed = ULY_CASES[case]
    w = dict(dcn, **ici)["sp"]
    ids = _ids(q.shape[2]) if packed else None
    got = {n: np.concatenate([r[n] for r in res], axis=2)
           for n in ("o", "dq", "dk", "dv")}
    jm = JMesh(np.asarray(jax.devices()[:w]), ("sp",))
    kw = {} if ids is None else {"segment_ids": jnp.asarray(ids)}

    def jloss(q, k, v):
        o = j_ulysses(q, k, v, mesh=jm, backend="jnp", causal=True, **kw)
        return jnp.sum(o * g), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    np.testing.assert_allclose(got["o"], np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for name, want in zip(("dq", "dk", "dv"), jg):
        np.testing.assert_allclose(got[name], np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with pmesh.record_collectives() as ev:
        o = ulysses_attn(tq, tk, tv, mesh={"sp": w}, causal=True,
                         backend="auto", segment_ids=None if ids is None
                         else torch.from_numpy(ids))
        (o * torch.from_numpy(g)).sum().backward()
    for name, want in (("o", o), ("dq", tq.grad), ("dk", tk.grad),
                       ("dv", tv.grad)):
        np.testing.assert_array_equal(got[name], want.detach().numpy(),
                                      err_msg=name)
    for r in res:
        assert r["events"] == list(ev)
        # q, k, v there and o back (the backward's exchanges are not
        # recorded, as in one process), every one across the processes
        assert r["stats"]["hops"] == 4 + 4, r["stats"]

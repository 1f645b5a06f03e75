"""The port's multi-process runtime (utils/multihost.py) and host
helpers (parallel/collectives.py `synchronize`, `gather_obj`) against
the JAX package's (burst_attn_tpu/utils/multihost.py,
parallel/collectives.py): in one process the JAX tests' cases
(tests/test_utils.py, tests/test_collectives.py), the cluster-environment
signals held to JAX's `_cluster_env` on the same environments, and the
process axes a mesh may and may not have; then two spawned gloo
processes: gather_obj in rank order, the barrier, a mesh whose dcn axes
do not hold the run's processes, and the four collectives over a process
axis against their one-process results."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_multiproc_workers as W

from burst_attn_tpu.parallel import collectives as JC
from burst_attn_tpu.utils import multihost as jmultihost
from burst_attn_tpu_torch.parallel import collectives as C
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.utils import multihost

_SIGNALS = ("MEGASCALE_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
            "JAX_COORDINATOR_ADDRESS", "JOBSET_NAME",
            "TPU_WORKER_HOSTNAMES", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS",
            "SLURM_NPROCS", "WORLD_SIZE")


@pytest.fixture
def no_cluster(monkeypatch):
    for v in _SIGNALS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,port_only", [
    ({}, False),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234"}, False),
    ({"JOBSET_NAME": "job"}, False),
    ({"TPU_WORKER_HOSTNAMES": "localhost"}, False),
    ({"TPU_WORKER_HOSTNAMES": "a,b"}, False),
    ({"SLURM_NTASKS": "1"}, False),
    ({"SLURM_NTASKS": "4"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "x"}, False),
    ({"WORLD_SIZE": "1"}, False),
    ({"WORLD_SIZE": "2"}, True),  # torchrun's signal: the port's own
])
def test_cluster_env_matches_jax(no_cluster, env, port_only):
    for k, v in env.items():
        no_cluster.setenv(k, v)
    want = jmultihost._cluster_env()
    if port_only:
        assert not want and multihost._cluster_env()
    else:
        assert multihost._cluster_env() == want


def test_initialize_single_process_noop(no_cluster, tmp_path):
    """tests/test_utils.py: initialize() does nothing in one process
    without a cluster environment; a second initialize while a group is
    up is benign; wrong explicit arguments raise; nccl raises naming
    ROADMAP A7b and starts nothing."""
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert jax.process_count() == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        multihost.initialize(backend="nccl")
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        multihost.initialize(f"file://{tmp_path / 'r0'}", 1, 0,
                             backend="nccl")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        multihost.initialize(f"file://{tmp_path / 'r1'}")  # no count
    with pytest.raises(ValueError):
        multihost.initialize(f"file://{tmp_path / 'r2'}", 2, 2)
    with pytest.raises(ValueError):
        multihost.initialize(num_processes=2, process_id=0)
    # a cluster environment whose rendezvous cannot work raises
    no_cluster.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        multihost.initialize()
    no_cluster.delenv("WORLD_SIZE")
    multihost.initialize(f"file://{tmp_path / 'r3'}", 1, 0)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        multihost.initialize()  # double initialize: benign
        multihost.initialize(f"file://{tmp_path / 'r4'}", 1, 0)
        assert multihost.process_count() == 1
        assert multihost.process_path("x/obs.jsonl") == "x/obs.jsonl"
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_make_hybrid_mesh_single_host():
    """tests/test_utils.py's mesh: in one process the dcn axes are
    positions too, named and sized as JAX's mesh."""
    want = jmultihost.make_hybrid_mesh(ici={"intra": 4}, dcn={"inter": 2})
    m = multihost.make_hybrid_mesh(ici={"intra": 4}, dcn={"inter": 2},
                                   device="cpu")
    assert tuple(m.shape) == want.axis_names == ("inter", "intra")
    assert m.shape == dict(want.shape) == {"inter": 2, "intra": 4}
    assert m.process_axes == () and m.ring_procs(("inter", "intra")) is None
    with pytest.raises(ValueError, match="both"):
        multihost.make_hybrid_mesh(ici={"sp": 2}, dcn={"sp": 2},
                                   device="cpu")


def test_synchronize_and_gather_obj_single_process():
    """tests/test_collectives.py's host helpers."""
    JC.synchronize()
    C.synchronize()
    assert C.gather_obj({"a": 1}) == JC.gather_obj({"a": 1}) == [{"a": 1}]


@pytest.mark.parametrize("shape,n,want", [
    ({"dp": 2, "sp": 2}, 2, ("dp",)),
    ({"inter": 2, "intra": 4}, 2, ("inter",)),
    ({"dp": 2, "inter": 2, "intra": 2}, 4, ("dp", "inter")),
    ({"dp": 2, "sp": 2}, 1, ()),
    ({"tp": 2, "sp": 2}, 2, ("tp",)),
    ({"sp": 4}, 2, ("sp",)),  # split 2 + 2
    ({"dp": 4, "sp": 2}, 2, ("dp",)),  # dp split 2 + 2
    ({"dp": 2, "sp": 2}, 3, ValueError),  # 4 positions, 3 processes
    ({"a": 3, "b": 2}, 2, ValueError),  # 3 positions a process: no grid
    ({"dp": 2, "inter": 2, "intra": 4}, 4, ("dp", "inter")),
    ({"inter": 2, "intra": 4}, 4, ("inter", "intra")),  # intra split
])
def test_process_axes_for(shape, n, want):
    """The axes that span n processes in JAX's process-major order (the
    leading ones one index a process, at most one split between
    processes), and the positions each rank then holds: the flat
    [r N/n, (r+1) N/n) of the mesh's row-major order, enumerated from the
    layout's sub-grid; a mesh whose positions do not divide between the
    processes, or do not form a sub-grid, raises ValueError."""
    if not isinstance(want, tuple):
        with pytest.raises(want, match="processes"):
            pmesh.process_axes_for(shape, n)
        return
    assert pmesh.process_axes_for(shape, n) == want
    total = int(np.prod(list(shape.values())))
    for r in range(n):
        assert pmesh.layout_positions(shape, n, r) == list(
            range(r * total // n, (r + 1) * total // n))


@pytest.mark.parametrize("shape,axes", [
    ({"tp": 2, "sp": 2}, ("tp",)),
    ({"pp": 2, "sp": 2}, ("pp",)),
    ({"ep": 2, "sp": 2}, ("ep",)),
    ({"sp": 2, "dp": 2}, ("sp",)),  # sp outermost: it spans the two
])
def test_gated_process_axes_raise(shape, axes):
    """tp, pp, ep or any outermost axis spans the processes now (they
    raised NotImplementedError before any axis but dp and inter could):
    over two processes each rank holds one index of the leading axis and
    every position of the other; a process_axes request other than the
    layout's is a ValueError, made before any process group is needed."""
    assert pmesh.process_layout(shape, 2) == {axes[0]: 1}
    assert [pmesh.layout_positions(shape, 2, r) for r in range(2)] == [
        [0, 1], [2, 3]]
    other = tuple(a for a in shape if a not in axes)
    with pytest.raises(ValueError, match="process-major"):
        pmesh.Mesh(shape, device="cpu", process_axes=other)


def test_two_processes(tmp_path):
    """gather_obj is rank-ordered and the barrier passes in two gloo
    processes; a mesh whose positions do not divide between the
    processes raises ValueError naming their count; each process sits at
    its rank's dp index, and holds the layout's positions of the meshes
    of LAYOUTS (a split axis, tp or sp outermost);
    all_reduce (sum, mean, max), broadcast, all_gather and reduce_scatter
    over dp across the processes equal the one-process collectives on the
    two parts (bf16 sums in bf16), recorded as the one-process ones."""
    res = W.spawn(W.host_helpers, 2,
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=120)
    for r, got in enumerate(res):
        assert got["gather"] == [{"rank": 0, "sq": 0}, {"rank": 1, "sq": 1}]
        assert "2 processes" in got["mismatch"]
        assert got["coords"] == ({"dp": r}, [0, 1])
        for shape, (axes, held) in zip(W.LAYOUTS, got["layouts"]):
            assert axes == pmesh.process_axes_for(shape, 2)
            assert held == pmesh.layout_positions(shape, 2, r)
    parts = [torch.from_numpy(got["part"]) for got in res]
    with pmesh.record_collectives() as ev:
        want = {
            "all_reduce": pmesh.all_reduce(parts, "sum", "dp"),
            "mean": pmesh.all_reduce(parts, "mean", "dp"),
            "max": pmesh.all_reduce(parts, "max", "dp"),
            "broadcast": pmesh.broadcast(parts, 1, "dp"),
            "all_gather": pmesh.all_gather(parts, 1, "dp"),
            "reduce_scatter": pmesh.reduce_scatter(parts, 1, "dp"),
            "bf16": pmesh.all_reduce([p.bfloat16() for p in parts], "sum",
                                     "dp")}
    for r, got in enumerate(res):
        for name, outs in want.items():
            np.testing.assert_array_equal(got[name], outs[r].float().numpy(),
                                          err_msg=name)
        assert got["events"] == list(ev)
        assert got["stats"]["gathers"] == len(want)


def test_checkpoint_outwaits_a_slow_primary_write(tmp_path):
    """Checkpointer.save in two gloo processes whose group waits end after
    2 s, the primary's write taking 4 s: the other process waits it out
    on the checkpoint's own group (write_timeout_s) instead of failing at
    the run's group timeout, then both read the same checkpoint back."""
    res = W.spawn(W.slow_checkpoint, 2, (str(tmp_path / "ckpt"), 2.0, 4.0),
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=120)
    assert res[1]["waited"] >= 4.0, res[1]["waited"]
    for got in res:
        assert got["steps"] == [1] and got["step"] == 1
        for a, b in zip(got["params"], got["want"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("failing_rank, timeout_s, error, match", [
    (1, 120.0, Exception, "rank 1 fails"),  # the child's traceback
    (None, 8.0, TimeoutError, "not done within"),  # children running
])
def test_spawn_fails_on_a_failed_or_late_child(tmp_path, failing_rank,
                                                timeout_s, error, match):
    """The tests' and chip_smoke.py's spawn: a child that raises fails the
    call with its traceback, its sibling stopped; children still running
    at the timeout are stopped and fail it with TimeoutError."""
    with pytest.raises(error, match=match):
        W.spawn(W.fail_or_sleep, 2, (failing_rank, 60.0),
                init_method=f"file://{tmp_path / 'rdzv'}",
                timeout_s=timeout_s)

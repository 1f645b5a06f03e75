"""The process bodies of the port's multi-process tests
(tests/test_torch_multihost.py, test_torch_multiproc.py and the card's
test_torch_cuda.py), and `spawn`, which runs one in every rank of a gloo
group (chip_smoke.py starts its two processes with it too).  This module
imports torch and the port only, so that a spawned child starts without
JAX; results go back as numpy arrays and Python values."""

import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as tmp

from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, Shards, params_from_jax, tree_leaves,
)
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.parallel.collectives import gather_obj, synchronize
from burst_attn_tpu_torch.utils import multihost


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a tcp:// rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, fn, nprocs, init_method, args, out_dir):
    """One spawned process: join the group, run fn, leave the group, then
    pickle fn's result to out_dir/<rank>.pkl."""
    multihost.initialize(init_method, nprocs, rank)
    try:
        out = fn(*args)
    finally:
        multihost.shutdown()
    path = os.path.join(out_dir, f"{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def spawn(fn, nprocs, args=(), *, init_method, timeout_s=300.0,
          out_dir=None):
    """fn(*args) in `nprocs` fresh processes (torch.multiprocessing's
    spawn start method: CUDA cannot fork), each in the gloo group of
    `init_method` (a file:// or tcp:// rendezvous) as its rank; returns
    their results in rank order, passed back through pickle files under
    `out_dir` (default: a temporary directory).  fn must be importable by
    name and its result picklable by value (numpy arrays, numbers: not
    tensors).  A child that raises or dies fails the call with its
    traceback, the others stopped (start_processes' join); one still
    running after `timeout_s` is stopped and fails it with TimeoutError."""
    with tempfile.TemporaryDirectory(dir=out_dir) as res_dir:
        ctx = tmp.start_processes(
            _child, (fn, nprocs, init_method, tuple(args), res_dir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} processes not done "
                                       f"within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(nprocs):
            with open(os.path.join(res_dir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# the narrow train steps of test_torch_multiproc.py (tests/
# test_torch_ep_train.py's model)
DIMS = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
DP_SP = {"dp": 2, "sp": 2}
INTER_INTRA = {"inter": 2, "intra": 2}


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host (bf16 widened to fp32: exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# meshes laid over two processes (test_torch_multihost.py): an axis split
# 2 + 2, tp outermost, sp outermost before a local dp
LAYOUTS = ({"sp": 4}, {"dp": 4, "sp": 2}, {"tp": 2, "sp": 2},
           {"sp": 2, "dp": 2})


def _held(mesh):
    """(the process axes of `mesh`, the flat positions this process holds:
    each axis's local_start / local_size, in row-major order)."""
    import itertools

    ranges = [range(mesh.local_start(a),
                    mesh.local_start(a) + mesh.local_size(a))
              for a in mesh.shape]
    return mesh.process_axes, [
        int(np.ravel_multi_index(c, tuple(mesh.shape.values())))
        for c in itertools.product(*ranges)]


def host_helpers():
    """gather_obj rank-ordered, the barrier, a mismatched dcn product and
    the four collectives over a process axis (dp across the processes,
    sp local) against their one-process results on the gathered parts."""
    torch.set_num_threads(1)
    rank = multihost.process_index()
    got = {"gather": gather_obj({"rank": rank, "sq": rank * rank})}
    synchronize()
    try:  # 3 positions do not divide between the 2 processes
        multihost.make_hybrid_mesh(ici={"sp": 1}, dcn={"dp": 3},
                                   device="cpu")
    except ValueError as e:
        got["mismatch"] = str(e)
    m = pmesh.Mesh({"dp": 2, "sp": 2}, device="cpu", process_axes=("dp",))
    got["coords"] = (m.process_coords, m.axis_ranks("dp"))
    got["layouts"] = [_held(pmesh.Mesh(shape, device="cpu",
                                       process_axes="auto"))
                      for shape in LAYOUTS]
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) * (rank + 1) + 0.1
    with pmesh.record_collectives() as ev:
        got["all_reduce"] = _np(pmesh.all_reduce([x], "sum", "dp", mesh=m)[0])
        got["mean"] = _np(pmesh.all_reduce([x], "mean", "dp", mesh=m)[0])
        got["max"] = _np(pmesh.all_reduce([x], "max", "dp", mesh=m)[0])
        got["broadcast"] = _np(pmesh.broadcast([x], 1, "dp", mesh=m)[0])
        got["all_gather"] = _np(pmesh.all_gather([x], 1, "dp", mesh=m)[0])
        got["reduce_scatter"] = _np(pmesh.reduce_scatter([x], 1, "dp",
                                                         mesh=m)[0])
        got["bf16"] = _np(pmesh.all_reduce([x.bfloat16()], "sum", "dp",
                                           mesh=m)[0])
    got["events"] = list(ev)
    got["part"] = _np(x)
    got["stats"] = dict(m.transport.stats)
    return got


def ring_slice(mesh, seq_axes, s: int) -> slice:
    """This process's part of a layout-order sequence of length s on the
    ring over `seq_axes` of `mesh` (its ring positions' shards)."""
    procs = mesh.ring_procs(seq_axes)
    if procs is None:
        return slice(0, s)
    w = len(procs.owners)
    return slice(procs.pos[0] * s // w, (procs.pos[-1] + 1) * s // w)


def ring_op(q, k, v, g, device="cpu", backend="jnp", dtype="float32",
            calls=1, dcn=None, ici=None, seq_axes=("inter", "intra"),
            layout="zigzag", seg=None, **kw):
    """burst_attn forward and backward on the mesh of `dcn` x `ici`
    (default: the double ring inter=2, the processes, x intra=2, local),
    causal, on this process's part of the layout-order sequence (and of
    the packed-document ids `seg` [B, S], if given; `kw`: more burst_attn
    options, a window, a wire dtype): (o, dq, dk, dv) of the part, the
    collectives recorded in the last call, the transport's counters and
    the fused-fallback deltas.  `calls` repeats the call (the staging
    buffers' reuse)."""
    from burst_attn_tpu_torch import burst_attn, obs
    from burst_attn_tpu_torch.ops import flash

    torch.set_num_threads(1)
    dt = getattr(torch, dtype)
    m = multihost.make_hybrid_mesh(
        ici={"intra": 2} if ici is None else ici,
        dcn={"inter": 2} if dcn is None else dcn, device=device)
    sl = ring_slice(m, seq_axes, q.shape[2])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, :, sl])).to(
            device=device, dtype=dt)

    allocs = []
    before = obs.counter_values()
    launches0 = flash.flash_fwd.launches
    for _ in range(calls):
        tq, tk, tv = (put(x).requires_grad_() for x in (q, k, v))
        with pmesh.record_collectives() as ev:
            o = burst_attn(tq, tk, tv, mesh=m, seq_axes=seq_axes,
                           causal=True, layout=layout, backend=backend,
                           segment_ids=None if seg is None else
                           torch.from_numpy(seg[:, sl]), **kw)
            (o.float() * put(g).float()).sum().backward()
        allocs.append(m.transport.stats["allocs"])
    if device != "cpu":
        torch.cuda.synchronize()
    moved = obs.counter_deltas(before)
    return dict(o=_np(o), dq=_np(tq.grad), dk=_np(tk.grad),
                dv=_np(tv.grad), events=list(ev),
                stats=dict(m.transport.stats), allocs=allocs,
                fallback={k_: v_ for k_, v_ in moved.items()
                          if k_.startswith("burst.fused_fallback")},
                flash_fwd_launches=flash.flash_fwd.launches - launches0)


def ring_cases(q, k, v, g, cases):
    """ring_op of each (dcn, ici, layout, kw) of `cases` (a single ring
    over "sp", the fused backend: declined across processes) in turn, in
    the same processes."""
    return [ring_op(q, k, v, g, "cpu", "fused_ring", dcn=dcn, ici=ici,
                    seq_axes=("sp",), layout=layout, **kw)
            for dcn, ici, layout, kw in cases]


def ulysses_op(q, k, v, g, seg, dcn, ici):
    """ulysses_attn (causal, the flash path's plain version) forward and
    backward over "sp" of the mesh dcn x ici, on this process's part of
    the natural-order sequence, packed documents `seg` ([B, S] or None):
    (o, dq, dk, dv) of the part, the collectives recorded, the
    transport's counters."""
    from burst_attn_tpu_torch.parallel.ulysses import ulysses_attn

    torch.set_num_threads(1)
    m = multihost.make_hybrid_mesh(ici=ici, dcn=dcn, device="cpu")
    n, s = m.shape["sp"], q.shape[2]
    lo = m.local_start("sp")
    sl = slice(lo * s // n, (lo + m.local_size("sp")) * s // n)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x[:, :, sl]))
                  .requires_grad_() for x in (q, k, v))
    with pmesh.record_collectives() as ev:
        o = ulysses_attn(tq, tk, tv, mesh=m, seq_axis="sp", causal=True,
                         backend="auto", segment_ids=None if seg is None
                         else torch.from_numpy(seg[:, sl]))
        (o * torch.from_numpy(np.ascontiguousarray(g[:, :, sl]))
         ).sum().backward()
    return dict(o=_np(o), dq=_np(tq.grad), dk=_np(tk.grad), dv=_np(tv.grad),
                events=list(ev), stats=dict(m.transport.stats))


def _cfg(sizes, dtype=torch.float32, dims=None, **kw):
    """The narrow model on mesh `sizes`: the double ring when it has an
    "inter" axis, dp and tp when it has them; `kw` configures it
    further."""
    return ModelConfig(**{**dict(dims or DIMS), **dict(
        dtype=dtype, remat=False,
        seq_axes=("inter", "intra") if "inter" in sizes else ("sp",),
        batch_axis="dp" if "dp" in sizes else None,
        head_axis="tp" if "tp" in sizes else None), **kw})


def whole_grads(params):
    """Every tree leaf's gradient (a split leaf's joined, its shards in
    other processes gathered: every process calls it), as numpy."""
    out = []
    for x in tree_leaves(params):
        if not isinstance(x, Shards):
            out.append(_np(x.grad))
            continue
        parts = [t.grad for t in x.parts]
        if x.total > len(parts):
            parts = pmesh._gathered(parts, x.axis, x.mesh)[0]
        out.append(_np(torch.cat(parts, dim=x.dim)))
    return out


def train_steps(tree, tok, sizes=DP_SP, across=("dp",), device="cpu",
                dtype="float32", steps=1, dims=None, model=None):
    """`steps` train steps of the `dims` model (default DIMS) on mesh
    `sizes` from the numpy `tree` (None: init_params seed 0) at lr 0
    without clipping.  `across`: "auto" or the mesh's axes that span the
    processes (each process takes its rows of `tok` [B, S + 1] by
    train.data_shard and, on a sequence axis across them, its part of
    the sequence); () runs every position in this process on all rows.  Each step's loss and grad
    norm, the first step's gradients, the collectives the first step
    recorded, the transport's counters and the flash forward's
    launches.  `model`: more ModelConfig fields (an MoE's)."""
    from burst_attn_tpu_torch.models.transformer import init_params
    from burst_attn_tpu_torch.ops import flash

    torch.set_num_threads(1)
    cfg = _cfg(sizes, getattr(torch, dtype), dims, **(model or {}))
    tcfg = train.TrainConfig(lr=0.0, weight_decay=0.0, grad_clip=1e9,
                             moe_aux_weight=0.01)
    mesh = train.make_mesh(sizes, process_axes=across, device=device)
    params = train.place_params(
        init_params(cfg, 0, device=device) if tree is None
        else params_from_jax(tree, device=device), cfg, mesh)
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device=device)
    shard, n_shards = train.data_shard(cfg, mesh) if across else (0, 1)
    rows = np.array_split(np.arange(tok.shape[0]), n_shards)[shard]
    batch = train.batch_from_host(tok[rows, :-1], tok[rows, 1:], cfg, mesh,
                                  device=device)
    losses, norms = [], []
    launches0 = flash.flash_fwd.launches
    for i in range(steps):
        with pmesh.record_collectives() as ev:
            state, mt = step(state, batch)
        if i == 0:
            grads, events = whole_grads(params), list(ev)
        losses.append(float(mt["loss"]))
        norms.append(float(mt["grad_norm"]))
    return dict(losses=losses, norms=norms, grads=grads, events=events,
                stats=dict(mesh.transport.stats) if across else None,
                flash_fwd_launches=flash.flash_fwd.launches - launches0)


def train_cases(tree, tok, cases):
    """train_steps of each (sizes, across, model) of `cases` in turn, in
    the same processes (`tree` None for a case with a model of its
    own)."""
    return [train_steps(None if model else tree, tok, sizes, across,
                        steps=2, model=model)
            for sizes, across, model in cases]


def runner_run(argv, ckpt_dir):
    """runner.main(argv + --multihost --mesh dp=2,sp=2) for 2 steps with a
    checkpoint every step, then (rank 0 dropping the step-2 checkpoint) a
    run resuming from step 1: both runs' histories, the checkpoint writes
    this rank made, the checkpoint steps seen after each run; a step on
    --mesh inter=2,intra=2 (the ring across the processes); then a step
    each on tp, pp, ep across the processes and sp=4 split over them
    (their histories), and a pipeline with tp across them, which raises
    (its message)."""
    from burst_attn_tpu_torch.models import runner
    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    torch.set_num_threads(1)
    writes = []
    write = Checkpointer._write

    def counted(self, step, state):
        writes.append(step)
        return write(self, step, state)

    Checkpointer._write = counted
    base = argv + ["--multihost", "--mesh", "dp=2,sp=2", "--device", "cpu",
                   "--ckpt-dir", ckpt_dir, "--ckpt-every", "1"]
    _, full = runner.main(base + ["--steps", "2"])
    steps_a = Checkpointer(ckpt_dir).steps()
    synchronize()  # both listed before rank 0 drops a file
    if multihost.process_index() == 0:
        os.remove(os.path.join(ckpt_dir, "ckpt_00000002.pt"))
    synchronize()
    _, resumed = runner.main(base + ["--steps", "2"])
    steps_b = Checkpointer(ckpt_dir).steps()
    _, inter = runner.main(argv + ["--multihost", "--mesh", "inter=2,intra=2",
                                   "--device", "cpu", "--steps", "1"])
    ran, raised = {}, {}
    for mesh in ("tp=2,sp=2", "pp=2,sp=2", "ep=2,sp=2", "sp=4",
                 "tp=2,pp=2,sp=2"):
        try:
            ran[mesh] = runner.main(
                argv + RUNNER_EXTRA.get(mesh, []) + [
                    "--multihost", "--mesh", mesh, "--device", "cpu",
                    "--steps", "1"])[1]
        except NotImplementedError as e:
            raised[mesh] = str(e)
    return dict(full=full, resumed=resumed, inter=inter, writes=writes,
                steps_a=steps_a, steps_b=steps_b, ran=ran, raised=raised)


# the runner's extra flags for a mesh of runner_run's
RUNNER_EXTRA = {"ep=2,sp=2": ["--n-experts", "4"],
                "pp=2,sp=2": ["--microbatches", "1"],
                "tp=2,pp=2,sp=2": ["--microbatches", "1"]}


def slow_checkpoint(ckpt_dir, group_s, write_s):
    """Checkpointer.save of the narrow model with the run's group waits
    cut to `group_s` seconds and the primary's write held back `write_s`
    seconds (longer): the seconds this process spent in save, the
    checkpoint steps it then sees and the restored parameters."""
    import datetime
    import time

    from torch.distributed.distributed_c10d import _set_pg_timeout

    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    torch.set_num_threads(1)
    cfg = _cfg({"sp": 1})
    tcfg = train.TrainConfig()
    state = train.init_train_state(0, cfg, tcfg, None, device="cpu")
    ckpt = Checkpointer(ckpt_dir)
    write = ckpt._write

    def slow(step, state_):
        time.sleep(write_s)
        write(step, state_)

    ckpt._write = slow
    synchronize()  # both processes here before the waits are cut
    _set_pg_timeout(datetime.timedelta(seconds=group_s))
    t = time.perf_counter()
    ckpt.save(1, state)
    waited = time.perf_counter() - t
    synchronize()  # the run's group still answers
    (params, _), step = ckpt.restore_latest(cfg, tcfg, None, device="cpu")
    return dict(waited=waited, steps=ckpt.steps(), step=step,
                params=[_np(x) for x in tree_leaves(params)],
                want=[_np(x) for x in tree_leaves(state[0])])


def fail_or_sleep(failing_rank, sleep_s):
    """Rank `failing_rank` raises; every other rank sleeps `sleep_s`
    seconds, then waits at the barrier."""
    import time

    if multihost.process_index() == failing_rank:
        raise ValueError(f"rank {failing_rank} fails")
    time.sleep(sleep_s)
    synchronize()


TP_SP = {"tp": 2, "sp": 2}  # tp across the two processes, sp local


def tp_checkpoint(tok, ckpt_dir):
    """A step of the narrow model on tp=2 (across the processes) x sp=2 at
    lr 1e-3 (moments nonzero), saved by Checkpointer (rank 0 writes after
    the shards' gather), then restored into both processes: the whole
    tree (gathered), whether the restored shards and moments equal the
    saved ones, the next step's loss from the saved and from the restored
    state, the checkpoint steps seen."""
    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    torch.set_num_threads(1)
    cfg = _cfg(TP_SP)
    tcfg = train.TrainConfig(lr=1e-3)
    mesh = train.make_mesh(TP_SP, process_axes="auto", device="cpu")
    state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    batch = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, mesh,
                                  device="cpu")
    state, _ = step(state, batch)
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(1, state)
    whole = [_np(x.full()) if isinstance(x, Shards) else _np(x).copy()
             for x in tree_leaves(state[0])]  # before the next in-place step
    (params, opt), at = ckpt.restore_latest(cfg, tcfg, mesh, device="cpu")
    same = (at == 1 and all(torch.equal(a, b) for a, b in zip(
        train.param_leaves(params), train.param_leaves(state[0]))))
    sa, sb = state[1].state_dict()["state"], opt.state_dict()["state"]
    same = same and sa.keys() == sb.keys() and all(
        torch.equal(sa[i][key], sb[i][key]) for i in sa for key in sa[i])
    _, m_a = step(state, batch)
    _, m_b = step((params, opt), batch)
    return dict(whole=whole, same=same, loss_a=float(m_a["loss"]),
                loss_b=float(m_b["loss"]), steps=ckpt.steps())


def runner_meshes(argv, ckpt_root, meshes):
    """runner.main(argv + --multihost --mesh M) for each mesh M: 2 steps
    with a checkpoint every step, then (rank 0 dropping the step-2
    checkpoint) a run resuming from step 1: both runs' histories and the
    checkpoint steps seen after each, by mesh."""
    from burst_attn_tpu_torch.models import runner
    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    torch.set_num_threads(1)
    out = {}
    for mesh in meshes:
        d = os.path.join(ckpt_root, mesh.replace(",", "_").replace("=", ""))
        base = argv + ["--multihost", "--mesh", mesh, "--device", "cpu",
                       "--ckpt-dir", d, "--ckpt-every", "1", "--steps", "2"]
        _, full = runner.main(base)
        steps_a = Checkpointer(d).steps()
        synchronize()  # both listed before rank 0 drops a file
        if multihost.process_index() == 0:
            os.remove(os.path.join(d, "ckpt_00000002.pt"))
        synchronize()
        _, resumed = runner.main(base)
        out[mesh] = dict(full=full, resumed=resumed, steps_a=steps_a,
                         steps_b=Checkpointer(d).steps())
    return out

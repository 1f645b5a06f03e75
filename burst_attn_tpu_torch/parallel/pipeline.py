"""Pipeline parallelism: GPipe microbatching over a `pp` mesh axis (port of
burst_attn_tpu/parallel/pipeline.py).

The P stages share one device, as the ring's positions do
(parallel/mesh.py).  The schedule is GPipe's: M microbatches, M + P - 1
ticks; at tick t stage s holds microbatch t - s, stage 0 injects, the
last stage banks.  Only the live (stage, microbatch) pairs of each tick
run, in tick order: the JAX program computes masked garbage on the
bubble ticks because it is one uniform SPMD program, and nothing of that
garbage reaches an output.  The hop from stage s to s + 1 is `hop`, a
COPY into a fresh buffer (mesh.ppermute's semantics: the bytes a
pipeline has to move are moved); a multi-card pipeline replaces it with
a send and a receive.

The gradient is autograd through the tick loop, which is the reverse
schedule; `remat=True` wraps the stage function in
torch.utils.checkpoint (non-reentrant), the counterpart of
jax.checkpoint.

Across processes (a Mesh whose `axis` spans them, parallel/mesh.py):
each process runs its own stages' live pairs of every tick, and a hop to
a stage another process holds is a send (`_Send`: posted, waited for at
the end of the forward; its 0-d token, value 0, joins the caller's
objective through `tokens`) met by that process's receive (`_Recv`) on
the next tick.  The backward is autograd's on each process: the
receiving stage's backward posts the activation's gradient back, the
sending stage's token backward receives it, a tag a microbatch and
direction (PP_TAG), so that the two processes' backward orders need not
agree.  The process without the last stage returns None.

    out = pipeline(stage_fn, stage_params, x, mesh={"pp": 4},
                   microbatches=8)

stage_fn    : (params_slice, activation [mb, ...]) -> activation [mb, ...]
stage_params: a tree (dicts, lists, tensors) whose leaves have a leading
              [P, ...] stage axis (stack_stages)
x           : [B, ...] global batch (B divisible by microbatches), or a
              tree of such tensors (None leaves pass through) that
              travels with its microbatch, as the LM's positions and
              segment ids travel with its activations
"""

from typing import Callable, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import crosses

# the first send / receive tag of the stage hops across processes: a
# microbatch's activation PP_TAG + mb, its gradient PP_TAG + m + mb
PP_TAG = 32


def tree_map(fn: Callable, *trees):
    """fn over the leaves (tensors) of trees of one structure: dicts,
    lists and tuples; a None leaf stays None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stages(per_stage_params):
    """[tree_stage0, tree_stage1, ...] -> one tree with a leading [P, ...]
    stage axis (the layout `pipeline` expects)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def axis_size(mesh, axis: str) -> int:
    """Size of `axis` in a mesh ({axis: size} or parallel.mesh.Mesh);
    raises if the mesh has no such axis."""
    shape = mesh.shape if hasattr(mesh, "shape") else dict(mesh)
    if axis not in shape:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{dict(shape)}")
    return int(shape[axis])


def gpipe_ticks(m: int, n_stages: int
                ) -> Iterator[Tuple[int, List[Tuple[int, int]]]]:
    """The GPipe schedule of m microbatches over n_stages stages: for each
    tick t of the m + n_stages - 1, (t, the live (stage, microbatch)
    pairs in stage order); stage s holds microbatch t - s."""
    for t in range(m + n_stages - 1):
        yield t, [(s, t - s) for s in range(n_stages) if 0 <= t - s < m]


def hop(x: torch.Tensor) -> torch.Tensor:
    """The activation's move from stage s to s + 1: a copy into a fresh
    buffer (differentiable; its backward is the copy back)."""
    return x.clone()


def _leaves(tree) -> list:
    """The tensor leaves of `tree` in tree_map's order (None skipped)."""
    out = []
    tree_map(out.append, tree)
    return out


def _rebuild(tree, it):
    """`tree`'s structure with its tensor leaves taken from iterator
    `it` in _leaves' order."""
    return tree_map(lambda _: next(it), tree)


class _Hops:
    """The stage hops of one pipeline call across processes: this
    process's stages, the ranks of the processes before and after it on
    the pp axis, and the sends in flight (ProcessTransport)."""

    def __init__(self, mesh, axis: str, microbatches: int):
        self.t, self.m = mesh.transport, microbatches
        n, share = mesh.shape.get(axis, 1), mesh.local_size(axis)
        lo = mesh.local_start(axis)
        ranks = mesh.axis_ranks(axis)
        self.here = range(lo, lo + share)
        self.prev = ranks[lo // share - 1] if lo else None
        self.next = ranks[lo // share + 1] if lo + share < n else None

    def post(self, peer, tensors, tag):
        self.t.pending.append(self.t.exchange_start(
            {peer: [t.detach() for t in tensors]}, {}, tag=tag))

    def recv(self, peer, like, tag):
        return self.t.exchange_start({}, {peer: like}, tag=tag).wait()[peer]


class _Send(torch.autograd.Function):
    """A microbatch's activation (its tensor leaves) leaving for the next
    stage's process: the forward posts the send and returns a 0-d token
    (value 0); the backward receives the floating leaves' gradient."""

    @staticmethod
    def forward(ctx, hops, mb, *tensors):
        hops.post(hops.next, tensors, PP_TAG + mb)
        ctx.hops, ctx.mb = hops, mb
        ctx.like = [(t.shape, t.dtype, t.device) if t.is_floating_point()
                    else None for t in tensors]
        return torch.zeros((), dtype=torch.float32, device=tensors[0].device)

    @staticmethod
    def backward(ctx, _):
        hops = ctx.hops
        got = iter(hops.recv(hops.next, [
            torch.empty(lk[0], dtype=lk[1], device=lk[2])
            for lk in ctx.like if lk is not None], PP_TAG + hops.m + ctx.mb))
        return (None, None) + tuple(None if lk is None else next(got)
                                    for lk in ctx.like)


class _Recv(torch.autograd.Function):
    """A microbatch's activation arriving from the previous stage's
    process (tensors like `like`); the backward posts its floating
    leaves' gradient back.  `anchor` (a 0-d leaf requiring grad) puts the
    receive in the graph."""

    @staticmethod
    def forward(ctx, hops, mb, like, anchor):
        got = hops.recv(hops.prev, like, PP_TAG + mb)
        ctx.hops, ctx.mb = hops, mb
        ctx.floats = [t.is_floating_point() for t in got]
        ctx.mark_non_differentiable(*[t for t in got
                                      if not t.is_floating_point()])
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        hops = ctx.hops
        hops.post(hops.prev, [g for g, f in zip(grads, ctx.floats) if f],
                  PP_TAG + hops.m + ctx.mb)
        return None, None, None, None


def pipeline(stage_fn, stage_params, x, *, mesh, axis: str = "pp",
             microbatches: int, remat: bool = False,
             tokens: Optional[list] = None):
    """Run `x` through the P stages of `mesh`'s `axis` (stage p applies
    stage_fn(params_p, act) with params_p the p-th slice of every leaf of
    stage_params).  Returns stage_fn applied P times, [B, ...] (a tree
    of the activation's structure).  When `axis` spans processes of
    `mesh`, this process runs its own stages (module docstring): the
    tokens of its sends are appended to `tokens`, and it returns None
    unless it holds the last stage."""
    leaves = []
    tree_map(leaves.append, x)
    b = leaves[0].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches "
                         f"{microbatches}")
    n_stages = axis_size(mesh, axis)
    params = [tree_map(lambda a, p=p: a[p], stage_params)
              for p in range(n_stages)]

    def fn(p, act):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, p, act, use_reentrant=False)
        return stage_fn(p, act)

    x_mb = [tree_map(lambda a, i=i: a.reshape(
        microbatches, b // microbatches, *a.shape[1:])[i], x)
        for i in range(microbatches)]
    hops = _Hops(mesh, axis, microbatches) if crosses(mesh, axis) else None
    here = hops.here if hops else range(n_stages)
    held = {}  # stage -> the activation it received on the last tick
    out = [None] * microbatches
    for _, live in gpipe_ticks(microbatches, n_stages):
        arriving = {}
        for s, mb in live:
            if s not in here:
                continue
            if s == 0:
                act = x_mb[mb]
            elif s - 1 in here:
                act = held[s]
            else:  # the previous stage's process sent it last tick
                anchor = torch.zeros((), requires_grad=True)
                act = _rebuild(x_mb[mb], iter(_Recv.apply(
                    hops, mb, _leaves(x_mb[mb]), anchor)))
            y = fn(params[s], act)
            if s == n_stages - 1:
                out[mb] = y  # banked
            elif s + 1 in here:
                arriving[s + 1] = tree_map(hop, y)
            else:
                tokens.append(_Send.apply(hops, mb, *_leaves(y)))
        held = arriving
    if hops is not None:
        hops.t.drain()
        if n_stages - 1 not in here:
            return None
    return tree_map(lambda *ys: torch.cat(ys), *out)

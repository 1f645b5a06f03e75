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

from typing import Callable, Iterator, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint


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


def pipeline(stage_fn, stage_params, x, *, mesh, axis: str = "pp",
             microbatches: int, remat: bool = False):
    """Run `x` through the P stages of `mesh`'s `axis` (stage p applies
    stage_fn(params_p, act) with params_p the p-th slice of every leaf of
    stage_params).  Returns stage_fn applied P times, [B, ...] (a tree
    of the activation's structure)."""
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
    held = {}  # stage -> the activation it received on the last tick
    out = [None] * microbatches
    for _, live in gpipe_ticks(microbatches, n_stages):
        arriving = {}
        for s, mb in live:
            y = fn(params[s], x_mb[mb] if s == 0 else held[s])
            if s == n_stages - 1:
                out[mb] = y  # banked
            else:
                arriving[s + 1] = tree_map(hop, y)
        held = arriving
    return tree_map(lambda *ys: torch.cat(ys), *out)

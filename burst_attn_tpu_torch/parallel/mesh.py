"""A device mesh on ONE device (the counterpart of jax.sharding.Mesh plus
shard_map, the ring's rotations and burst_attn_tpu/parallel/
collectives.py).

`Mesh({"sp": W})` or `Mesh({"inter": a, "intra": b})` holds W ring
positions that share one device: each position keeps its own shard of
the sequence, every position runs the same per-position program, and the
ring's rotation is `ppermute`, which COPIES each position's payload into
a fresh buffer of its receiver — the bytes a ring has to move are moved.
`all_to_all` is the exchange of Ulysses attention (parallel/ulysses.py)
and of expert parallelism (parallel/moe.py), with the same copy
semantics.  The data (`dp`) and tensor (`tp`) axes hold positions beside
the ring's: each (dp, tp) group runs its own sequence ring, and the
Megatron collectives between a group's positions are `all_reduce`,
`broadcast`, `all_gather` and `reduce_scatter` (the JAX package's
collectives.py over lax), which take one part per position and give each
position a fresh copy of its result.  A pipeline's `pp` axis holds
stages, not ring positions (parallel/pipeline.py): each stage's ring sees
only its sequence axes (`seq_mesh`), so the ring never counts pp as an
extra axis.

Across processes (`Mesh(shape, process_axes="auto")`, utils/multihost.py
`make_hybrid_mesh`): with P processes in the run, process r holds the
flat positions [r N/P, (r+1) N/P) of the mesh's row-major order (`coords`),
as JAX's process-major device order lays a Mesh out; N must divide by P
(ValueError, as JAX's devices would run short), and the positions of a
process must form a sub-grid (`process_layout`: its leading axes one index
a process, at most one axis split between processes, the rest local).
Any axis may so span processes: a ring's, tp, ep, dp, an axis split 2 + 2.
The per-position loops run over this process's positions only
(`local_size`, `ring_positions`), and every collective over an axis that
spans processes moves what crosses through parallel/collectives.py
`ProcessTransport` (gloo, CUDA payloads staged through pinned host
buffers): a `ppermute` pair whose source and destination lie in one
process stays a local copy, the other pairs are sent to the peer that
holds the destination (`ppermute_start` posts them, its handle's `wait()`
receives, so that the ring can post a hop one round early); `all_to_all`
sends each peer its chunks; the four collectives (their `mesh=` argument)
gather every position's part from every process, then run the
one-process code on the whole position-ordered list: sums keep position
order and the parts' dtype, so a run across processes equals the
one-process run bit for bit.  Across processes these are autograd
functions: `all_reduce` is Megatron's g (its consumers hold replicas of
the result, each process's gradient of it is the whole one: the backward
hands it to the parts), `copy_to` is Megatron's f (the identity; the
backward sums the processes' gradients), `all_to_all`'s backward is the
all-to-all back, and `mean_across` (an MoE aux loss over distinct token
groups) sums its gradient over the processes before the mean's backward.

`record_collectives()` is the analyzer's recorder (analysis/
ringcheck.py): while it is active, every `ppermute` appends (cls, axis,
hops) — the rotation offset derived from the copies it actually made,
None if they were not a uniform rotation — every `all_to_all` appends
("a2a", axis, None), and each of the four collectives above (cls, axis,
None) with its own class (COLLECTIVE_CLASSES).  A ppermute's class is
the call site's ("pay" for a payload rotation, "dq" for the backward's
dq ring).  Off, it costs each collective one `None` check.
"""

import contextlib
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .ring import ring_coords

def process_layout(shape: Dict[str, int], n_procs: int) -> Dict[str, int]:
    """{axis: the positions of it a process holds} for each axis of `shape`
    ({axis: size}, in mesh order) that spans processes when `n_procs`
    processes hold its N positions in JAX's process-major order (process
    r the flat positions [r N/P, (r+1) N/P)): the leading axes one index a
    process (1), at most one axis split between processes (its share),
    every later axis whole in each process (not listed).  ValueError when
    N does not divide by n_procs, or when a process's positions are not a
    sub-grid of the mesh ({"a": 3, "b": 2} over 2 processes)."""
    shape = {str(a): int(n) for a, n in shape.items()}
    n = math.prod(shape.values())
    if n % n_procs:
        raise ValueError(f"mesh {shape} of {n} positions does not divide "
                         f"between {n_procs} processes")
    rest, local = n // n_procs, {}
    for a, size in reversed(list(shape.items())):
        if rest % size == 0:  # whole in every process
            rest //= size
            continue
        if size % rest:
            raise ValueError(
                f"mesh {shape} over {n_procs} processes: {n // n_procs} "
                f"positions a process are not a sub-grid (axis {a!r} of "
                f"size {size} does not split into parts of {rest})")
        local[a] = rest
        rest = 1
    return {a: local[a] for a in shape if a in local}


def process_axes_for(shape: Dict[str, int], n_procs: int) -> Tuple[str, ...]:
    """The axes of `shape` that span `n_procs` processes (process_layout's,
    in mesh order; () for one process)."""
    return tuple(process_layout(shape, n_procs))


def layout_positions(shape: Dict[str, int], n_procs: int,
                     rank: int) -> List[int]:
    """The flat positions process `rank` of `n_procs` holds, enumerated
    from process_layout's sub-grid (each axis's share at the process's
    coordinate), in row-major order: [rank N/P, (rank+1) N/P)."""
    local = process_layout(shape, n_procs)
    counts = [shape[a] // m for a, m in local.items()]
    coords = dict(zip(local, np.unravel_index(rank, counts))) if local \
        else {}
    ranges = [range(int(coords[a]) * local[a], (int(coords[a]) + 1)
                    * local[a]) if a in local else range(n)
              for a, n in shape.items()]
    return [int(np.ravel_multi_index(c, tuple(shape.values())))
            for c in itertools.product(*ranges)]


class _Layout:
    """How the processes of a run hold a mesh (process_layout): each
    spanning axis's share a process, the number of processes along it,
    the rank at each process coordinate, this process's coordinates, and
    the transport between the processes."""

    def __init__(self, shape: Dict[str, int], world: int, rank: int):
        from .collectives import ProcessTransport

        self.local = process_layout(shape, world)
        counts = tuple(shape[a] // m for a, m in self.local.items())
        self.ranks = np.arange(world).reshape(counts)
        self.coords = {a: int(c) for a, c in zip(
            self.local, np.unravel_index(rank, counts))}
        self.rank = rank
        self.transport = ProcessTransport()


class Mesh:
    """Named axis sizes {axis: size} on one device (default: the card).
    `process_axes="auto"` lays the mesh over the processes of the run
    (the group must be up, utils/multihost.py) in JAX's process-major
    order (process_layout): this process then holds only its positions;
    a tuple of names is the same request, checked against the layout the
    process count gives (ValueError otherwise).  `sub(shape)` derives the
    mesh a part of the program runs on (a dp group's, a ring's)."""

    def __init__(self, shape: Dict[str, int], device=None,
                 process_axes: Union[str, Sequence[str]] = ()):
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        bad = {a: n for a, n in self.shape.items() if n < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be >= 1, got {bad}")
        self.device = resolve_device(device)
        self._layout: Optional[_Layout] = None
        self.process_axes: Tuple[str, ...] = ()
        if process_axes:
            self._init_processes(process_axes)

    def _init_processes(self, asked) -> None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        axes = process_axes_for(self.shape, world)
        if asked != "auto" and tuple(asked) != axes:
            raise ValueError(
                f"process axes {tuple(asked)} of {self.shape}: over the run's "
                f"{world} processes the process-major order spans {axes}")
        if world > 1:
            self._layout = _Layout(self.shape, world, dist.get_rank())
            self.process_axes = axes

    def __repr__(self):
        procs = (f", process_axes={self.process_axes}"
                 if self.process_axes else "")
        return f"Mesh({self.shape}, device={self.device}{procs})"

    @property
    def transport(self):
        """The process transport (None on a mesh of one process)."""
        return self._layout.transport if self._layout else None

    @property
    def process_index(self) -> int:
        return self._layout.rank if self._layout else 0

    @property
    def process_coords(self) -> Dict[str, int]:
        """{axis: this process's index among the processes along it} of
        the process axes."""
        return {a: self._layout.coords[a] for a in self.process_axes}

    def sub(self, shape: Dict[str, int]) -> "Mesh":
        """The mesh of `shape` ({axis: size}) as a part of this one: a
        process axis it keeps at its size still spans the processes, one
        it drops or shrinks is fixed at this process's share (a dp
        group's mesh, a ring's) and remains a `crosses` axis for the
        collectives (an MoE exchange over dp from a dp group's mesh).
        Shares the layout and the transport."""
        shape = {str(a): int(n) for a, n in shape.items()}
        m = Mesh.__new__(Mesh)
        m.shape, m.device, m._layout = shape, self.device, self._layout
        m.process_axes = tuple(a for a in self.process_axes
                               if shape.get(a) == self.shape[a])
        return m

    def crosses(self, axis) -> bool:
        """Whether mesh axis `axis` spans processes in the run's layout
        (kept or fixed by sub)."""
        return self._layout is not None and axis in self._layout.local

    def local_size(self, axis) -> int:
        """The positions of `axis` this process holds: its share on a
        process axis, its size otherwise (1 for an axis the mesh lacks or
        None)."""
        if axis in self.process_axes:
            return self._layout.local[axis]
        return self.shape.get(axis, 1) if axis is not None else 1

    def local_start(self, axis) -> int:
        """The index along `axis` of this process's first position (0 on
        an axis whole in each process)."""
        if axis in self.process_axes:
            return self._layout.coords[axis] * self._layout.local[axis]
        return 0

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of the processes along `axis` (a crossing axis) that
        share this process's coordinates on the other process axes, in the
        axis's index order."""
        lay = self._layout
        idx = tuple(slice(None) if a == axis else lay.coords[a]
                    for a in lay.local)
        return [int(r) for r in np.atleast_1d(lay.ranks[idx])]

    def axis_index(self, axis: str) -> int:
        """This process's index among the processes along crossing axis
        `axis` (0 on an axis whole in each process)."""
        return self._layout.coords[axis] if self.crosses(axis) else 0

    def ring_procs(self, seq_axes) -> Optional["ProcRing"]:
        """The processes of a ring over `seq_axes`: None when every ring
        position is in this process, else the ProcRing of the positions
        held here and each position's rank."""
        seq_axes = _names(seq_axes)
        if not any(a in self.process_axes for a in seq_axes):
            return None
        lay = self._layout
        sizes = [self.shape.get(a, 1) for a in seq_axes]
        owners = []
        for c in itertools.product(*(range(n) for n in sizes)):
            at = dict(zip(seq_axes, c))
            owners.append(int(lay.ranks[tuple(
                at[a] // lay.local[a] if a in at else lay.coords[a]
                for a in lay.local)]))
        pos = tuple(p for p, r in enumerate(owners) if r == lay.rank)
        return ProcRing(pos, tuple(owners), lay.rank, lay.transport)

    def size(self, axes) -> int:
        """Product of the sizes of `axes` (a name, a sequence of names or
        None); an axis the mesh lacks has size 1."""
        n = 1
        for a in _names(axes):
            n *= self.shape.get(a, 1)
        return n

    def ring(self, seq_axes, group_axes=()) -> Tuple[int, int]:
        """(n_inter, n_intra) of the ring over `seq_axes` (one name: a flat
        ring; two names: (inter, intra)).  `group_axes` names the axes
        (dp, tp) whose positions each run a ring of their own; any other
        axis of size > 1 raises ValueError, as a mesh axis the program
        does not shard over would replicate its work."""
        seq_axes = _names(seq_axes)
        if len(seq_axes) not in (1, 2):
            raise ValueError(f"seq_axes must have 1 or 2 names, got "
                             f"{seq_axes}")
        keep = seq_axes + _names(group_axes)
        extra = {a: n for a, n in self.shape.items()
                 if a not in keep and n > 1}
        if extra:
            raise ValueError(
                f"mesh axes {extra} are neither the sequence axes "
                f"{seq_axes} nor the batch or head axes "
                f"{_names(group_axes)}")
        if len(seq_axes) == 1:
            return 1, self.size(seq_axes)
        return self.size(seq_axes[0]), self.size(seq_axes[1])

    def coords(self, position: int) -> Dict[str, int]:
        """{axis: index} of flat `position` (row-major over the axes in
        the mesh's order, the last axis fastest, as jax's device grid)."""
        out, rest = {}, int(position)
        for a, n in reversed(list(self.shape.items())):
            out[a] = rest % n
            rest //= n
        return {a: out[a] for a in self.shape}


@dataclass(frozen=True)
class ProcRing:
    """A ring across processes: the flat ring positions this process holds
    (`pos`, contiguous, in order), the rank holding each ring position
    (`owners`), this rank and the transport."""

    pos: Tuple[int, ...]
    owners: Tuple[int, ...]
    rank: int
    transport: object


def ring_positions(n_inter: int, n_intra: int,
                   procs: Optional[ProcRing] = None) -> List[int]:
    """The flat ring positions a process holds: all of them, or with
    `procs` its own."""
    if procs is None:
        return list(range(n_inter * n_intra))
    return list(procs.pos)


def as_mesh(mesh: Union[Mesh, Dict[str, int]], device) -> Mesh:
    """`mesh` as a Mesh; a plain {axis: size} dict takes `device` (the
    device of the tensors it will shard)."""
    if isinstance(mesh, Mesh):
        if mesh.device != torch.device(device):
            raise ValueError(f"tensors on {device} but the mesh is on "
                             f"{mesh.device}")
        return mesh
    return Mesh(mesh, device=device)


def axis_size(mesh, axis) -> int:
    """The size of `axis` (a name, or None: 1) in `mesh` ({axis: size}, a
    Mesh or None); an axis the mesh lacks has size 1."""
    if mesh is None or axis is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    return int(shape.get(axis, 1))


def local_size(mesh, axis) -> int:
    """The positions of `axis` this process holds (axis_size, but 1 on a
    Mesh's process axis)."""
    if isinstance(mesh, Mesh):
        return mesh.local_size(axis)
    return axis_size(mesh, axis)


def process_axes(mesh) -> Tuple[str, ...]:
    """The axes of `mesh` that span processes (none for a dict)."""
    return mesh.process_axes if isinstance(mesh, Mesh) else ()


def seq_mesh(mesh, seq_axes):
    """What one pipeline stage's ring, or one (dp, tp) group's, sees of
    `mesh` ({axis: size} or a Mesh): its sequence axes alone, {axis:
    size}, or the Mesh.sub of them when `mesh` spans processes."""
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    out = {a: int(shape[a]) for a in _names(seq_axes) if a in shape}
    return sub_mesh(mesh, out)


def sub_mesh(mesh, shape: Dict[str, int]):
    """`shape` ({axis: size}) as a part of `mesh`: Mesh.sub when `mesh`
    is laid over processes, else the dict itself."""
    if isinstance(mesh, Mesh) and mesh._layout is not None:
        return mesh.sub(shape)
    return dict(shape)


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(a for a in axes if a is not None)


def shard(x: torch.Tensor, world: int, dim: int = 2) -> torch.Tensor:
    """Split `x` along `dim` into `world` equal chunks, stacked in one
    contiguous copy [world, ...]: position p's shard is the contiguous
    view [p]."""
    if x.shape[dim] % world:
        raise ValueError(f"dim {dim} of length {x.shape[dim]} does not "
                         f"divide by the ring's {world} positions")
    return x.unflatten(dim, (world, -1)).movedim(dim, 0).contiguous()


def unshard(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """Inverse of `shard`: the stacked shards [world, ...] joined along
    `dim` of one shard."""
    return x.movedim(0, dim).flatten(dim, dim + 1)


# the active recorder's event list, or None (see record_collectives)
_RECORDER: Optional[List[Tuple[str, str, Optional[int]]]] = None


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued inside the block: yields the list
    the ppermute / all_to_all calls append (cls, axis, hops) to, in issue
    order.  Nests: an inner recorder sees only its own block's events."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, []
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def rotation_offset(pairs, n: int) -> Optional[int]:
    """Uniform rotation offset of a permutation given as (src, dst) ranks
    over 0..n-1 (every dst = src + offset mod n), or None when it is not
    a bijective constant-offset rotation."""
    srcs = sorted(s for s, _ in pairs)
    dsts = sorted(d for _, d in pairs)
    if srcs != list(range(n)) or dsts != list(range(n)):
        return None
    offs = {(d - s) % n for s, d in pairs}
    return offs.pop() if len(offs) == 1 else None


def record_permutation(cls: str, axis: str, pairs, n: int) -> None:
    """Append one permutation of `axis` (size n; (src, dst) rank pairs)
    to the active recorder, as (cls, axis, its rotation offset)."""
    if _RECORDER is not None:
        _RECORDER.append((cls, axis, rotation_offset(pairs, n)))


class _Done:
    """A rotation whose copies are already made (every position local)."""

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Arriving:
    """A rotation whose pairs across processes are in flight: wait()
    places each arrival beside the local copies."""

    def __init__(self, out, exchange, recv, width):
        self._out, self._x, self._recv, self._w = out, exchange, recv, width

    def wait(self):
        got = self._x.wait()
        for peer, js in self._recv.items():
            flat = got[peer]
            for i, j in enumerate(js):
                self._out[j] = tuple(flat[i * self._w:(i + 1) * self._w])
        return self._out


def _ring_step(p: int, axis: str, n_inter: int, n_intra: int, hops: int):
    """The ring position `hops` ahead of flat position p along `axis`."""
    ii, si = ring_coords(p, n_inter, n_intra)
    if axis == "intra":
        return ii * n_intra + (si + hops) % n_intra
    return ((ii + hops) % n_inter) * n_intra + si


def ppermute_start(parts: Sequence[Tuple[torch.Tensor, ...]], axis: str,
                   n_inter: int, n_intra: int, hops: int = 1,
                   cls: str = "pay", procs: Optional[ProcRing] = None):
    """Start `ppermute`; returns a handle whose `wait()` gives the
    rotated payloads.  Local copies are made here; with `procs` (a ring
    across processes, the parts its positions') each payload whose
    destination another process holds is staged and posted here to that
    process, one message a peer (ProcessTransport.exchange_start), and
    the handle receives the arrivals."""
    if axis not in ("intra", "inter"):
        raise ValueError(f"axis must be 'intra' or 'inter', got {axis!r}")
    n_axis = n_intra if axis == "intra" else n_inter
    if procs is not None:
        record_permutation(cls, axis, {(i, (i + hops) % n_axis)
                                       for i in range(n_axis)}, n_axis)
        index = {p: j for j, p in enumerate(procs.pos)}
        out, recv, send = [None] * len(parts), {}, {}
        for j, p in enumerate(procs.pos):
            src = _ring_step(p, axis, n_inter, n_intra, -hops)
            if src in index:
                out[j] = tuple(t.clone() for t in parts[index[src]])
            else:
                recv.setdefault(procs.owners[src], []).append(j)
        # each peer's payloads in the order of their destinations
        for j in sorted(range(len(parts)), key=lambda j_: _ring_step(
                procs.pos[j_], axis, n_inter, n_intra, hops)):
            dst = _ring_step(procs.pos[j], axis, n_inter, n_intra, hops)
            if dst not in index:
                send.setdefault(procs.owners[dst], []).extend(parts[j])
        if not recv and not send:
            return _Done(out)
        like = list(parts[0])
        return _Arriving(out, procs.transport.exchange_start(
            send, {peer: like * len(js) for peer, js in recv.items()},
            tag=_tag(cls, axis)), recv, len(like))
    out, srcs = [], []
    for p in range(n_inter * n_intra):
        src = _ring_step(p, axis, n_inter, n_intra, -hops)
        srcs.append(src)
        out.append(tuple(t.clone() for t in parts[src]))
    if _RECORDER is not None:
        # the (src, dst) ranks along the axis of the copies just made
        k = 1 if axis == "intra" else 0
        moves = {(ring_coords(src, n_inter, n_intra)[k],
                  ring_coords(p, n_inter, n_intra)[k])
                 for p, src in enumerate(srcs)}
        record_permutation(cls, axis, moves, n_axis)
    return _Done(out)


def _tag(cls: str, axis: str) -> int:
    from .collectives import TAGS

    return TAGS[(cls, axis)]


def ppermute(parts: Sequence[Tuple[torch.Tensor, ...]], axis: str,
             n_inter: int, n_intra: int, hops: int = 1, cls: str = "pay",
             procs: Optional[ProcRing] = None
             ) -> List[Tuple[torch.Tensor, ...]]:
    """Rotate every position's payload (a tuple of tensors) `hops`
    positions forward along the ring's "intra" or "inter" axis: position
    p receives a COPY of the payload of the position `hops` behind it.
    `cls` names the stream for the recorder ("pay" or "dq").  With
    `procs` the parts are this process's positions and the pairs across
    processes go through the transport (ppermute_start, then its
    wait)."""
    return ppermute_start(parts, axis, n_inter, n_intra, hops, cls,
                          procs).wait()


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, axis: Optional[str] = None, mesh=None
               ) -> List[torch.Tensor]:
    """The tiled all-to-all of W positions (lax.all_to_all(x, axis,
    split_axis=split_dim, concat_axis=concat_dim, tiled=True) inside
    shard_map): each position's tensor splits into W equal chunks along
    `split_dim`, and position p receives chunk p of every peer,
    concatenated along `concat_dim` in peer order.  The result is a
    fresh COPY per position (torch.cat), so the bytes the exchange
    moves are moved; differentiable through autograd (the transpose of
    an all-to-all is the all-to-all back).  `axis` names the mesh axis
    for the recorder; when it spans processes of `mesh`, the parts are
    this process's positions along it and each peer process receives
    its chunks (_AllToAllAcross)."""
    if _RECORDER is not None:
        _RECORDER.append(("a2a", axis, None))
    if crosses(mesh, axis):
        return list(_AllToAllAcross.apply(split_dim, concat_dim, axis, mesh,
                                          *parts))
    w = len(parts)
    for t in parts:
        if t.shape[split_dim] % w:
            raise ValueError(f"dim {split_dim} of length "
                             f"{t.shape[split_dim]} does not divide by the "
                             f"{w} positions of the all-to-all")
    chunks = [t.chunk(w, dim=split_dim) for t in parts]
    return [torch.cat([chunks[q][p] for q in range(w)], dim=concat_dim)
            for p in range(w)]


def _a2a_across(parts, split_dim, concat_dim, axis, mesh):
    """all_to_all of this process's m positions along crossing `axis` with
    the other processes' (m each): the chunks of a peer's positions go to
    it in one message, (local part, its position) order."""
    m, ranks, me = len(parts), mesh.axis_ranks(axis), mesh.axis_index(axis)
    w = m * len(ranks)
    for t in parts:
        if t.shape[split_dim] % w:
            raise ValueError(f"dim {split_dim} of length "
                             f"{t.shape[split_dim]} does not divide by the "
                             f"{w} positions of the all-to-all")
    chunks = [t.chunk(w, dim=split_dim) for t in parts]
    send, recv = {}, {}
    for c, r in enumerate(ranks):
        if c != me:
            send[r] = [chunks[q][p] for q in range(m)
                       for p in range(c * m, (c + 1) * m)]
            recv[r] = [chunks[0][0]] * (m * m)
    from .collectives import A2A_TAG

    got = mesh.transport.exchange_start(send, recv, tag=A2A_TAG).wait()
    out = []
    for i in range(m):
        pieces = []
        for c, r in enumerate(ranks):
            for q in range(m):
                pieces.append(chunks[q][me * m + i] if c == me
                              else got[r][q * m + i])
        out.append(torch.cat(pieces, dim=concat_dim))
    return out



class _AllToAllAcross(torch.autograd.Function):
    """all_to_all over an axis that spans processes; its backward is the
    all-to-all back (split and concat dims swapped), run by every process
    at the same point of its backward."""

    @staticmethod
    def forward(ctx, split_dim, concat_dim, axis, mesh, *parts):
        ctx.args = (split_dim, concat_dim, axis, mesh)
        return tuple(_a2a_across(list(parts), split_dim, concat_dim, axis,
                                 mesh))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim, axis, mesh = ctx.args
        return (None,) * 4 + tuple(_a2a_across(
            [g.contiguous() for g in grads], concat_dim, split_dim, axis,
            mesh))


# -- the Megatron collectives (burst_attn_tpu/parallel/collectives.py) -------

# the recorder's class of each collective below
COLLECTIVE_CLASSES = ("all_reduce", "broadcast", "all_gather",
                      "reduce_scatter")
_REDUCE_OPS = ("sum", "mean", "max", "min")


def _record(cls: str, axis: Optional[str]) -> None:
    if _RECORDER is not None:
        _RECORDER.append((cls, axis, None))


def _replicate(x: torch.Tensor, w: int) -> List[torch.Tensor]:
    """One result per position: `x` itself (a fresh tensor) for the first,
    a copy for every other."""
    return [x] + [x.clone() for _ in range(w - 1)]


def crosses(mesh, axis) -> bool:
    """Whether `axis` spans processes of `mesh` (a Mesh laid over them;
    never for a dict)."""
    return isinstance(mesh, Mesh) and mesh.crosses(axis)


def _gathered(parts: Sequence[torch.Tensor], axis: Optional[str], mesh
              ) -> Tuple[List[torch.Tensor], int]:
    """(every position's part in position order, the index of this
    process's first part in it): over an axis of `mesh` that spans
    processes, gathered from the processes along it
    (ProcessTransport.all_gather); else the parts themselves."""
    if not crosses(mesh, axis):
        return list(parts), 0
    got = mesh.transport.all_gather([t.detach() for t in parts],
                                    mesh.axis_ranks(axis))
    return [t for part in got for t in part], \
        mesh.axis_index(axis) * len(parts)


def _sum(parts):
    r = parts[0]
    for t in parts[1:]:
        r = r + t
    return r


class _AllReduceAcross(torch.autograd.Function):
    """all_reduce (sum / mean) over an axis that spans processes, as
    Megatron's g: the forward sums every process's parts in position
    order; the consumers of the result are replicas on every process
    (tp), each holding the whole gradient of it, so the backward hands
    that gradient (the local results' summed; / W for the mean) to the
    local parts."""

    @staticmethod
    def forward(ctx, op, axis, mesh, *parts):
        full, _ = _gathered(parts, axis, mesh)
        r = _sum(full)
        if op == "mean":
            r = r / len(full)
        elif len(full) == 1:
            r = r.clone()
        ctx.op, ctx.w = op, len(full)
        return tuple(_replicate(r, len(parts)))

    @staticmethod
    def backward(ctx, *grads):
        g = _sum(grads)
        if ctx.op == "mean":
            g = g / ctx.w
        return (None,) * 3 + tuple(_replicate(g, len(grads)))


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity on a tensor every process along `axis`
    holds alike, whose consumers here are this process's positions; the
    backward sums the processes' gradients, the last position's first
    (as autograd adds one process's per-position aliases,
    transformer.tp_inputs)."""

    @staticmethod
    def forward(ctx, axis, mesh, x):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        full, _ = _gathered([g.contiguous()], axis, mesh)
        return None, None, _sum(full[::-1])


def copy_to(x: torch.Tensor, axis: Optional[str], mesh) -> torch.Tensor:
    """`x` (alike on every process along `axis`) as the input of this
    process's positions of `axis`: the identity, whose backward sums the
    gradient over the processes when `axis` spans them (Megatron's f,
    the last process's first); `x` itself otherwise (one process's
    positions add their gradients through autograd)."""
    if not crosses(mesh, axis) or not x.requires_grad:
        return x
    return _CopyTo.apply(axis, mesh, x)


class _MeanAcross(torch.autograd.Function):
    """The mean of every position's 0-d part over an axis that spans
    processes, for consumers that differ by process (each its own token
    groups' loss): the backward sums the result's gradient over the
    processes, then divides as the mean's backward does."""

    @staticmethod
    def forward(ctx, axis, mesh, *parts):
        full, _ = _gathered(parts, axis, mesh)
        ctx.args, ctx.w, ctx.n = (axis, mesh), len(full), len(parts)
        return torch.stack(full).mean()

    @staticmethod
    def backward(ctx, g):
        full, _ = _gathered([g.contiguous()], *ctx.args)
        return (None,) * 2 + tuple(_sum(full) / ctx.w
                                   for _ in range(ctx.n))


def mean_across(parts: Sequence[torch.Tensor], axis: Optional[str],
                mesh) -> torch.Tensor:
    """torch.stack(parts).mean() over every position of `axis`: the
    processes' parts joined in position order when it spans them
    (_MeanAcross)."""
    if not crosses(mesh, axis):
        return torch.stack(list(parts)).mean()
    return _MeanAcross.apply(axis, mesh, *parts)


class _KeepGrad(torch.autograd.Function):
    """The identity whose backward passes the gradient (keep) or zeros:
    an MoE replica other than the first contributes no gradient to the
    experts, as the one-process run uses the first replica's output."""

    @staticmethod
    def forward(ctx, keep, x):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, (g if ctx.keep else torch.zeros_like(g))


def keep_grad(x: torch.Tensor, keep: bool) -> torch.Tensor:
    """_KeepGrad on `x`."""
    return _KeepGrad.apply(keep, x)


def all_reduce(parts: Sequence[torch.Tensor], op: str = "sum",
               axis: Optional[str] = None, mesh=None) -> List[torch.Tensor]:
    """lax.psum / pmean / pmax / pmin over W positions: every position
    receives its own copy of the reduction of all W parts (in the parts'
    dtype, summed in position order).  Differentiable (sum and mean: each
    part's gradient is the sum of the results' gradients, the all-reduce
    again).  `axis` names the mesh axis for the recorder; when it spans
    processes of `mesh`, the parts are this process's positions and the
    others' are gathered first: with parts that require grad, as
    Megatron's g (_AllReduceAcross)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    _record("all_reduce", axis)
    n_local = len(parts)
    if (op in ("sum", "mean") and crosses(mesh, axis)
            and any(t.requires_grad for t in parts)):
        return list(_AllReduceAcross.apply(op, axis, mesh, *parts))
    parts, _ = _gathered(parts, axis, mesh)
    if op in ("sum", "mean"):
        r = _sum(parts)
        if op == "mean":
            r = r / len(parts)
        elif len(parts) == 1:
            r = r.clone()
    else:
        r = torch.stack(list(parts))
        r = r.amax(0) if op == "max" else r.amin(0)
    return _replicate(r, n_local)


def broadcast(parts: Sequence[torch.Tensor], root: int = 0,
              axis: Optional[str] = None, mesh=None) -> List[torch.Tensor]:
    """Every position receives a copy of position `root`'s part (the JAX
    broadcast, a masked psum); over a process axis of `mesh` as
    all_reduce."""
    n_local = len(parts)
    parts, _ = _gathered(parts, axis, mesh)
    if not 0 <= root < len(parts):
        raise ValueError(f"root {root} outside the {len(parts)} positions")
    _record("broadcast", axis)
    return _replicate(parts[root].clone(), n_local)


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               axis: Optional[str] = None, tiled: bool = True, mesh=None
               ) -> List[torch.Tensor]:
    """lax.all_gather: every position receives the W parts in position
    order, concatenated along `dim` (tiled) or stacked in a new `dim`;
    over a process axis of `mesh` as all_reduce."""
    _record("all_gather", axis)
    n_local = len(parts)
    parts, _ = _gathered(parts, axis, mesh)
    x = torch.cat(list(parts), dim=dim) if tiled else torch.stack(
        list(parts), dim=dim)
    return _replicate(x, n_local)


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int = 0,
                   axis: Optional[str] = None, mesh=None
                   ) -> List[torch.Tensor]:
    """lax.psum_scatter(tiled=True): the sum of the W parts, split into W
    equal chunks along `dim`; position p receives chunk p (a copy); over
    a process axis of `mesh` as all_reduce, each local position its own
    chunk."""
    n_local = len(parts)
    parts, lo = _gathered(parts, axis, mesh)
    w = len(parts)
    if parts[0].shape[dim] % w:
        raise ValueError(f"dim {dim} of length {parts[0].shape[dim]} does "
                         f"not divide by the {w} positions")
    _record("reduce_scatter", axis)
    r = _sum(parts)
    return [c.contiguous() if w > 1 else c.clone()
            for c in r.chunk(w, dim=dim)][lo:lo + n_local]


def rank(mesh, axis: str, position: int) -> int:
    """Flat `position`'s index along `axis` (lax.axis_index inside
    shard_map; the port's per-position programs are loops over flat
    positions of a Mesh's row-major grid)."""
    m = mesh if isinstance(mesh, Mesh) else Mesh(mesh, device="cpu")
    return m.coords(position).get(axis, 0)


def world_size(mesh, axis: str) -> int:
    """The size of `axis` in `mesh` (1 for an axis it lacks)."""
    return axis_size(mesh, axis)

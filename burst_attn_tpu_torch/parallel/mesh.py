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

Process axes (`Mesh(shape, process_axes=("dp",))`, utils/multihost.py
`make_hybrid_mesh`): the mesh's outermost axes may span the processes of
a run, one index a process, as JAX's process-major device order lays out
the leading axes; every other axis stays positions on this process's
device, and the per-position loops run over this process's positions
only (`ring_positions`, `local_size`).  Only "dp" and the double ring's
"inter" may span processes; anything else (tp, ep, pp or sp across
processes, an axis split between processes) raises NotImplementedError
naming ROADMAP A7b.  A `ppermute` over a process axis sends each local
position's payload to the process `hops` ahead (parallel/collectives.py
`ProcessTransport`: gloo, CUDA payloads staged through pinned host
buffers) and comes in two halves, `ppermute_start` and the handle's
`wait()`, so that the ring can post the inter hop one intra cycle early.
The four collectives over a process axis (their `mesh=` argument) gather
every position's part from every process, then run the one-process code
on the whole position-ordered list: sums keep position order and the
parts' dtype, so a run across processes equals the one-process run bit
for bit.

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
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .ring import ring_coords

# the axes that may span processes in this slice (ROADMAP A7b: the rest)
PROCESS_AXES = ("dp", "inter")


def process_axes_for(shape: Dict[str, int], n_procs: int) -> Tuple[str, ...]:
    """The leading axes of `shape` ({axis: size}, in mesh order) that
    span `n_procs` processes, one index a process (JAX's process-major
    device order): the shortest prefix whose sizes multiply to n_procs.
    An axis split between processes (no prefix multiplies to it exactly)
    raises NotImplementedError naming ROADMAP A7b."""
    if n_procs == 1:
        return ()
    prod, names = 1, []
    for a, n in shape.items():
        if prod == n_procs:
            break
        if prod * n > n_procs or n_procs % (prod * n):
            raise NotImplementedError(
                f"mesh axis {a!r} of size {n} split between {n_procs} "
                f"processes: each axis that spans processes must hold one "
                "index a process (ROADMAP A7b)")
        prod *= n
        names.append(a)
    if prod != n_procs:
        raise ValueError(f"mesh {shape} holds {prod} processes, the run "
                         f"has {n_procs}")
    return tuple(names)


class Mesh:
    """Named axis sizes {axis: size} on one device (default: the card).
    `process_axes`: the outermost axes that span the processes of the run
    (one index a process; the group must be up, utils/multihost.py), each
    of PROCESS_AXES; this process holds the positions at its coordinates
    on them (`process_coords`).  `sub(shape)` derives
    the mesh a part of the program runs on (a dp group's, a ring's)."""

    def __init__(self, shape: Dict[str, int], device=None,
                 process_axes: Sequence[str] = ()):
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        bad = {a: n for a, n in self.shape.items() if n < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be >= 1, got {bad}")
        self.device = resolve_device(device)
        self.process_axes = tuple(process_axes)
        self.process_coords: Dict[str, int] = {}
        self.process_index = 0
        self.transport = None
        # the rank at each coordinate of the process axes
        self._ranks = np.zeros((), dtype=np.int64)
        if self.process_axes:
            self._init_processes()

    def _init_processes(self) -> None:
        axes = self.process_axes
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"process axes {unknown} are not axes of the "
                             f"mesh {self.shape}")
        gated = [a for a in axes if a not in PROCESS_AXES]
        if gated:
            raise NotImplementedError(
                f"mesh axes {gated} across processes: only "
                f"{PROCESS_AXES} may span processes (ROADMAP A7b)")
        self._check_outermost()
        import torch.distributed as dist

        from .collectives import ProcessTransport

        sizes = tuple(self.shape[a] for a in axes)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(sizes) != world:
            raise ValueError(f"process axes {axes} of {self.shape} hold "
                             f"{math.prod(sizes)} processes, the run has "
                             f"{world} processes")
        self.process_index = dist.get_rank()
        self._ranks = np.arange(world).reshape(sizes)
        coords = np.unravel_index(self.process_index, sizes)
        self.process_coords = {a: int(c) for a, c in zip(axes, coords)}
        self.transport = ProcessTransport()

    def _check_outermost(self) -> None:
        # axes of size 1 hold no positions: their place is free
        names = tuple(a for a, n in self.shape.items()
                      if n > 1 or a in self.process_axes)
        if self.process_axes != names[:len(self.process_axes)]:
            raise NotImplementedError(
                f"process axes {self.process_axes} must be the mesh's "
                f"outermost axes, in its order {names} (ROADMAP A7b)")

    def __repr__(self):
        procs = (f", process_axes={self.process_axes}"
                 if self.process_axes else "")
        return f"Mesh({self.shape}, device={self.device}{procs})"

    def sub(self, shape: Dict[str, int]) -> "Mesh":
        """The mesh of `shape` ({axis: size}) as a part of this one: a
        process axis it keeps at its size still spans the processes, one
        it drops or sets to 1 is fixed at this process's coordinate (a dp
        group's mesh, a ring's); every other axis is local.  Shares the
        transport."""
        shape = {str(a): int(n) for a, n in shape.items()}
        m = Mesh.__new__(Mesh)
        m.shape, m.device = shape, self.device
        m.process_axes = tuple(a for a in self.process_axes
                               if shape.get(a) == self.shape[a])
        m.process_coords = {a: self.process_coords[a]
                            for a in m.process_axes}
        m.process_index = self.process_index
        m._ranks = self._ranks[tuple(
            slice(None) if a in m.process_axes else self.process_coords[a]
            for a in self.process_axes)]
        m.transport = self.transport if m.process_axes else None
        m._check_outermost()
        return m

    def local_size(self, axis) -> int:
        """The positions of `axis` this process holds: 1 on a process
        axis, its size otherwise (1 for an axis the mesh lacks)."""
        if axis in self.process_axes:
            return 1
        return self.shape.get(axis, 1) if axis is not None else 1

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of the processes along process axis `axis` that share
        this process's coordinates on the other process axes, in the
        axis's index order."""
        idx = tuple(slice(None) if a == axis else self.process_coords[a]
                    for a in self.process_axes)
        return [int(r) for r in self._ranks[idx]]

    def ring_procs(self, seq_axes) -> Optional["ProcRing"]:
        """The process ring of a ring over `seq_axes`: None when every
        ring position is local, else the inter axis's processes (a double
        ring whose inter axis spans processes); a single ring or an intra
        axis across processes raises NotImplementedError (ROADMAP A7b)."""
        seq_axes = _names(seq_axes)
        across = [a for a in seq_axes if a in self.process_axes]
        if not across:
            return None
        if len(seq_axes) != 2 or across != [seq_axes[0]]:
            raise NotImplementedError(
                f"ring axes {across} of {seq_axes} across processes: only "
                "a double ring's inter axis may span processes (ROADMAP "
                "A7b)")
        a = seq_axes[0]
        return ProcRing(self.process_coords[a], tuple(self.axis_ranks(a)),
                        self.transport)

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
    """The processes of a double ring's inter axis: this process's inter
    index, the rank of each inter index, and the transport between them.
    Its positions are the n_intra positions of inter row `index`."""

    index: int
    ranks: Tuple[int, ...]
    transport: object

    def peers(self, hops: int) -> Tuple[int, int]:
        """(rank `hops` ahead, rank `hops` behind) on the inter ring."""
        n = len(self.ranks)
        return (self.ranks[(self.index + hops) % n],
                self.ranks[(self.index - hops) % n])


def ring_positions(n_inter: int, n_intra: int,
                   procs: Optional[ProcRing] = None) -> List[int]:
    """The flat ring positions a process holds: all of them, or with
    `procs` the n_intra positions of its inter row."""
    if procs is None:
        return list(range(n_inter * n_intra))
    return [procs.index * n_intra + si for si in range(n_intra)]


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
    spans processes, else the dict itself."""
    if isinstance(mesh, Mesh) and mesh.process_axes:
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
    """A process hop in flight: wait() regroups the arrival into the
    payload tuples of the local positions."""

    def __init__(self, exchange, sizes):
        self._x, self._sizes = exchange, sizes

    def wait(self):
        flat, out, i = self._x.wait(), [], 0
        for n in self._sizes:
            out.append(tuple(flat[i:i + n]))
            i += n
        return out


def ppermute_start(parts: Sequence[Tuple[torch.Tensor, ...]], axis: str,
                   n_inter: int, n_intra: int, hops: int = 1,
                   cls: str = "pay", procs: Optional[ProcRing] = None):
    """Start `ppermute`; returns a handle whose `wait()` gives the
    rotated payloads.  Local copies are made here; an inter hop across
    processes (`procs`) is posted here (the local positions' payloads
    staged and sent to the process `hops` ahead, the arrival from the one
    `hops` behind received) and waited for by the handle."""
    if axis not in ("intra", "inter"):
        raise ValueError(f"axis must be 'intra' or 'inter', got {axis!r}")
    n_axis = n_intra if axis == "intra" else n_inter
    if procs is not None:
        # the parts are this process's inter row, in intra order
        record_permutation(cls, axis, {(i, (i + hops) % n_axis)
                                       for i in range(n_axis)}, n_axis)
        if axis == "intra":
            return _Done([tuple(t.clone() for t in parts[(si - hops)
                                                         % n_intra])
                          for si in range(n_intra)])
        send_to, recv_from = procs.peers(hops)
        flat = [t for pay in parts for t in pay]
        return _Arriving(procs.transport.exchange_start(
            flat, send_to, recv_from, tag=_tag(cls)),
            [len(pay) for pay in parts])
    out, srcs = [], []
    for p in range(n_inter * n_intra):
        ii, si = ring_coords(p, n_inter, n_intra)
        if axis == "intra":
            src = ii * n_intra + (si - hops) % n_intra
        else:
            src = ((ii - hops) % n_inter) * n_intra + si
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


def _tag(cls: str) -> int:
    from .collectives import TAGS

    return TAGS.get(cls, 0)


def ppermute(parts: Sequence[Tuple[torch.Tensor, ...]], axis: str,
             n_inter: int, n_intra: int, hops: int = 1, cls: str = "pay",
             procs: Optional[ProcRing] = None
             ) -> List[Tuple[torch.Tensor, ...]]:
    """Rotate every position's payload (a tuple of tensors) `hops`
    positions forward along the ring's "intra" or "inter" axis: position
    p receives a COPY of the payload of the position `hops` behind it.
    `cls` names the stream for the recorder ("pay" or "dq").  With
    `procs` the parts are this process's positions (its inter row) and an
    inter hop crosses processes (ppermute_start, then its wait)."""
    return ppermute_start(parts, axis, n_inter, n_intra, hops, cls,
                          procs).wait()


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, axis: Optional[str] = None
               ) -> List[torch.Tensor]:
    """The tiled all-to-all of W positions (lax.all_to_all(x, axis,
    split_axis=split_dim, concat_axis=concat_dim, tiled=True) inside
    shard_map): each position's tensor splits into W equal chunks along
    `split_dim`, and position p receives chunk p of every peer,
    concatenated along `concat_dim` in peer order.  The result is a
    fresh COPY per position (torch.cat), so the bytes the exchange
    moves are moved; differentiable through autograd (the transpose of
    an all-to-all is the all-to-all back).  `axis` names the mesh axis
    for the recorder."""
    w = len(parts)
    for t in parts:
        if t.shape[split_dim] % w:
            raise ValueError(f"dim {split_dim} of length "
                             f"{t.shape[split_dim]} does not divide by the "
                             f"{w} positions of the all-to-all")
    if _RECORDER is not None:
        _RECORDER.append(("a2a", axis, None))
    chunks = [t.chunk(w, dim=split_dim) for t in parts]
    return [torch.cat([chunks[q][p] for q in range(w)], dim=concat_dim)
            for p in range(w)]


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


def _gathered(parts: Sequence[torch.Tensor], axis: Optional[str], mesh
              ) -> Tuple[List[torch.Tensor], int]:
    """(every position's part in position order, the index of this
    process's first part in it): over a process axis of `mesh`, gathered
    from the processes along it (ProcessTransport.all_gather); else the
    parts themselves."""
    if not isinstance(mesh, Mesh) or axis not in mesh.process_axes:
        return list(parts), 0
    got = mesh.transport.all_gather(list(parts), mesh.axis_ranks(axis))
    return [t for part in got for t in part], \
        mesh.process_coords[axis] * len(parts)


def all_reduce(parts: Sequence[torch.Tensor], op: str = "sum",
               axis: Optional[str] = None, mesh=None) -> List[torch.Tensor]:
    """lax.psum / pmean / pmax / pmin over W positions: every position
    receives its own copy of the reduction of all W parts (in the parts'
    dtype, summed in position order).  Differentiable (sum and mean: each
    part's gradient is the sum of the results' gradients, the all-reduce
    again).  `axis` names the mesh axis for the recorder; when it is a
    process axis of `mesh`, the parts are this process's positions and
    the others' are gathered first (host code: no autograd across
    processes)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    _record("all_reduce", axis)
    n_local = len(parts)
    parts, _ = _gathered(parts, axis, mesh)
    if op in ("sum", "mean"):
        r = parts[0]
        for t in parts[1:]:
            r = r + t
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
    r = parts[0]
    for t in parts[1:]:
        r = r + t
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

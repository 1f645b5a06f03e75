"""A device mesh for the port's sequence ring: named axis sizes on ONE
device (the counterpart of jax.sharding.Mesh plus shard_map and the
ring's collectives, burst_attn_tpu/parallel/collectives.py).

`Mesh({"sp": W})` or `Mesh({"inter": a, "intra": b})` holds W ring
positions that share one device: each position keeps its own shard of
the sequence, every position runs the same per-position program, and the
ring's rotation is `ppermute`, which COPIES each position's payload into
a fresh buffer of its receiver — the bytes a ring has to move are moved.
`all_to_all` is the exchange of Ulysses attention (parallel/ulysses.py)
and of expert parallelism (parallel/moe.py), with the same copy
semantics.  Axes other than the sequence axes must have size 1 (data and
tensor parallelism are not ported yet).  A pipeline's `pp` axis holds
stages, not ring positions (parallel/pipeline.py): each stage's ring sees
only its sequence axes (`seq_mesh`), so the ring never counts pp as an
extra axis.  The multi-process communicator of a ring across cards comes
with a later slice.

`record_collectives()` is the analyzer's recorder (analysis/
ringcheck.py): while it is active, every `ppermute` appends (cls, axis,
hops) — the rotation offset derived from the copies it actually made,
None if they were not a uniform rotation — and every `all_to_all`
appends ("a2a", axis, None).  The class is the call site's ("pay" for a
payload rotation, "dq" for the backward's dq ring).  Off, it costs each
collective one `None` check.
"""

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device
from .ring import ring_coords


class Mesh:
    """Named axis sizes {axis: size} on one device (default: the card)."""

    def __init__(self, shape: Dict[str, int], device=None):
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        bad = {a: n for a, n in self.shape.items() if n < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be >= 1, got {bad}")
        self.device = resolve_device(device)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    def size(self, axes) -> int:
        """Product of the sizes of `axes` (a name, a sequence of names or
        None); an axis the mesh lacks has size 1."""
        n = 1
        for a in _names(axes):
            n *= self.shape.get(a, 1)
        return n

    def ring(self, seq_axes) -> Tuple[int, int]:
        """(n_inter, n_intra) of the ring over `seq_axes` (one name: a flat
        ring; two names: (inter, intra)), after checking that no other
        axis of size > 1 rides along."""
        seq_axes = _names(seq_axes)
        if len(seq_axes) not in (1, 2):
            raise ValueError(f"seq_axes must have 1 or 2 names, got "
                             f"{seq_axes}")
        extra = {a: n for a, n in self.shape.items()
                 if a not in seq_axes and n > 1}
        if extra:
            raise NotImplementedError(
                f"mesh axes {extra} besides the sequence axes {seq_axes}: "
                "data and tensor parallelism are not ported yet")
        if len(seq_axes) == 1:
            return 1, self.size(seq_axes)
        return self.size(seq_axes[0]), self.size(seq_axes[1])


def as_mesh(mesh: Union[Mesh, Dict[str, int]], device) -> Mesh:
    """`mesh` as a Mesh; a plain {axis: size} dict takes `device` (the
    device of the tensors it will shard)."""
    if isinstance(mesh, Mesh):
        if mesh.device != torch.device(device):
            raise ValueError(f"tensors on {device} but the mesh is on "
                             f"{mesh.device}")
        return mesh
    return Mesh(mesh, device=device)


def seq_mesh(mesh, seq_axes) -> Dict[str, int]:
    """What one pipeline stage's ring sees of `mesh` ({axis: size} or a
    Mesh): its sequence axes alone, {axis: size}."""
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    return {a: int(shape[a]) for a in _names(seq_axes) if a in shape}


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


def ppermute(parts: Sequence[Tuple[torch.Tensor, ...]], axis: str,
             n_inter: int, n_intra: int, hops: int = 1, cls: str = "pay"
             ) -> List[Tuple[torch.Tensor, ...]]:
    """Rotate every position's payload (a tuple of tensors) `hops`
    positions forward along the ring's "intra" or "inter" axis: position
    p receives a COPY of the payload of the position `hops` behind it.
    `cls` names the stream for the recorder ("pay" or "dq")."""
    if axis not in ("intra", "inter"):
        raise ValueError(f"axis must be 'intra' or 'inter', got {axis!r}")
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
        record_permutation(cls, axis, moves,
                           n_intra if axis == "intra" else n_inter)
    return out


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

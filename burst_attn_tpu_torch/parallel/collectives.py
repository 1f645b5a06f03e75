"""Host helpers across processes and the process transport (the host half
of burst_attn_tpu/parallel/collectives.py; its in-program collectives
are parallel/mesh.py's `all_reduce`, `broadcast`, `all_gather` and
`reduce_scatter`).

`synchronize()` is a barrier across the processes of a run (after this
process's device work has finished), `gather_obj(obj)` gathers a
picklable object from every process in rank order; in one process they
wait for the device and return `[obj]`.  A barrier behind work of
unbounded length (the primary's checkpoint write) runs on a group of its
own, `wait_group(timeout_s)`, instead of the run's group, whose waits
end after utils/multihost.GROUP_TIMEOUT_S.

`ProcessTransport` moves bytes between the processes of a mesh laid
over them (parallel/mesh.py `Mesh(process_axes="auto")`): gloo
point-to-point for a ring hop or an all-to-all (`exchange_start` posts
one send a peer and one receive a peer, to and from any number of peers,
in one `batch_isend_irecv`, and returns a handle whose `wait()` gives the
arrivals by peer) and gloo's `all_gather` for the collectives.  Each
stream has its own tag (TAGS: a ring's payload and dq hops on each of
its axes, the all-to-all's), so that hops of two streams between the
same two processes may be in flight together.
gloo reads and writes host memory, so a CUDA payload is STAGED: its
tensors are copied into one pinned host buffer, with a sync on that copy
alone before the send is posted, and an arrival is copied back to the
device on the current stream.  The buffers are kept by size and reused
across calls (`stats["allocs"]` counts new ones); a received buffer is
written again only after its copy to the device finished.  `stats`
holds the host seconds spent staging and waiting for arrivals, the
waits also by tag (a ring's prefetched payload hops apart from its dq
hops).

NCCL (a card a process) is ROADMAP A7b: two processes that share one
card cannot form an NCCL group.
"""

import datetime
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# send / receive tags of the ring's streams, (class, axis) -> tag: a
# payload hop and a dq hop between the same two processes, on either
# axis, may be in flight together; and the all-to-all's
TAGS = {("pay", "inter"): 1, ("dq", "inter"): 2, ("pay", "intra"): 3,
        ("dq", "intra"): 4}
A2A_TAG = 9


def _group_up() -> bool:
    """Whether a torch.distributed process group is up in this process."""
    return dist.is_available() and dist.is_initialized()


# wait_group's groups by length: (the run's group they belong to, group)
_WAIT_GROUPS: Dict[float, tuple] = {}


def synchronize(group=None) -> None:
    """Barrier across processes (reference comm.synchronize): this
    process's queued device work finishes first; with no process group,
    only that.  `group`: a wait_group to wait on instead of the run's
    group."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if _group_up() and dist.get_world_size() > 1:
        dist.barrier(group=group)


def wait_group(timeout_s: float):
    """A gloo group of every process of the run whose waits end after
    `timeout_s` (the run's group's after multihost.GROUP_TIMEOUT_S), for
    synchronize(group=) behind work that may take longer, such as the
    primary's checkpoint write.  Every process calls it at the same point
    of the program and before that work (dist.new_group is a collective
    of the run's group); made once per length and process group.  None
    in one process."""
    if not _group_up() or dist.get_world_size() == 1:
        return None
    world = dist.group.WORLD
    got = _WAIT_GROUPS.get(timeout_s)
    if got is None or got[0] is not world:
        got = (world, dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s)))
        _WAIT_GROUPS[timeout_s] = got
    return got[1]


def gather_obj(obj) -> list:
    """Gather a picklable object from every process to all processes, in
    rank order (reference comm.gather_obj); `[obj]` in one process."""
    if not _group_up() or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """`t`'s bytes as a 1-d uint8 view (a contiguous copy first if it is
    not contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class _Buffer:
    """A host byte buffer; `ready` is the event after which its last copy
    to the device has read it (None: nothing pending)."""

    def __init__(self, nbytes: int, pinned: bool):
        self.data = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=pinned)
        self.pinned = pinned
        self.ready: Optional[torch.cuda.Event] = None

    def writable(self) -> torch.Tensor:
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return self.data


class _Layout:
    """The tensors packed into a buffer: their shapes, dtypes and byte
    offsets."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.specs, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            self.specs.append((tuple(t.shape), t.dtype, off, n))
            off += n
        self.nbytes = off


class ProcessTransport:
    """gloo between this process and its peers, with the staging of CUDA
    payloads through pinned host buffers kept by size.  One per mesh
    (parallel/mesh.py); host code only, never inside a captured graph."""

    def __init__(self):
        self._free: Dict[Tuple[int, bool], List[_Buffer]] = {}
        self.stats = {}
        self.reset_stats()
        # sends posted and not waited for yet (a pipeline's stage hops)
        self.pending: List["Exchange"] = []

    def drain(self) -> None:
        """Wait for every send in `pending`."""
        while self.pending:
            self.pending.pop(0).wait()

    def reset_stats(self) -> None:
        """Zero the counters: hops and gathers made, bytes sent, buffers
        allocated, host seconds spent staging (to and from the device)
        and waiting for arrivals (and {tag: [waits, seconds]}, "gather"
        for the gathers)."""
        self.stats = dict(hops=0, gathers=0, bytes=0, allocs=0,
                          stage_s=0.0, wait_s=0.0, waits_by_tag={})

    def _take(self, nbytes: int, pinned: bool) -> _Buffer:
        free = self._free.setdefault((nbytes, pinned), [])
        if free:
            return free.pop()
        self.stats["allocs"] += 1
        return _Buffer(nbytes, pinned)

    def _give(self, buf: _Buffer) -> None:
        self._free[(buf.data.numel(), buf.pinned)].append(buf)

    def stage(self, tensors: Sequence[torch.Tensor]):
        """Pack `tensors` into one host buffer (pinned when they are on
        the card): (buffer, layout).  A CUDA payload's copies are waited
        for here (an event after them, on the current stream), so gloo's
        threads never read a buffer the device is still writing."""
        t0 = time.perf_counter()
        lay = _Layout(tensors)
        cuda = any(t.is_cuda for t in tensors)
        buf = self._take(lay.nbytes, cuda)
        data = buf.writable()
        for t, (_, _, off, n) in zip(tensors, lay.specs):
            data[off:off + n].copy_(_flat_bytes(t.detach()),
                                    non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        self.stats["stage_s"] += time.perf_counter() - t0
        return buf, lay

    def unstage(self, buf: _Buffer, lay: _Layout,
                device) -> List[torch.Tensor]:
        """The tensors packed in `buf`, as fresh tensors on `device` (the
        copy to a card is queued on the current stream; the buffer is
        marked busy until it has run)."""
        t0 = time.perf_counter()
        device = torch.device(device)
        out = []
        for shape, dtype, off, n in lay.specs:
            t = torch.empty(shape, dtype=dtype, device=device)
            _flat_bytes(t).copy_(buf.data[off:off + n],
                                 non_blocking=device.type == "cuda")
            out.append(t)
        if device.type == "cuda":
            buf.ready = torch.cuda.Event()
            buf.ready.record()
        self.stats["stage_s"] += time.perf_counter() - t0
        return out

    def exchange_start(self, send: Dict[int, Sequence[torch.Tensor]],
                       recv: Dict[int, Sequence[torch.Tensor]],
                       tag: int = 0) -> "Exchange":
        """Post the send of `send[peer]`'s tensors (one staged buffer a
        peer) to each peer, and the receive from each peer of `recv`
        tensors of the layout of `recv[peer]` (shape and dtype templates);
        returns the handle whose wait() gives {peer: arrival}."""
        device = next(t for ts in (*send.values(), *recv.values())
                      for t in ts).device
        ops, bufs, rbufs = [], [], {}
        for peer, tensors in send.items():
            buf, lay = self.stage(tensors)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.isend, buf.data, peer, tag=tag))
            self.stats["bytes"] += lay.nbytes
        for peer, like in recv.items():
            lay = _Layout(like)
            rbuf = self._take(lay.nbytes, device.type == "cuda")
            rbuf.writable()
            rbufs[peer] = (rbuf, lay)
            ops.append(dist.P2POp(dist.irecv, rbuf.data, peer, tag=tag))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        self.stats["hops"] += 1
        return Exchange(self, reqs, bufs, rbufs, device, tag)

    def all_gather(self, tensors: Sequence[torch.Tensor],
                   ranks: Sequence[int]) -> List[List[torch.Tensor]]:
        """Every process's `tensors` (the same layout on each), as lists in
        the order of `ranks`, on this process's device: gloo's all_gather
        of the staged buffers over the whole group (every process of the
        run calls it, as every position issues a collective), then the
        buffers of `ranks` copied back."""
        device = tensors[0].device
        buf, lay = self.stage(tensors)
        world = dist.get_world_size()
        outs = [self._take(lay.nbytes, buf.pinned) for _ in range(world)]
        t0 = time.perf_counter()
        dist.all_gather([o.writable() for o in outs], buf.data)
        self._note_wait(time.perf_counter() - t0, "gather")
        self.stats["gathers"] += 1
        self.stats["bytes"] += lay.nbytes
        got = [self.unstage(outs[r], lay, device) for r in ranks]
        for b in outs + [buf]:
            self._give(b)
        return got

    def _note_wait(self, dt: float, tag) -> None:
        self.stats["wait_s"] += dt
        n_s = self.stats["waits_by_tag"].setdefault(tag, [0, 0.0])
        n_s[0] += 1
        n_s[1] += dt


class Exchange:
    """An exchange in flight (ProcessTransport.exchange_start)."""

    def __init__(self, transport, reqs, bufs, rbufs, device, tag):
        self._t, self._reqs, self._tag = transport, reqs, tag
        self._bufs, self._rbufs, self._device = bufs, rbufs, device

    def wait(self) -> Dict[int, List[torch.Tensor]]:
        """Block until the sends and the receives are done; {peer: the
        arrival's tensors on the payload's device}."""
        t0 = time.perf_counter()
        for r in self._reqs:
            r.wait()
        self._t._note_wait(time.perf_counter() - t0, self._tag)
        out = {peer: self._t.unstage(buf, lay, self._device)
               for peer, (buf, lay) in self._rbufs.items()}
        for buf in self._bufs + [b for b, _ in self._rbufs.values()]:
            self._t._give(buf)
        return out

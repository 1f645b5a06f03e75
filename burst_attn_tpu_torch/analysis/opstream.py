"""The op stream of a real call, on the CPU or the card: the port's
counterpart of the JAX package's analysis/jaxpr_tools.py (`make_jaxpr` +
`iter_eqns`).

JAX traces a program and the rules walk its equations.  The port has no
trace: `record()` runs the real function under a TorchDispatchMode and
keeps one `OpEvent` per aten op it dispatches, in order, with

  * the op's name and its inputs' and outputs' dtypes, shapes, devices;
  * `host_read`: the op hands a tensor's values to the host — an
    `aten._local_scalar_dense` (`.item()`, `int(t)`, `bool(t)`), or a
    `Tensor.tolist()` / `Tensor.numpy()` (those read a CPU tensor without
    dispatching an op, so the recorder wraps them while it runs);
  * `data_dependent`: the output's shape depends on the data (`nonzero`,
    `masked_select`, `unique`, boolean indexing), which on the card waits
    for the device;
  * `cross_device`: a copy between two devices (`_to_copy`, `copy_`).

The collectives of parallel/mesh.py (its `record_collectives` stream)
enter the same list as events of their own (`collective` set, op
"collective.<cls>"), so an op event and a collective event compare in
issue order.  The kernel launches through ctypes (ops/_build.py) dispatch
no aten op and are not seen: the wrappers' launch counters stand for
them.  Recording costs a Python call per op; it is for the analyzer and
the tests, never for a served request.
"""

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..parallel import mesh as _mesh

HOST_READ_OPS = frozenset({"aten._local_scalar_dense"})
DATA_DEPENDENT_OPS = frozenset({
    "aten.nonzero", "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.masked_scatter"})
COPY_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten.copy"})
# the matmul family: einsum and linear lower to these
MATMUL_OPS = frozenset({"aten.mm", "aten.bmm", "aten.baddbmm", "aten.addmm",
                        "aten.addbmm", "aten.matmul", "aten.dot",
                        "aten.mv", "aten.addmv"})
LOW_FLOATS = (torch.bfloat16, torch.float16)

Meta = Tuple[torch.dtype, Tuple[int, ...], str]


@dataclass(frozen=True)
class OpEvent:
    op: str                # "aten.mm", "tensor.tolist", "collective.pay"
    overload: str = ""
    inputs: Tuple[Meta, ...] = ()
    outputs: Tuple[Meta, ...] = ()
    consts: Tuple = ()            # the non-tensor arguments (scalars, dims)
    host_read: bool = False
    data_dependent: bool = False
    cross_device: bool = False
    collective: Optional[Tuple] = None   # parallel/mesh.py's (cls, axis, hops)

    def signature(self) -> Tuple:
        """What two streams compare: the op and every operand's dtype,
        shape and device, its non-tensor arguments (the collective's
        record for a collective)."""
        return (self.op, self.overload, self.inputs, self.outputs,
                self.consts, self.collective)

    def format(self) -> str:
        ins = ", ".join(f"{str(d).replace('torch.', '')}{list(s)}"
                        for d, s, _ in self.inputs)
        outs = ", ".join(f"{str(d).replace('torch.', '')}{list(s)}"
                         for d, s, _ in self.outputs)
        consts = "".join(f", {c}" for c in self.consts)
        return f"{self.op}({ins}{consts}) -> ({outs})"


class OpStream(list):
    """The recorded events, in issue order."""

    def host_reads(self) -> List[OpEvent]:
        return [e for e in self if e.host_read]

    def data_dependent(self) -> List[OpEvent]:
        return [e for e in self if e.data_dependent]

    def cross_device(self) -> List[OpEvent]:
        return [e for e in self if e.cross_device]

    def collectives(self) -> List[OpEvent]:
        return [e for e in self if e.collective is not None]

    def signatures(self) -> List[Tuple]:
        return [e.signature() for e in self]


def _metas(tree) -> Tuple[Meta, ...]:
    leaves, _ = tree_flatten(tree)
    return tuple((t.dtype, tuple(t.shape), t.device.type)
                 for t in leaves if isinstance(t, torch.Tensor))


_CONST_TYPES = (bool, int, float, str, type(None), torch.dtype,
                torch.device, torch.layout, torch.memory_format)


def _consts(tree) -> Tuple:
    """The non-tensor leaves, by value where that is stable across runs
    (scalars, dtypes, devices; a float by its repr, so NaN equals NaN),
    else by type (a generator, a callable)."""
    leaves, _ = tree_flatten(tree)
    return tuple(repr(x) if isinstance(x, float) else
                 x if isinstance(x, _CONST_TYPES) else type(x).__name__
                 for x in leaves if not isinstance(x, torch.Tensor))


def _has_bool_index(args) -> bool:
    leaves, _ = tree_flatten(list(args[1:2]))
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in leaves)


def _event(func, args, kwargs, out) -> OpEvent:
    name = func.overloadpacket._qualified_op_name.replace("::", ".")
    ins, outs = _metas((args, kwargs)), _metas(out)
    data_dep = name in DATA_DEPENDENT_OPS or (
        name in ("aten.index", "aten.index_put", "aten.index_put_")
        and _has_bool_index(args))
    cross = False
    if name in COPY_OPS:
        devs = {m[2] for m in ins[:2] + outs}
        cross = len(devs) > 1
    return OpEvent(op=name, overload=func._overloadname, inputs=ins,
                   outputs=outs, consts=_consts((args, kwargs)),
                   host_read=name in HOST_READ_OPS, data_dependent=data_dep,
                   cross_device=cross)


class _Recorder(TorchDispatchMode):
    def __init__(self, stream: OpStream):
        super().__init__()
        self.stream = stream

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.stream.append(_event(func, args, kwargs, out))
        return out


class _Tee(list):
    """parallel/mesh.py's collective list, copying each event into the
    op stream as it is appended."""

    def __init__(self, stream: OpStream):
        super().__init__()
        self._stream = stream

    def append(self, ev):
        super().append(ev)
        self._stream.append(OpEvent(op=f"collective.{ev[0]}",
                                    collective=tuple(ev)))


_ACTIVE: List[OpStream] = []
_HOST_METHODS = ("tolist", "numpy")
_ORIGINAL = {}


def _host_method(name):
    real = _ORIGINAL[name]

    def method(self, *args, **kwargs):
        if _ACTIVE:
            _ACTIVE[-1].append(OpEvent(
                op=f"tensor.{name}", inputs=_metas(self), host_read=True,
                cross_device=self.device.type != "cpu"))
        return real(self, *args, **kwargs)

    method.__name__ = name
    return method


@contextlib.contextmanager
def record() -> Iterator[OpStream]:
    """Record the ops (and the mesh collectives) issued inside the block:
    yields the OpStream they are appended to.  Nests: an inner recording
    sees only its own block's events."""
    stream = OpStream()
    if not _ACTIVE:
        for name in _HOST_METHODS:
            _ORIGINAL[name] = getattr(torch.Tensor, name)
            setattr(torch.Tensor, name, _host_method(name))
    _ACTIVE.append(stream)
    prev = _mesh._RECORDER
    _mesh._RECORDER = _Tee(stream)
    try:
        with _Recorder(stream):
            yield stream
    finally:
        _mesh._RECORDER = prev
        _ACTIVE.pop()
        if not _ACTIVE:
            for name in _HOST_METHODS:
                setattr(torch.Tensor, name, _ORIGINAL.pop(name))


def record_call(fn, *args, **kwargs) -> Tuple[object, OpStream]:
    """(fn(*args, **kwargs), the stream it recorded)."""
    with record() as stream:
        out = fn(*args, **kwargs)
    return out, stream


def first_divergence(a: List[Tuple], b: List[Tuple]) -> Optional[int]:
    """Index of the first differing signature of two streams (the
    shorter's length when one is a prefix of the other), None if equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))

"""Pure protocol state machines (port of burst_attn_tpu/protocols): each
module holds ONE production protocol as a pure

    step(state, event) -> (state, outputs)

transition function over immutable (hashable) state, and the production
class DELEGATES its decisions to it: `serving/checkpoint.TokenJournal`
runs `journal.step` in lockstep with its file.  The machines are plain
Python; the port keeps its own copy, so it needs nothing of the JAX
package.

Conventions: state is a NamedTuple of plain hashable values; events are
tuples `(kind, *args)`; a transition raises the same exception types with
the same messages production raises; `("crash",)` is defined where a
process death has protocol-visible semantics.

Modules:

  pool        PagePool refcount/free-list algebra + the CoW write barrier
  journal     write-ahead token journal (append/sync/deliver/crash)
  transport   frame parse (CRC/torn-tail) + (rid, seq) dedup
  kvtransfer  transactional KV page transfer (stage/commit/abort + the
              sender's hold-until-ack plan)
"""


class ProtocolError(Exception):
    """Base for machine-raised protocol violations (each machine also
    derives from the builtin type production raises, so delegating call
    sites keep their `except` behavior)."""


# the submodules import ProtocolError from the package, so it must exist first
from . import journal, kvtransfer, pool, transport  # noqa: E402,F401

"""Disaggregated prefill/decode serving fleet (port of
burst_attn_tpu/fleet).

Five modules, bottom up:

  transport.py  one wire protocol — length-prefixed, CRC-framed msgpack
                (JSON fallback) — with two carriers: multiprocessing
                queues (in-process clusters, loadgen/) and TCP sockets
                (cross-host fleets).  Torn-final-frame tolerant on the
                receive side exactly like checkpoint.read_journal.
  kvplane.py    the KV transfer plane: a handoff slot's pool pages
                serialized per-page in table order, staged on the
                receiver, and committed transactionally (all pages land
                CRC-clean or zero pool mutation).
  policy.py     the pure routing / admission / preemption / autoscale
                decisions the router takes.
  fleet.py      the role-split fleet: a ring-prefill worker pool and a
                paged-decode replica pool behind one router, with
                cross-boundary failover (heartbeats, journaled resume,
                snapshot restarts) and load-aware routing + autoscaling.
  sim.py        the discrete-event simulator of a fleet, on the same
                policy functions, priced by the cost model
                (analysis/costmodel.py) or by rates calibrated from a
                fleet run (imported on its own: `fleet.sim`).
"""

from .transport import (  # noqa: F401
    Dedup, FrameBuffer, FrameError, QueueTransport, SendTimeout,
    SocketTransport, TransportClosed, TransportError, decode_message,
    encode_message, pack_frame, scan_frames, send_with_retry, unpack_frame,
)
from .kvplane import (  # noqa: F401
    KvReceiver, export_slot_pages, page_bytes, page_digest,
)
from .fleet import (  # noqa: F401
    FLEET_FAULT_KINDS, FleetCluster, FleetFault, FleetReport, fleet_oracle,
)

"""The frame-transport machine (port of
burst_attn_tpu/protocols/transport.py): incremental parse + dedup, pure.

Extracts `fleet/transport.FrameBuffer` (the live receive path) and
`Dedup` into transition functions.  `FrameBuffer.feed`/`eof` delegate
here byte-for-byte: the pure parser owns the CRC-reject / lost-sync /
torn-tail policy and the class only applies the outputs (frame queue +
obs counters).  The frame format is the JAX package's, so a port process
and a JAX process read each other's frames.

Wire state is the unconsumed byte buffer plus the two loss counters;
events:

  ("feed", chunk: bytes)  -> outputs: ("frame", payload) per clean
                             frame, ("crc_reject",) per dropped frame
                             (framing intact, payload mangled), and a
                             final ("desync", msg) when the stream
                             loses sync (bad magic / absurd length) —
                             an OUTPUT, not a raise, so frames parsed
                             earlier in the same chunk still deliver;
                             the bad bytes stay buffered, so every
                             later feed re-reports the desync (exactly
                             FrameBuffer's historical raise-per-feed)
  ("eof",)                -> outputs: ("torn",) if a partial frame was
                             pending (peer died mid-send)

Dedup state is the seen (rid, seq) set; events:

  ("frame", rid, seq)     -> (("accept",),) first time, (("dup",),)
                             on redelivery
  ("forget", rid)         -> ()  a new transfer attempt restarts rid's
                             seq space
"""

import struct
import zlib
from typing import NamedTuple, Tuple

from . import ProtocolError

MAGIC = b"BAF1"
_HEADER = struct.Struct("!4sII")  # magic, payload length, crc32(payload)
MAX_FRAME = 1 << 28  # 256 MiB: a corrupt length field must not OOM us


class WireDesync(ProtocolError):
    """Broken magic or absurd length: the byte stream lost sync and no
    later frame boundary can be trusted.  The machine reports this as a
    ("desync", msg) OUTPUT (so same-chunk frames still deliver);
    `FrameBuffer.feed` turns it into fleet/transport.FrameError with
    the same message."""


class WireState(NamedTuple):
    buf: bytes
    crc_rejected: int
    torn: int


def wire_init() -> WireState:
    return WireState(b"", 0, 0)


def wire_step(st: WireState, event: Tuple) -> Tuple[WireState, Tuple]:
    kind = event[0]
    if kind == "feed":
        buf = st.buf + bytes(event[1])
        rejected = st.crc_rejected
        out = []
        while len(buf) >= _HEADER.size:
            magic, length, crc = _HEADER.unpack_from(buf)
            if magic != MAGIC or length > MAX_FRAME:
                out.append(("desync",
                            f"stream lost sync (magic={bytes(magic)!r}, "
                            f"length={length})"))
                break
            end = _HEADER.size + length
            if len(buf) < end:
                break  # incomplete frame; wait for more bytes
            payload = bytes(buf[_HEADER.size:end])
            buf = buf[end:]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                rejected += 1
                out.append(("crc_reject",))
                continue  # drop; sender retry re-ships
            out.append(("frame", payload))
        return WireState(buf, rejected, st.torn), tuple(out)
    if kind == "eof":
        if st.buf:
            return WireState(b"", st.crc_rejected, st.torn + 1), (("torn",),)
        return st, ()
    raise ValueError(f"unknown wire event {event!r}")


class DedupState(NamedTuple):
    seen: frozenset


def dedup_init() -> DedupState:
    return DedupState(frozenset())


def dedup_step(st: DedupState, event: Tuple) -> Tuple[DedupState, Tuple]:
    kind = event[0]
    if kind == "frame":
        key = (event[1], event[2])
        if key in st.seen:
            return st, (("dup",),)
        return DedupState(st.seen | {key}), (("accept",),)
    if kind == "forget":
        rid = event[1]
        return DedupState(frozenset(k for k in st.seen
                                    if k[0] != rid)), ()
    raise ValueError(f"unknown dedup event {event!r}")

"""One wire protocol for the whole serving fleet (port of
burst_attn_tpu/fleet/transport.py; the same frames, byte for byte).

Every router<->worker message — loadgen submits, heartbeat pings, KV
transfer frames — travels as one FRAME:

    MAGIC "BAF1" | length !I | crc32(payload) !I | payload

    payload = 1 codec byte + body
      codec 0x01  msgpack (bin-typed ndarray envelopes; the fast path)
      codec 0x02  JSON with base64 byte envelopes (no-deps fallback —
                  msgpack is never a hard requirement)

Arrays ride as {"__nd__": 1, "dtype", "shape", "data"} envelopes: the
dtype by its numpy / JAX name and the raw bytes.  A numpy array and a
torch tensor of the same values encode to the same bytes, so a frame
from a port process equals the JAX package's frame for the same arrays.
bf16 and fp8 (the port's serving pages) have no numpy dtype without
`ml_dtypes`, which this package never imports: a torch tensor of those
dtypes travels as its raw integer view under the dtype's name
("bfloat16", "float8_e4m3fn"), and such an envelope decodes to a CPU
torch tensor of that dtype, bit for bit.  Every other envelope decodes
to a numpy array, as in the JAX package.  Tuples decode as lists;
message handlers index positionally, so both shapes dispatch the same.

Two carriers implement the same `Transport` surface (`send` / `recv` /
`flush` / `close`):

  QueueTransport   frame bytes on multiprocessing (or queue.Queue)
                   queues — the in-process cluster path.
  SocketTransport  frames over TCP.  `connect()` retries refused/timed
                   out connections on the seeded RetryBackoff; sends
                   carry a timeout (a wedged peer must not wedge the
                   sender); the receive side buffers and reparses, so
                   partial reads are invisible to callers.

Torn-tail contract (mirrors checkpoint.read_journal): a peer that dies
mid-send leaves at most one PARTIAL final frame.  The live receive path
counts it (`torn` on the buffer) and reports clean EOF; the offline
`scan_frames` reader skips a torn/corrupt FINAL frame after >= 1 clean
frame and raises on corruption anywhere else.

A CRC-failed frame with intact framing is DROPPED and counted (the
sender retries; `Dedup` makes redelivery idempotent by (rid, seq));
a broken magic means the stream lost sync and raises FrameError.
"""

import base64
import json
import queue as _queue
import socket
import time
import zlib
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..protocols import transport as _proto_wire

try:  # optional: the JSON codec works without it
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - exercised via force_json paths
    _msgpack = None

# framing constants live with the pure parse machine — ONE definition
# for production, the offline scanner, and the model checker
MAGIC = _proto_wire.MAGIC
_HEADER = _proto_wire._HEADER  # magic, payload length, crc32(payload)
CODEC_MSGPACK = 1
CODEC_JSON = 2
MAX_FRAME = _proto_wire.MAX_FRAME  # a corrupt length must not OOM us

M_FRAMES_SENT = obs.counter(
    "fleet.frames_sent", "transport frames sent")
M_BYTES_SENT = obs.counter(
    "fleet.bytes_sent", "transport bytes sent (incl. headers)")
M_FRAMES_RECV = obs.counter(
    "fleet.frames_recv", "transport frames received CRC-clean")
M_FRAMES_CRC_REJECTED = obs.counter(
    "fleet.frames_crc_rejected", "frames dropped on CRC mismatch")
M_FRAMES_TORN = obs.counter(
    "fleet.frames_torn", "partial final frames from dead peers")
M_PEER_LOSS_SWALLOWED = obs.counter(
    "fleet.peer_loss_swallowed",
    "dead-peer errors absorbed on transport protocol paths (each one is "
    "also logged — silent-by-design must still be countable)")


def _log():
    from ..obs.logs import get_logger

    return get_logger("burst_attn_tpu_torch.fleet.transport")
M_FRAMES_DEDUPED = obs.counter(
    "fleet.frames_deduped", "duplicate (rid, seq) frames dropped")
M_SEND_RETRIES = obs.counter(
    "fleet.send_retries", "retryable send failures retried")


class TransportError(Exception):
    """Base for transport failures; `retryable` says whether a resend
    (same frame, new attempt) can succeed."""

    retryable = False


class FrameError(TransportError):
    """CRC mismatch or framing corruption.  Retryable: the frame is
    dropped on the floor and the sender's retry path re-ships it."""

    retryable = True


class SendTimeout(TransportError):
    retryable = True


class TransportClosed(TransportError):
    pass


# -- codec ------------------------------------------------------------------


# dtypes numpy has no type for (without ml_dtypes): carried as the raw
# integer view of their width, rebuilt as torch tensors
_TORCH_ONLY = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8)}
_TORCH_NAME = {v[0]: k for k, v in _TORCH_ONLY.items()}


def _tensor_envelope(t: torch.Tensor) -> dict:
    """A torch tensor's envelope: the dtype by its numpy / JAX name and
    its bytes, exactly what the same values as a numpy array give."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in _TORCH_NAME:
        name = _TORCH_NAME[t.dtype]
        raw = t.view(_TORCH_ONLY[name][1]).numpy()
    else:
        raw = t.numpy()
        name = str(raw.dtype)
    return {"__nd__": 1, "dtype": name, "shape": list(t.shape),
            "data": raw.tobytes()}


def _nd_envelope(a) -> dict:
    if isinstance(a, torch.Tensor):
        return _tensor_envelope(a)
    return {"__nd__": 1, "dtype": str(a.dtype), "shape": list(a.shape),
            "data": np.ascontiguousarray(a).tobytes()}


def _from_envelope(d: dict):
    data = d["data"]
    if isinstance(data, str):  # JSON codec: base64 text
        data = base64.b64decode(data)
    shape = [int(s) for s in d["shape"]]
    name = str(d["dtype"])
    if name in _TORCH_ONLY:
        dt, _, raw = _TORCH_ONLY[name]
        a = np.frombuffer(data, dtype=raw).reshape(shape).copy()
        return torch.from_numpy(a).view(dt)
    a = np.frombuffer(data, dtype=np.dtype(name))
    return a.reshape(shape).copy()


def host_array(t: torch.Tensor):
    """A tensor on the host as the wire carries it: a numpy array where
    numpy has the dtype, a CPU torch tensor for bf16 / fp8."""
    t = t.detach().to("cpu")
    return t if t.dtype in _TORCH_NAME else t.numpy()


def array_bytes(a) -> bytes:
    """The raw bytes an array (numpy or torch) travels as."""
    return _nd_envelope(a)["data"]


def _msgpack_default(o):
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return _nd_envelope(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(f"cannot serialize {type(o).__name__} on the fleet wire")


def _msgpack_hook(d: dict):
    if d.get("__nd__"):
        return _from_envelope(d)
    return d


def _jsonify(o):
    """JSON codec pre-pass: envelopes for ndarrays/bytes, plain types
    everywhere else.  Dict keys stringify (JSON law); int-keyed maps on
    the wire must be re-int'd by the consumer — every fleet consumer
    already does (`{int(k): ... for ...}`)."""
    if isinstance(o, (np.ndarray, torch.Tensor)):
        env = _nd_envelope(o)
        env["data"] = base64.b64encode(env["data"]).decode("ascii")
        return env
    if isinstance(o, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(o)).decode("ascii")}
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, dict):
        return {str(k): _jsonify(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonify(v) for v in o]
    return o


def _json_hook(d: dict):
    if d.get("__nd__"):
        return _from_envelope(d)
    if "__b64__" in d and len(d) == 1:
        return base64.b64decode(d["__b64__"])
    return d


def encode_message(msg: Any, force_json: bool = False) -> bytes:
    """message -> codec byte + body."""
    if _msgpack is not None and not force_json:
        return bytes([CODEC_MSGPACK]) + _msgpack.packb(
            msg, default=_msgpack_default, use_bin_type=True)
    return bytes([CODEC_JSON]) + json.dumps(_jsonify(msg)).encode("utf-8")


def decode_message(payload: bytes) -> Any:
    if not payload:
        raise FrameError("empty payload")
    codec, body = payload[0], payload[1:]
    if codec == CODEC_MSGPACK:
        if _msgpack is None:  # pragma: no cover - gated dep
            raise FrameError("msgpack frame but msgpack is not installed")
        try:
            return _msgpack.unpackb(body, object_hook=_msgpack_hook,
                                    strict_map_key=False, raw=False)
        except Exception as e:  # msgpack raises a zoo of unpack errors
            raise FrameError(f"undecodable msgpack body: {e}") from e
    if codec == CODEC_JSON:
        try:
            return json.loads(body.decode("utf-8"), object_hook=_json_hook)
        except (UnicodeDecodeError, ValueError) as e:
            raise FrameError(f"undecodable json body: {e}") from e
    raise FrameError(f"unknown codec byte {codec}")


# -- framing ----------------------------------------------------------------


def pack_frame(payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unpack_frame(frame: bytes) -> bytes:
    """Exactly-one-frame validator (the queue carrier: one frame per
    queue item).  Raises FrameError on any mismatch."""
    if len(frame) < _HEADER.size:
        raise FrameError(f"short frame: {len(frame)} bytes")
    magic, length, crc = _HEADER.unpack_from(frame)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if length > MAX_FRAME:
        raise FrameError(f"frame length {length} exceeds {MAX_FRAME}")
    payload = frame[_HEADER.size:]
    if len(payload) != length:
        raise FrameError(f"length {len(payload)} != header {length}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        M_FRAMES_CRC_REJECTED.inc()
        raise FrameError("crc mismatch")
    return payload


def scan_frames(data: bytes) -> Tuple[List[bytes], int]:
    """Offline stream reader, read_journal's contract on frames: parse
    payloads in order; a torn or CRC-corrupt FINAL frame after >= 1
    clean frame is skipped and counted; corruption anywhere else (or a
    stream that never yields a clean frame) raises FrameError.  Returns
    (payloads, n_torn)."""
    payloads: List[bytes] = []
    off = 0
    n = len(data)
    while off < n:
        rest = n - off
        if rest < _HEADER.size:
            if payloads:
                return payloads, 1  # torn final header
            raise FrameError(f"truncated header at offset {off}")
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC or length > MAX_FRAME:
            # a mangled header leaves no trustworthy frame extent: probe
            # for another MAGIC downstream — none means the corruption is
            # confined to the tail (torn final); one means an interior
            # frame was destroyed, which stays loud like read_journal's
            # "corrupt journal line"
            if payloads and data.find(MAGIC, off + 1) == -1:
                return payloads, 1
            raise FrameError(f"bad magic/length at offset {off}")
        end = off + _HEADER.size + length
        if end > n:
            if payloads:
                return payloads, 1  # torn final payload
            raise FrameError(f"truncated payload at offset {off}")
        payload = data[off + _HEADER.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if end == n and payloads:
                return payloads, 1  # corrupt FINAL frame == torn tail
            raise FrameError(f"crc mismatch at offset {off}")
        payloads.append(payload)
        off = end
    return payloads, 0


class FrameBuffer:
    """Incremental frame parser for the live receive path (sockets feed
    it chunks; fuzz feeds it mutated streams).  Policy: a CRC-failed
    frame whose framing is intact is dropped and counted (`crc_rejected`
    — the peer's retry re-ships it); broken magic or an absurd length
    means lost sync and raises FrameError; `eof()` with a partial frame
    pending counts a torn tail, exactly like read_journal's final line.

    The parse itself is the PURE machine `protocols.transport.wire_step`;
    this class only applies its outputs (frame queue, obs counters, the
    desync raise).
    """

    def __init__(self):
        self._wire = _proto_wire.wire_init()
        self.frames: deque = deque()

    @property
    def crc_rejected(self) -> int:
        return self._wire.crc_rejected

    @property
    def torn(self) -> int:
        return self._wire.torn

    def feed(self, chunk: bytes) -> None:
        self._wire, outs = _proto_wire.wire_step(self._wire,
                                                 ("feed", bytes(chunk)))
        for out in outs:
            if out[0] == "frame":
                self.frames.append(out[1])
                M_FRAMES_RECV.inc()
            elif out[0] == "crc_reject":
                M_FRAMES_CRC_REJECTED.inc()
            else:  # ("desync", msg): terminal — the stream lost sync
                raise FrameError(out[1])

    def eof(self) -> None:
        """Peer closed: a pending partial frame is a torn tail."""
        self._wire, outs = _proto_wire.wire_step(self._wire, ("eof",))
        if outs:
            M_FRAMES_TORN.inc()

    def pending(self) -> int:
        return len(self._wire.buf)


class Dedup:
    """At-least-once -> exactly-once: retried sends may deliver a frame
    twice; consumers key idempotency by (rid, seq) and drop repeats.
    Decisions come from the machine `protocols.transport.dedup_step`."""

    def __init__(self):
        self._state = _proto_wire.dedup_init()

    @property
    def _seen(self):
        return set(self._state.seen)

    def accept(self, rid, seq) -> bool:
        self._state, outs = _proto_wire.dedup_step(self._state,
                                                   ("frame", rid, seq))
        if outs[0][0] == "dup":
            M_FRAMES_DEDUPED.inc()
            return False
        return True

    def forget_rid(self, rid) -> None:
        """A new transfer attempt for `rid` restarts its seq space."""
        self._state, _ = _proto_wire.dedup_step(self._state,
                                                ("forget", rid))


# -- carriers ---------------------------------------------------------------


class QueueTransport:
    """Frames over queue.Queue / multiprocessing.Queue pairs.  `send_q`
    is OUR outbound direction (the peer's recv side).  recv() returns
    None on empty/torn-down queues — the poll idiom the cluster router
    already speaks."""

    def __init__(self, send_q, recv_q):
        self._send_q = send_q
        self._recv_q = recv_q
        self._flushed = False

    def send(self, msg: Any) -> None:
        frame = pack_frame(encode_message(msg))
        try:
            self._send_q.put(frame)
        except (OSError, ValueError) as e:
            raise TransportClosed(f"send queue torn down: {e}") from e
        M_FRAMES_SENT.inc()
        M_BYTES_SENT.inc(len(frame))

    def recv(self, timeout: float = 0.0) -> Optional[Any]:
        try:
            if timeout > 0:
                frame = self._recv_q.get(timeout=timeout)
            else:
                frame = self._recv_q.get_nowait()
        except _queue.Empty:
            return None
        except (OSError, EOFError, ValueError) as e:
            # queue torn down under us (dead peer): None is the contract,
            # but the absorbed error must stay observable — a recv loop
            # spinning on a dead queue shows up as this counter climbing
            M_PEER_LOSS_SWALLOWED.inc()
            from ..obs.logs import safe_warn
            safe_warn(_log(), "recv queue torn down (%s: %s); "
                      "returning None", type(e).__name__, e)
            return None
        return decode_message(unpack_frame(frame))

    def flush(self) -> None:
        """Drain the mp feeder thread so already-sent frames survive this
        process dying right after (the worker error path: the "error"
        frame must reach the router even though we are about to raise).
        After flush() the send side is closed."""
        if self._flushed:
            return
        self._flushed = True
        q = self._send_q
        if hasattr(q, "close") and hasattr(q, "join_thread"):
            q.close()
            q.join_thread()

    def close(self) -> None:
        self.flush()

    def abandon(self) -> None:
        """The peer is gone for good: frames still buffered for it (a KV
        page forwarded to a replica that died fills the pipe nobody
        reads) are dropped at this process's exit instead of blocking
        it."""
        if hasattr(self._send_q, "cancel_join_thread"):
            self._send_q.cancel_join_thread()


class SocketTransport:
    """Frames over one TCP connection."""

    def __init__(self, sock: socket.socket, send_timeout_s: float = 30.0):
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.send_timeout_s = send_timeout_s
        self._fb = FrameBuffer()
        self._closed = False

    @classmethod
    def connect(cls, host: str, port: int, *, timeout_s: float = 5.0,
                retries: int = 8, backoff=None, rid: int = 0,
                send_timeout_s: float = 30.0) -> "SocketTransport":
        """Dial with retry: refused/timed-out connects back off on the
        seeded RetryBackoff (loadgen.driver) and redial — a worker that
        boots before its router's listener is up must not die for it."""
        from ..loadgen.driver import RetryBackoff

        bo = backoff if backoff is not None else RetryBackoff()
        last = None
        for attempt in range(retries + 1):
            try:
                sock = socket.create_connection((host, port),
                                                timeout=timeout_s)
                return cls(sock, send_timeout_s=send_timeout_s)
            except (ConnectionRefusedError, socket.timeout, OSError) as e:
                last = e
                if attempt < retries:
                    M_SEND_RETRIES.inc()
                    time.sleep(bo.delay(rid, attempt + 1))
        raise TransportClosed(
            f"connect to {host}:{port} failed after {retries + 1} "
            f"attempts: {last}")

    def send(self, msg: Any) -> None:
        if self._closed:
            raise TransportClosed("transport already closed")
        frame = pack_frame(encode_message(msg))
        self._sock.settimeout(self.send_timeout_s)
        try:
            self._sock.sendall(frame)
        except socket.timeout as e:
            raise SendTimeout(
                f"send timed out after {self.send_timeout_s:g}s") from e
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            self._closed = True
            raise TransportClosed(f"peer gone: {e}") from e
        M_FRAMES_SENT.inc()
        M_BYTES_SENT.inc(len(frame))

    def recv(self, timeout: float = 0.0) -> Optional[Any]:
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            if self._fb.frames:
                return decode_message(self._fb.frames.popleft())
            if self._closed:
                return None
            remaining = deadline - time.monotonic()
            self._sock.settimeout(max(remaining, 0.0) or 1e-4)
            try:
                chunk = self._sock.recv(1 << 16)
            except (socket.timeout, BlockingIOError):
                if time.monotonic() >= deadline:
                    return None
                continue
            except (ConnectionResetError, OSError) as e:
                # peer reset mid-read: converted to EOF so the torn-tail
                # accounting below runs, but logged + counted first
                M_PEER_LOSS_SWALLOWED.inc()
                from ..obs.logs import safe_warn
                safe_warn(_log(), "socket recv failed (%s: %s); "
                          "treating as EOF", type(e).__name__, e)
                chunk = b""
            if not chunk:
                self._closed = True
                self._fb.eof()  # partial tail from a dead peer: torn
                continue
            self._fb.feed(chunk)

    @property
    def torn(self) -> int:
        return self._fb.torn

    def flush(self) -> None:
        pass  # sendall is synchronous

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError as e:
            # already dead; close is best-effort by contract — but count
            # it, so "every teardown errors" is visible in obs
            M_PEER_LOSS_SWALLOWED.inc()
            from ..obs.logs import safe_warn
            safe_warn(_log(), "socket close failed (%s: %s); ignored",
                      type(e).__name__, e)


def listen(host: str = "127.0.0.1", port: int = 0):
    """(listening socket, bound port) for a fleet router."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(64)
    return sock, sock.getsockname()[1]


def accept(listener: socket.socket, timeout_s: float = 60.0,
           send_timeout_s: float = 30.0) -> SocketTransport:
    listener.settimeout(timeout_s)
    try:
        conn, _ = listener.accept()
    except socket.timeout as e:
        raise TransportClosed(
            f"no connection within {timeout_s:g}s") from e
    return SocketTransport(conn, send_timeout_s=send_timeout_s)


def send_with_retry(transport, msg: Any, *, backoff=None, retries: int = 5,
                    rid: int = 0,
                    reconnect: Optional[Callable[[], Any]] = None):
    """Send with the seeded backoff on every retryable failure.  When
    `reconnect` is given a TransportClosed also retries through a fresh
    transport (returned so the caller adopts it); otherwise only
    retryable errors (timeouts, CRC rejections surfaced by a NACK path)
    are retried."""
    from ..loadgen.driver import RetryBackoff

    bo = backoff if backoff is not None else RetryBackoff()
    cur = transport
    for attempt in range(retries + 1):
        try:
            cur.send(msg)
            return cur
        except TransportError as e:
            recoverable = e.retryable or (
                isinstance(e, TransportClosed) and reconnect is not None)
            if attempt >= retries or not recoverable:
                raise
            M_SEND_RETRIES.inc()
            time.sleep(bo.delay(rid, attempt + 1))
            if isinstance(e, TransportClosed) and reconnect is not None:
                cur = reconnect()
    return cur

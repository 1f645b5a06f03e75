"""ctypes binding for the native prefetching token loader (port of
burst_attn_tpu/data/loader.py over the same native/dataloader.cpp).

The native side mmaps a "BATD" token file and keeps `queue_depth` ready
[batch, seq_len+1] int32 buffers filled by worker threads; this side hands
out (inputs, targets) numpy views.  The loader is deterministic and
seekable, so a resumed run calls `seek(step)` and continues the stream.
Sharding is window-interleaved: rank r of R owns windows w = r (mod R).

The shared library is built at first use with the system g++ into the
repository's git-ignored `build/native/`, keyed by a hash of the source
(`native/build/` belongs to the JAX package's loader).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from ..obs.logs import get_logger, safe_warn

_logger = get_logger("burst_attn_tpu_torch.data")

_MAGIC = 0x44544142  # "BATD"
_HEADER = 16
_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "dataloader.cpp"
_BUILD = _ROOT / "build" / "native"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def _build_lib() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    out = _BUILD / f"libdataloader-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    # pid-unique tmp + atomic rename: concurrent first-use builds never
    # interleave writes
    tmp = out.with_suffix(f".tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build_lib()))
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.dl_seek.restype = None
        lib.dl_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.dl_num_tokens.restype = ctypes.c_int64
        lib.dl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.dl_windows_per_epoch.restype = ctypes.c_int64
        lib.dl_windows_per_epoch.argtypes = [ctypes.c_void_p]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def write_token_file(path, tokens: np.ndarray) -> None:
    """Write a BATD token file (uint16 when vocab fits, else uint32)."""
    tokens = np.asarray(tokens).reshape(-1)
    if np.issubdtype(tokens.dtype, np.signedinteger) and tokens.min() < 0:
        raise ValueError("token ids must be non-negative")
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    header = np.array([_MAGIC, 1, dtype().itemsize, 0], np.uint32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(tokens, dtype).tobytes())


def read_token_file(path) -> np.ndarray:
    """Read a whole BATD file back (for tests / inspection)."""
    raw = Path(path).read_bytes()
    header = np.frombuffer(raw[:_HEADER], np.uint32)
    if header[0] != _MAGIC or header[1] != 1:
        raise ValueError(f"{path}: not a BATD v1 file")
    dtype = np.uint16 if header[2] == 2 else np.uint32
    return np.frombuffer(raw[_HEADER:], dtype)


class DataLoader:
    """Iterator of (inputs [B,S] int32, targets [B,S] int32) batches;
    targets are inputs shifted by one token.  Both are views of one
    freshly allocated [B, S+1] buffer per call, so batches stay valid."""

    def __init__(self, path, batch: int, seq_len: int, *, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0, shuffle: bool = True,
                 num_threads: int = 2, queue_depth: int = 4):
        self._lib = _load_lib()
        self._h = self._lib.dl_open(
            str(path).encode(), seq_len, batch, shard_id, num_shards, seed,
            num_threads, queue_depth, int(shuffle))
        if not self._h:
            raise ValueError(
                f"dl_open failed for {path} (bad file/params: batch={batch}, "
                f"seq_len={seq_len}, shard {shard_id}/{num_shards}; the file "
                f"needs >= num_shards * (seq_len+1) tokens)")
        self.batch = batch
        self.seq_len = seq_len
        self.step = 0

    @property
    def num_tokens(self) -> int:
        return self._lib.dl_num_tokens(self._h)

    @property
    def windows_per_epoch(self) -> int:
        """Windows owned by THIS shard per epoch."""
        return self._lib.dl_windows_per_epoch(self._h)

    def seek(self, step: int) -> None:
        """Reposition so the next batch is `step` (checkpoint resume)."""
        self._lib.dl_seek(self._h, step)
        self.step = step

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        window = np.empty((self.batch, self.seq_len + 1), np.int32)
        got = self._lib.dl_next(
            self._h, window.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if got < 0:
            raise RuntimeError("dl_next failed")
        self.step = got + 1
        return window[:, :-1], window[:, 1:]

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception as e:  # noqa: BLE001 — __del__ must not raise
            # interpreter teardown: even logging can fail here, so route
            # through safe_warn (failed emissions are kept, not lost)
            safe_warn(_logger, "DataLoader.__del__: close failed (%s: %s)",
                      type(e).__name__, e)

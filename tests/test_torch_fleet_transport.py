"""The port's fleet wire protocol (burst_attn_tpu_torch.fleet.transport)
held to the JAX package's: frames byte-identical for the same arrays
under both codecs (numpy arrays, and torch tensors of the same values,
bf16 and fp8 included), each package decoding the other's frames, the
torn-tail / CRC / desync policy, Dedup, both carriers, and bf16 / fp8
pages decoding bitwise in a process where neither `ml_dtypes` nor
`msgpack` can be imported."""

import os
import queue
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from burst_attn_tpu.fleet import transport as jt
from burst_attn_tpu_torch.fleet import transport as tp

ROOT = Path(__file__).resolve().parents[1]
CODECS = [False, True]  # force_json


def _arrays(seed):
    """(JAX-side numpy arrays, port-side arrays): fp32, int8, int32 as
    numpy on both sides, bf16 / fp8 as ml_dtypes numpy (JAX) and torch
    tensors of the same bits (port), plus an fp32 torch tensor."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((2, 3, 8)).astype(np.float32)
    i8 = rng.integers(-128, 128, (4, 5), dtype=np.int8)
    i32 = rng.integers(-9, 9, (7,), dtype=np.int32)
    bf = (f32 * 3).astype(ml_dtypes.bfloat16)
    f8 = f32.astype(ml_dtypes.float8_e4m3fn)
    t_bf = torch.from_numpy(f32 * 3).to(torch.bfloat16)
    t_f8 = torch.from_numpy(f32).to(torch.float8_e4m3fn)
    jax_side = [f32, i8, i32, bf, f8, f32[0]]
    port_side = [f32, i8, i32, t_bf, t_f8, torch.from_numpy(f32[0].copy())]
    return jax_side, port_side


def _message(arrays):
    f32, i8, i32, bf, f8, row = arrays
    return {"op": "kv_page", "rid": 7, "seq": 2,
            "page": {"k": [f32, bf], "v": [f8, i8], "ks": [row]},
            "meta": {"ids": i32, "n": 3, "f": 1.5, "flag": True,
                     "none": None, "tup": (1, "a", [2, 3])}}


def _same(a, b):
    """Bitwise equality of a decoded array against the one sent."""
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert tuple(a.shape) == tuple(b.shape)
        w = torch.int16 if b.element_size() == 2 else (
            torch.uint8 if b.element_size() == 1 else torch.int32)
        assert torch.equal(a.contiguous().view(w), b.contiguous().view(w))
    else:
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("force_json", CODECS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_identical_to_jax(seed, force_json):
    jax_side, port_side = _arrays(seed)
    fj = jt.pack_frame(jt.encode_message(_message(jax_side),
                                         force_json=force_json))
    fp = tp.pack_frame(tp.encode_message(_message(port_side),
                                         force_json=force_json))
    assert fp == fj
    # each package reads the other's frame; the port rebuilds bf16 / fp8
    # as torch tensors, everything else as numpy, bit for bit
    got = tp.decode_message(tp.unpack_frame(fj))
    flat = got["page"]["k"] + got["page"]["v"] + got["page"]["ks"]
    want = [port_side[0], port_side[3], port_side[4], port_side[1],
            port_side[5].numpy()]
    for a, b in zip(flat, want):
        _same(a, b)
    _same(got["meta"]["ids"], port_side[2])
    assert got["meta"]["tup"] == [1, "a", [2, 3]]
    back = jt.decode_message(jt.unpack_frame(fp))
    assert back["page"]["k"][1].dtype == ml_dtypes.bfloat16
    assert back["page"]["k"][1].tobytes() == jax_side[3].tobytes()


def test_codec_bytes_int_keys_and_garbage():
    msg = {"blob": b"\x00\xffraw", "table": {1: "a", 2: "b"}}
    for force_json in CODECS:
        assert tp.encode_message(msg, force_json=force_json) == \
            jt.encode_message(msg, force_json=force_json)
    out = tp.decode_message(tp.encode_message(msg, force_json=True))
    assert out["blob"] == b"\x00\xffraw"
    assert out["table"] == {"1": "a", "2": "b"}
    for bad in (b"", bytes([99]) + b"x", bytes([tp.CODEC_JSON]) + b"{no"):
        with pytest.raises(tp.FrameError):
            tp.decode_message(bad)


def test_framing_torn_tail_crc_drop_and_desync_match_jax():
    frames = [tp.pack_frame(tp.encode_message(("m", i))) for i in range(4)]
    stream = b"".join(frames[:3])
    assert [tp.decode_message(p)[1] for p in tp.scan_frames(stream)[0]] \
        == [0, 1, 2]
    for cut in (stream[:-5], stream[:-1]):
        assert tp.scan_frames(cut)[1] == jt.scan_frames(cut)[1] == 1
    bad = bytearray(stream)
    bad[len(frames[0]) + 1] ^= 1  # an interior frame's magic: loud
    for mod in (tp, jt):
        with pytest.raises(mod.FrameError):
            mod.scan_frames(bytes(bad))
    with pytest.raises(tp.FrameError):
        tp.unpack_frame(b"XXXX" + frames[0][4:])
    corrupt = bytearray(frames[1])
    corrupt[-2] ^= 0x10  # payload bit: framing intact, CRC rejects
    chunks = frames[0] + bytes(corrupt) + frames[2] + frames[3][:-3]
    fb, jfb = tp.FrameBuffer(), jt.FrameBuffer()
    for i in range(0, len(chunks), 7):  # partial reads are invisible
        fb.feed(chunks[i:i + 7])
        jfb.feed(chunks[i:i + 7])
    assert [tp.decode_message(p)[1] for p in fb.frames] == [0, 2]
    assert list(fb.frames) == list(jfb.frames)
    assert (fb.crc_rejected, fb.pending()) == (jfb.crc_rejected,
                                               jfb.pending())
    fb.eof()
    assert fb.torn == 1 and fb.pending() == 0
    with pytest.raises(tp.FrameError, match="stream lost sync"):
        tp.FrameBuffer().feed(frames[0] + b"JUNKJUNKJUNK" + frames[1])
    dd = tp.Dedup()
    assert dd.accept(7, 0) and dd.accept(7, 1) and not dd.accept(7, 0)
    dd.forget_rid(7)
    assert dd.accept(7, 0) and dd._seen == {(7, 0)}


def test_queue_and_socket_carriers_roundtrip():
    a2b, b2a = queue.Queue(), queue.Queue()
    a = tp.QueueTransport(send_q=a2b, recv_q=b2a)
    b = tp.QueueTransport(send_q=b2a, recv_q=a2b)
    page = torch.randn(2, 128, 16).to(torch.bfloat16)
    a.send(("work", 1, page))
    op, rid, got = b.recv()
    assert op == "work" and rid == 1
    _same(got, page)
    assert b.recv() is None
    # a JAX QueueTransport on the other end reads the same frames
    j = jt.QueueTransport(send_q=b2a, recv_q=a2b)
    a.send(("work", 2, np.arange(4, dtype=np.int32)))
    assert list(j.recv(timeout=1.0)[2]) == [0, 1, 2, 3]

    listener, port = tp.listen()
    try:
        box = {}

        def serve():
            srv = tp.accept(listener, timeout_s=10.0)
            box["tr"] = srv
            msg = srv.recv(timeout=10.0)
            srv.send(("echo", msg[1], msg[2]))

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        cli = tp.SocketTransport.connect("127.0.0.1", port, retries=3)
        cli.send(("hello", 9, page))
        op, rid, got = cli.recv(timeout=10.0)
        assert op == "echo" and rid == 9
        _same(got, page)
        t.join(timeout=10.0)
        box["tr"].close()  # the peer closes: recv drains to None
        assert cli.recv(timeout=2.0) is None
        cli.close()
        with pytest.raises(tp.TransportClosed):
            cli.send(("late", 0))
    finally:
        listener.close()
    dead = tp.listen()[0]
    port = dead.getsockname()[1]
    dead.close()
    with pytest.raises(tp.TransportClosed, match="attempts"):
        tp.SocketTransport.connect("127.0.0.1", port, retries=1,
                                   timeout_s=0.5)


_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["ml_dtypes"] = None
    sys.modules["msgpack"] = None
    import numpy as np, torch
    from burst_attn_tpu_torch.fleet import kvplane, transport as tp
    assert tp._msgpack is None
    frame = open(sys.argv[1], "rb").read()
    msg = tp.decode_message(tp.unpack_frame(frame))
    bf, f8 = msg["page"]["k"][0], msg["page"]["v"][0]
    assert bf.dtype == torch.bfloat16 and f8.dtype == torch.float8_e4m3fn
    # re-encoding reproduces the frame byte for byte; the digest covers
    # the raw bits
    again = tp.pack_frame(tp.encode_message(msg, force_json=True))
    assert again == frame, "re-encoded frame differs"
    print(kvplane.page_digest(msg["page"]))
    assert not any(m.split(".")[0] in ("jax", "ml_dtypes", "msgpack",
                                       "burst_attn_tpu")
                   for m, v in sys.modules.items() if v is not None)
""")


def test_bf16_fp8_pages_decode_without_ml_dtypes_or_msgpack(tmp_path):
    """A process where `ml_dtypes` and `msgpack` cannot be imported (the
    card's machine has neither) decodes a JSON frame of bf16 and fp8
    pages bitwise, and their digest equals the JAX package's."""
    from burst_attn_tpu.fleet import kvplane as jkv

    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((1, 128, 16)).astype(np.float32)
    page = {"k": [f32.astype(ml_dtypes.bfloat16)],
            "v": [f32.astype(ml_dtypes.float8_e4m3fn)]}
    path = tmp_path / "frame.bin"
    path.write_bytes(jt.pack_frame(jt.encode_message(
        {"op": "kv_page", "page": page}, force_json=True)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED, str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == jkv.page_digest(page)

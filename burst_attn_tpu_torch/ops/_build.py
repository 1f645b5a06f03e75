"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library
with a plain C interface, loaded through `ctypes` (no PyTorch headers:
seconds to build, not minutes).  Builds happen at first use, into
`build/kernels/` at the repository root, keyed by a hash of the source, the
shared `csrc/*.cuh` headers and the flags, so an edited source rebuilds and
an unchanged one is reused.
`build_all()` starts one `nvcc` per source, all at once, and waits.

Binding conventions (every C entry point follows them):
  * every pointer and the stream are `ctypes.c_void_p` (a plain int
    argument would be cut to 32 bits);
  * the launch stream is `torch.cuda.current_stream().cuda_stream`;
  * the entry point returns `cudaGetLastError()` after its launch, and
    `check()` raises on anything but 0 — a refused launch (too many
    threads, too much shared memory) never runs and `synchronize()`
    would not report it.

Nothing here runs at import time: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# argtypes of each library's C entry points, by source stem
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "flash_fwd": {
        # q k v m_in lse_in acc_in m_out lse_out out q_ids kv_ids (NULL:
        # no segments), B N Nk Sq Skv D dtype, scale, q_lo q_hi kv_hi
        # causal offset window emit_o, stream
        "flash_fwd_launch": [P] * 11 + [I] * 7 + [F] + [I] * 7 + [P],
        # dtype flag (bit 0 emit_o, bit 1 window, bit 2 segments), int out[4]
        "flash_fwd_attrs": [I, I, ctypes.POINTER(I)],
    },
    "flash_bwd": {
        # dO q k v delta lse dq dk dv counters q_ids kv_ids (NULL: no
        # segments), B N Nk Sq Skv D dtype, scale, q_lo q_hi kv_hi causal
        # offset window (0: none), stream (one list for all three entry
        # points)
        **{f"flash_bwd_{route}_launch": [P] * 12 + [I] * 7 + [F] + [I] * 6
           + [P] for route in ("fused", "dq", "dkdv")},
        # dtype flag (route: 0 fused, 1 dq, 2 dkdv; + 4 segments, + 8
        # window), int out[4]
        "flash_bwd_attrs": [I, I, ctypes.POINTER(I)],
    },
    "fused_ring_fwd": {
        # D dtype seg window wire, &max_blocks
        "fused_ring_fwd_capacity": [I, I, I, I, I, ctypes.POINTER(I)],
        # q k_in v_in ptrs sched st_m st_l st_acc o lse,
        # W B N Nk S D R NB MS G ncol copy_in0 copy_in1 dtype resident,
        # slot_use (NULL: the stats-off instance), seg (NULL: no
        # segments), window (0: none), scale, stream, kq_in vq_in (NULL:
        # dense), wire code (0: dense), slot bytes
        "fused_ring_fwd_launch": [P] * 10 + [I] * 15 + [P, P, I, F, P]
        + [P, P, I, ctypes.c_longlong],
        # dtype flags (bit 0 resident, bit 1 stats, bit 2 seg, bit 3
        # window, bit 4 wire), int out[4]
        "fused_ring_fwd_attrs": [I, I, ctypes.POINTER(I)],
    },
    "fused_ring_bwd": {
        # D dtype seg window wire, &max_blocks
        "fused_ring_bwd_capacity": [I, I, I, I, I, ctypes.POINTER(I)],
        # first dO q lse k v ptrs sched folds dk dv trace,
        # W B N Nk S D R NB MS MDQ G ncol copy_in0 copy_in1 dtype resident
        # opt, slot_use (NULL: the stats-off instance), seg (NULL: no
        # segments), window (0: none), scale, stream, wire code (0:
        # dense), the dq wire banks' table (NULL: dense), their slot bytes
        "fused_ring_bwd_launch": [P] * 12 + [I] * 17 + [P, P, I, F, P]
        + [I, P, ctypes.c_longlong],
        # dtype flags (bit 0 traced, bit 1 stats, bit 2 seg, bit 3
        # window, bit 4 wire), int out[4]
        "fused_ring_bwd_attrs": [I, I, ctypes.POINTER(I)],
    },
    "ragged_paged": {
        # q k_pages v_pages k_scales v_scales table q_lens kv_lens ctx_lo
        # out acc m l ws counters trace, S Nkv G QT D page width window
        # ppd nsd ppf nsf n_ws dtype kv_dtype, scale, stream
        "ragged_paged_launch": [P] * 16 + [I] * 15 + [F] + [P],
        # q dtype, pool dtype (kInt8 / kFp8E4M3, or q's), int out[4]
        "ragged_paged_attrs": [I, I, ctypes.POINTER(I)],
    },
    "step_probe": {
        # q pool out sums, bq bkv d n_pool steps matmul n_cta, stream
        "step_probe_launch": [P] * 4 + [I] * 7 + [P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are built "
                           "on the machine with the card")
    return path


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:  # the shared headers too
        h.update(f.read_bytes())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path), or
    None when the library is already built."""
    src, so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Build every named kernel library in parallel (one nvcc each) and
    load it.  Returns {name: compiler output} (ptxas register and shared
    memory report; empty when the library was already built)."""
    jobs = {n: _start(n) for n in names}
    logs = {}
    try:
        for n in names:
            logs[n] = _finish(n, jobs[n])
    finally:
        for job in jobs.values():  # stop any nvcc still running
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    for n in names:
        load(n)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library for `csrc/<name>.cu`, building it at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _, so = _target(name)
    if not so.exists():
        _finish(name, _start(name))
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def kernel_attrs(lib_name: str, instances):
    """Registers a thread, local (spill) bytes a thread, dynamic shared
    memory and resident CTAs on the current card of each instance of a
    kernel library's kernel, from cudaFuncGetAttributes through the
    library's `<lib_name>_attrs(code, flag, int out[4])` entry point:
    [{"instance": ..., "regs": ..., "local_bytes": ..., "smem": ...,
    "ctas": ...}].  `instances` maps a label to the entry point's (dtype
    code, flag) arguments."""
    lib = load(lib_name)
    fn = getattr(lib, f"{lib_name}_attrs")
    out = []
    for label, (code, flag) in instances.items():
        vals = (ctypes.c_int * 4)()
        check(fn(code, flag, vals), f"{lib_name} attrs {label}")
        out.append(dict(instance=label, regs=vals[0], local_bytes=vals[1],
                        smem=vals[2], ctas=vals[3]))
    return out


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           "(cudaGetLastError)")

"""Numerics verifiers (port of burst_attn_tpu/analysis/numerics.py; rules
fp32-accum and lse-fp32): the FlashAttention numerics contract (arXiv
2205.14135) on the port's sources, plain versions and compiled kernels.

  fp32-accum  every tensor-core product accumulates in float32:
              * every `mma` / `wgmma` instruction string under csrc/
                names f32 as its D and C types (CPU);
              * no matmul-family op of the plain versions (tile_fwd /
                tile_bwd, the paged and ragged plain versions, those of
                kernels 8-9) takes bf16 / f16 operands to a bf16 / f16
                result on bf16 inputs at B1 N2 S128 D64 (CPU, the op
                stream of analysis/opstream.py);
              * every HMMA / HGMMA of every built kernel library's SASS
                (`cuobjdump -sass`) carries an F32 accumulator (card).
  lse-fp32    the running max / log-sum-exp / delta statistics stay fp32:
              * every kernel parameter or state array named m, lse or
                delta (or their _in / _out forms) is float in csrc/, and
                every cast of one is to float (CPU);
              * the bf16 scan ring's forward and backward convert no
                float32 stats tensor ([B, N, S] a position, [W, B, N, S]
                stacked) to bf16 / f16 — on the CPU, and on the card with
                the kernels in the ring (card).
"""

import inspect
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from . import opstream
from .core import Finding, rule

rule("fp32-accum", "trace",
     "matmuls on bf16/f16 operands accumulate in float32: the csrc mma "
     "strings, the plain versions' op streams, the kernels' SASS")(None)
rule("lse-fp32", "trace",
     "softmax stats (m/lse/delta) are float in csrc and never downcast "
     "below fp32 in the ring's op stream")(None)

CARD_RULES = {
    "fp32-accum (card half)":
        "the HMMA/HGMMA accumulators of the compiled kernels' SASS need "
        "the card's build (cuobjdump); run `python -m "
        "burst_attn_tpu_torch.analysis --card` there",
    "lse-fp32 (card half)":
        "the bf16 ring's op stream with the kernels in it needs the CUDA "
        "card",
}

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_STATS = r"(?:m|lse|delta)(?:_in|_out)?"
# a declaration: [const] TYPE [*] [const] [__restrict__] NAME followed by
# [ , ) ; or =
_DECL_RE = re.compile(
    r"(?<![\w.>])((?:const\s+)?[A-Za-z_][\w:<>]*)\s*\*?\s*(?:const\s+)?"
    r"(?:__restrict__\s+)?\b(" + _STATS + r")\b\s*(?=[\[,);=])")
_CAST_RE = re.compile(r"(?:static|reinterpret)_cast<\s*(?:const\s+)?"
                      r"([\w:]+)\s*\*\s*>\s*\(\s*(" + _STATS + r")\s*\)")
_NOT_TYPES = {"return", "else", "case", "goto", "new", "delete"}
# mma.sync.aligned.SHAPE.ALAYOUT.BLAYOUT.DTYPE.ATYPE.BTYPE.CTYPE and
# wgmma.mma_async.sync.aligned.SHAPE.DTYPE.ATYPE.BTYPE
_MMA_RE = re.compile(r'"\s*((?:wgmma\.mma_async|mma\.sync)[\w.]*)')
_FLOAT_TYPES = ("f16", "bf16", "f32", "f64", "tf32", "e4m3", "e5m2", "s32",
                "s8", "u8")
_LOW = opstream.LOW_FLOATS


def _anchor(fn):
    try:
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<trace>", 0


def _line(src: str, pos: int) -> int:
    return src.count("\n", 0, pos) + 1


def _strip_comments(src: str) -> str:
    """Comments blanked to spaces (line numbers kept)."""
    return re.sub(r"//[^\n]*|/\*.*?\*/",
                  lambda m: re.sub(r"[^\n]", " ", m.group(0)), src,
                  flags=re.S)


def _mma_types(instr: str):
    """(D type, C type) of an mma / wgmma instruction string."""
    types = [p for p in instr.split(".") if p in _FLOAT_TYPES]
    if instr.startswith("wgmma"):
        return (types[0], types[0]) if types else (None, None)
    return (types[0], types[-1]) if types else (None, None)


def check_sources(root: str = CSRC) -> List[Finding]:
    """The csrc halves of both rules over every .cu / .cuh under `root`."""
    findings: List[Finding] = []
    for name in sorted(os.listdir(root)):
        if not name.endswith((".cu", ".cuh")):
            continue
        path = os.path.join(root, name)
        with open(path, encoding="utf-8") as f:
            src = _strip_comments(f.read())
        for m in _MMA_RE.finditer(src):
            d, c = _mma_types(m.group(1))
            if d != "f32" or c != "f32":
                findings.append(Finding(
                    rule="fp32-accum", file=path, line=_line(src, m.start()),
                    message=f"`{m.group(1)}` accumulates in D={d} C={c}, "
                            "not f32 — the tensor-core products of a "
                            "softmax tile must keep an f32 accumulator"))
        for m in _DECL_RE.finditer(src):
            typ = m.group(1).replace("const", "").strip()
            if typ in _NOT_TYPES or typ in ("float", "void", "auto"):
                continue
            findings.append(Finding(
                rule="lse-fp32", file=path, line=_line(src, m.start()),
                message=f"softmax stat `{m.group(2)}` declared {typ}, not "
                        "float — m/lse/delta must stay fp32 in every "
                        "kernel"))
        for m in _CAST_RE.finditer(src):
            if m.group(1) != "float":
                findings.append(Finding(
                    rule="lse-fp32", file=path, line=_line(src, m.start()),
                    message=f"softmax stat `{m.group(2)}` cast to "
                            f"{m.group(1)}*, not float*"))
    return findings


def check_stream(stream: Sequence[opstream.OpEvent], *, where: str, anchor,
                 stats_rank: int = 3, stats_shapes=()) -> List[Finding]:
    """Both rules over one recorded op stream: a matmul-family op taking
    a bf16/f16 operand to a bf16/f16 result (fp32-accum), and a float32
    tensor of rank `stats_rank` (or of a shape in `stats_shapes`)
    converted to bf16/f16 (lse-fp32)."""
    findings: List[Finding] = []
    path, line = anchor
    shapes = {tuple(s) for s in stats_shapes}
    for e in stream:
        if e.op in opstream.MATMUL_OPS:
            low_in = [d for d, _, _ in e.inputs if d in _LOW]
            outs = {d for d, _, _ in e.outputs}
            if low_in and outs & set(_LOW):
                findings.append(Finding(
                    rule="fp32-accum", file=path, line=line,
                    message=f"{where}: {e.format()} accumulates in "
                            f"{'/'.join(sorted(str(d) for d in outs))}, "
                            "not float32 — upcast the operands (or take "
                            "an fp32 result) before the product"))
        elif e.op in opstream.COPY_OPS and e.inputs and e.outputs:
            src = e.inputs[-1] if e.op == "aten.copy_" else e.inputs[0]
            dst = e.outputs[0]
            if (src[0] == torch.float32 and dst[0] in _LOW
                    and (len(src[1]) == stats_rank or src[1] in shapes)):
                findings.append(Finding(
                    rule="lse-fp32", file=path, line=line,
                    message=f"{where}: float32 stats tensor "
                            f"{list(src[1])} converted to "
                            f"{str(dst[0]).replace('torch.', '')} — "
                            "m/lse/delta must stay fp32 across ring rounds"))
    return findings


# ---------------------------------------------------------------------------
# the plain versions and the ring (CPU; the ring on the card too)

_SHAPE = dict(b=1, n=2, s=128, d=64)


def _plain_cases():
    """(where, anchor fn, call) for every plain version at the JAX shape,
    bf16 inputs."""
    from ..ops import fused_ring, fused_ring_bwd, paged_attention, tile
    from ..ops import ragged_paged
    from ..ops.masks import round_spec
    from ..parallel.burst import BurstConfig

    b, n, s, d = (_SHAPE[k] for k in "bnsd")
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g).to(dtype)

    q, k, v, do = (rnd(b, n, s, d) for _ in range(4))
    f3 = torch.zeros(b, n, s)
    spec = round_spec(0, 0, s, s, True, "contig")
    scale = d ** -0.5
    m0 = torch.full((b, n, s), float("-inf"))
    acc0 = torch.zeros(b, n, s, d)
    # a paged pool of the same shape: 2 slots over 4 pages of 128
    slots, page = 2, 128
    kp, vp = (rnd(4, n, page, d) for _ in range(2))
    qd = rnd(slots, n, 1, d)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([200, 100], dtype=torch.int32)
    qr = rnd(slots, n, 8, d)
    q_lens = torch.tensor([8, 3], dtype=torch.int32)
    # kernels 8-9: the zigzag causal ring of 2 positions over S128
    w = 2
    cfg = BurstConfig(causal=True, layout="zigzag", intra_axis="sp",
                      backend="fused_ring")
    qs, ks, vs, dos = (t.reshape(b, n, w, s // w, d).movedim(2, 0)
                       .contiguous() for t in (q, k, v, do))

    def k9():
        o, lse = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)[:2]
        return fused_ring_bwd.fused_ring_bwd(qs, ks, vs, o, lse, dos, cfg,
                                             1, w)

    return [
        ("tile_fwd", tile.tile_fwd,
         lambda: tile.tile_fwd(q, k, v, m0, f3, acc0, scale, spec)),
        ("tile_bwd", tile.tile_bwd,
         lambda: tile.tile_bwd(do, q, k, v, f3, f3, scale, spec)),
        ("paged_decode_reference", paged_attention.paged_decode_reference,
         lambda: paged_attention.paged_decode_reference(
             qd, kp, vp, table, lens)),
        ("ragged_paged_reference", ragged_paged.ragged_paged_reference,
         lambda: ragged_paged.ragged_paged_reference(
             qr, kp, vp, table, q_lens, lens)),
        ("fused_ring_reference", fused_ring.fused_ring_reference,
         lambda: fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)),
        ("fused_ring_bwd_reference", fused_ring_bwd.fused_ring_bwd_reference,
         k9),
    ]


def check_plain_versions(cases=None) -> List[Finding]:
    findings: List[Finding] = []
    for where, fn, call in cases or _plain_cases():
        _, stream = opstream.record_call(call)
        findings += check_stream(stream, where=f"{where} (bf16)",
                                 anchor=_anchor(fn))
    return findings


RING = {"cpu": dict(world=4, b=1, n=2, s_local=16, d=8),
        "cuda": dict(world=4, b=1, n=2, s_local=128, d=128)}


def check_ring(device="cpu") -> List[Finding]:
    """The bf16 scan ring's forward and backward (zigzag causal, 4
    positions), recorded on `device`: both rules over its op stream, the
    stats tensors named by their shapes."""
    from ..parallel import burst

    dims = RING[torch.device(device).type]
    w, b, n, s, d = (dims[k] for k in ("world", "b", "n", "s_local", "d"))
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, n, s * w, d, generator=g).to(device=device,
               dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    stats_shapes = [(b, n, s), (w, b, n, s), (b, n, s * w)]

    def run():
        o = burst.burst_attn(q, k, v, mesh={"sp": w}, causal=True,
                             layout="zigzag", backend="jnp" if device ==
                             "cpu" else "auto")
        o.float().sum().backward()

    _, stream = opstream.record_call(run)
    return check_stream(stream, where=f"bf16 scan ring fwd+bwd ({device})",
                        anchor=_anchor(burst._fwd_impl), stats_rank=3,
                        stats_shapes=stats_shapes)


def check_all() -> List[Finding]:
    return check_sources() + check_plain_versions() + check_ring("cpu")


# ---------------------------------------------------------------------------
# the card half: the compiled kernels' SASS

_SASS_MMA_RE = re.compile(r"\b(H(?:G)?MMA)((?:\.\w+)+)")
# the libraries whose bf16 instances run on tensor cores: an empty census
# there means the check saw nothing, never that it passed
TENSOR_CORE_LIBS = ("flash_fwd", "flash_bwd", "fused_ring_fwd",
                    "fused_ring_bwd", "ragged_paged")


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise RuntimeError("cuobjdump not found (PATH, /usr/local/cuda/bin)")
    return path


def sass_census(sass: str):
    """{function: [(mnemonic, modifiers)]} of every HMMA / HGMMA."""
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            out.setdefault(fn, [])
        elif "MMA" in line:
            for mm in _SASS_MMA_RE.finditer(line):
                out.setdefault(fn, []).append((mm.group(1), mm.group(2)))
    return out


def check_sass_text(lib: str, sass: str, *, need_mma: bool,
                    anchor=(CSRC, 0), match: Optional[str] = None
                    ) -> List[Finding]:
    """fp32-accum over one library's SASS: every HMMA / HGMMA (of the
    functions whose name contains `match`, when given) names F32."""
    findings: List[Finding] = []
    census = sass_census(sass)
    n = 0
    for fn, mmas in census.items():
        if match is not None and match not in (fn or ""):
            continue
        for mnem, mods in mmas:
            n += 1
            if ".F32" not in mods:
                findings.append(Finding(
                    rule="fp32-accum", file=anchor[0], line=anchor[1],
                    message=f"{lib}: {mnem}{mods} in {fn} has no F32 "
                            "accumulator in the compiled SASS"))
    if need_mma and n == 0:
        findings.append(Finding(
            rule="fp32-accum", file=anchor[0], line=anchor[1],
            message=f"{lib}: no HMMA/HGMMA found in its SASS — the census "
                    "saw no tensor-core product to check"))
    return findings


def start_sass(libs: Optional[Iterable[str]] = None):
    """Start one `cuobjdump -sass` per built library (default: all of
    them), all at once, each writing to a temporary file: the jobs that
    `finish_sass` collects (the smoke starts them right after its build,
    so they run beside its first phases)."""
    import tempfile

    from ..ops import _build

    jobs = {}
    for lib in libs or tuple(_build.SIGNATURES):
        _build.load(lib)
        out = tempfile.TemporaryFile(mode="w+")
        so = _build._target(lib)[1]
        jobs[lib] = (subprocess.Popen([_cuobjdump(), "-sass", str(so)],
                                      stdout=out, stderr=subprocess.PIPE,
                                      text=True), out, so)
    return jobs


def finish_sass(jobs) -> Dict[str, str]:
    """{library: its SASS} of `start_sass`'s jobs; every job is waited
    for (or killed, when one fails) and its file closed."""
    texts = {}
    try:
        for lib, (proc, out, so) in jobs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"cuobjdump -sass {so} failed: {err}")
            out.seek(0)
            texts[lib] = out.read()
    finally:
        for proc, out, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return texts


def check_sass(libs: Optional[Iterable[str]] = None, match=None,
               sass: Optional[Dict[str, str]] = None) -> List[Finding]:
    """fp32-accum's card half over the built libraries (default: all);
    `sass` is their `finish_sass` output when it was taken already."""
    from ..ops import _build

    libs = tuple(libs or _build.SIGNATURES)
    if sass is None:
        sass = finish_sass(start_sass(libs))
    findings: List[Finding] = []
    for lib in libs:
        findings += check_sass_text(
            lib, sass[lib], need_mma=lib in TENSOR_CORE_LIBS,
            anchor=(os.path.join(CSRC, f"{lib}.cu"), 1), match=match)
    return findings


def check_card(sass: Optional[Dict[str, str]] = None) -> List[Finding]:
    return check_sass(sass=sass) + check_ring("cuda")

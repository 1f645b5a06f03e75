"""ragged-serve-safe: the serving kernel's launch contract (port of
burst_attn_tpu/analysis/servecheck.py).

Every engine tick is one launch of kernel 7 (ops/ragged_paged.py) with
the per-slot token counts (q_lens), context lengths (kv_lens) and page
table as DEVICE tensors, so admission, retirement and chunking never
wait for the device.  At the JAX package's three engine widths (decode
fp32 QT=1, chunk fp32 QT=8, chunk bf16 GQA on an int8 pool) this proves:

  no host read   the wrapper's op stream (analysis/opstream.py) holds no
                 host read of q_lens / kv_lens / the table and no
                 data-dependent shape (the counterpart of JAX's abstract
                 trace with traced q_lens); a launch that raises is a
                 finding too;
  no collective  no collective and no copy across devices in the launch
                 (JAX's remote-DMA census): this kernel serves the
                 one-card pool; cross-device traffic belongs to the ring
                 and the dense-shard decode;
  fp32-accum     no matmul-family op of the launch keeps a bf16 result
                 (the numerics family's stream walk).

On the card each launch also runs under sync-debug "error", is captured
in a CUDA graph whose replay must equal the eager launch bitwise and
whose node census (obscheck.graph_census) holds no host, host-device,
peer or collective node, and kernel 7's SASS must carry F32 accumulators
on every HMMA.
"""

import inspect
from typing import List

import torch

from . import numerics, obscheck, opstream
from .core import Finding, rule

rule("ragged-serve-safe", "trace",
     "ragged serving launch takes device q_lens/kv_lens/table with no host "
     "read, zero collectives or cross-device copies, fp32 accumulation; "
     "on the card it captures and replays bitwise")(None)

CARD_RULES = {
    "ragged-serve-safe (card half)":
        "sync-debug launches, graph capture and replay, the node census "
        "and kernel 7's SASS need the CUDA card; run `python -m "
        "burst_attn_tpu_torch.analysis --card` there",
}

SLOTS, WIDTH, PAGE = 4, 8, 128
# (label, n_q, n_kv, qt, dtype, quantized): the JAX package's cases
CASES = (("decode fp32", 4, 4, 1, torch.float32, False),
         ("chunk fp32", 4, 4, 8, torch.float32, False),
         ("chunk bf16 GQA int8", 8, 2, 8, torch.bfloat16, True))


def _anchor(fn):
    try:
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<trace>", 0


def _operands(device, n_q, n_kv, qt, dtype, quant, d, seed=0):
    """A seeded launch: q [SLOTS, n_q, qt, d], a pool of WIDTH // 2 pages
    a slot and the sink (int8 with fp32 scales when `quant`), three
    slots live over their own pages, one idle."""
    from ..ops.paged_attention import quantize_tokens

    g = torch.Generator().manual_seed(seed)
    q = torch.randn(SLOTS, n_q, qt, d, generator=g).to(dtype)
    n_pages = 1 + SLOTS * WIDTH // 2
    k, v = (torch.randn(n_pages, n_kv, PAGE, d, generator=g).to(dtype)
            for _ in range(2))
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = (quantize_tokens(t.float(), dtype=torch.int8)
                            for t in (k, v))
    table = torch.arange(1, n_pages, dtype=torch.int32)
    table = torch.cat([table.reshape(SLOTS, WIDTH // 2),
                       torch.zeros(SLOTS, WIDTH // 2, dtype=torch.int32)], 1)
    q_lens = torch.tensor([qt, 1, 0, qt], dtype=torch.int32)
    kv_lens = torch.tensor([300, 129, 0, 512], dtype=torch.int32)
    ops = dict(q=q, k_pages=k, v_pages=v, page_table=table, q_lens=q_lens,
               kv_lens=kv_lens, k_scales=ks, v_scales=vs)
    return {n: (t.to(device) if t is not None else None)
            for n, t in ops.items()}


def _launch(ops):
    from ..ops import ragged_paged

    o = dict(ops)
    return ragged_paged.ragged_paged_attention(
        o.pop("q"), o.pop("k_pages"), o.pop("v_pages"), o.pop("page_table"),
        o.pop("q_lens"), o.pop("kv_lens"), **o)


def check_stream(stream, *, where, anchor) -> List[Finding]:
    """The three stream halves over one recorded launch."""
    findings = obscheck.check_host_reads(stream, where=where, anchor=anchor,
                                         rule_name="ragged-serve-safe")
    path, line = anchor
    remote = [e for e in stream if e.collective is not None
              or e.cross_device]
    if remote:
        findings.append(Finding(
            rule="ragged-serve-safe", file=path, line=line,
            message=f"{where}: {len(remote)} collective / cross-device "
                    f"event(s) ({remote[0].format()}) in the one-card "
                    "serving launch — cross-device traffic belongs to the "
                    "ring and dist_decode paths, never this launch (census "
                    "must be zero)"))
    findings += numerics.check_stream(stream, where=where, anchor=anchor)
    return findings


def check_all() -> List[Finding]:
    """The three engine widths on the CPU (head dim 64, as JAX's)."""
    from ..ops import ragged_paged

    anchor = _anchor(ragged_paged.ragged_paged_attention)
    findings: List[Finding] = []
    for label, n_q, n_kv, qt, dt, quant in CASES:
        ops = _operands("cpu", n_q, n_kv, qt, dt, quant, d=64)
        where = f"ragged launch ({label})"
        try:
            with opstream.record() as st:
                _launch(ops)
        except Exception as e:  # noqa: BLE001 — the failure IS the finding
            findings.append(Finding(
                rule="ragged-serve-safe", file=anchor[0], line=anchor[1],
                message=f"{where}: the launch with device q_lens/kv_lens "
                        f"raised — it is not safe for the serving engine "
                        f"({type(e).__name__}: {e})"))
            continue
        findings += check_stream(st, where=where, anchor=anchor)
    return findings


def check_card(sass=None) -> List[Finding]:
    """The three widths on the card at kernel 7's head dim: a sync-debug
    eager launch, its CUDA graph replayed bitwise equal, the graph's node
    census, and kernel 7's SASS (`sass`: numerics.finish_sass's output
    when it was taken already)."""
    from ..ops import ragged_paged

    anchor = _anchor(ragged_paged.ragged_paged_attention)
    stream = torch.cuda.Stream()
    findings: List[Finding] = []
    for label, n_q, n_kv, qt, dt, quant in CASES:
        where = f"ragged launch ({label}, cuda)"
        ops = _operands("cuda", n_q, n_kv, qt, dt, quant, d=128)
        _launch(ops)  # the warm-up: the library, the split counters
        torch.cuda.synchronize()
        eager, f = obscheck.sync_checked(lambda: _launch(ops), where=where,
                                          anchor=anchor,
                                          rule_name="ragged-serve-safe")
        findings += f
        try:
            graph, out = obscheck.capture(lambda: _launch(ops), stream)
        except RuntimeError as e:
            findings.append(Finding(
                rule="ragged-serve-safe", file=anchor[0], line=anchor[1],
                message=f"{where}: CUDA graph capture failed: {e}"))
            continue
        graph.replay()
        torch.cuda.synchronize()
        if eager is not None and not torch.equal(out, eager):
            findings.append(Finding(
                rule="ragged-serve-safe", file=anchor[0], line=anchor[1],
                message=f"{where}: the graph replay differs from the eager "
                        f"launch (max abs "
                        f"{(out.float() - eager.float()).abs().max():.3g})"))
        census = obscheck.graph_census(graph)
        findings += obscheck.census_findings(
            census, where=where, anchor=anchor, rule_name="ragged-serve-safe")
        k7 = sum("ragged_kernel" in k for k in census["kernels"])
        if k7 != 1:
            findings.append(Finding(
                rule="ragged-serve-safe", file=anchor[0], line=anchor[1],
                message=f"{where}: {k7} kernel 7 nodes in the launch's "
                        "graph, not 1"))
    findings += [Finding(rule="ragged-serve-safe", file=f.file, line=f.line,
                         message=f.message)
                 for f in numerics.check_sass(("ragged_paged",),
                                              match="ragged_kernel",
                                              sass=sass)]
    return findings

"""pagepool-cow-safe and pool-quant-safe: the copy-on-write write barrier
and the quantized pool's (page, scale) pairs, proven live (port of
burst_attn_tpu/analysis/poolcheck.py).

Prefix caching makes pool pages SHARED: several slots' table rows — and
the prefix-cache index — can reference one physical page.  The single
safety contract is that no launch ever scatters K/V into a page the host
allocator holds at refcount > 1: every launch must run behind the CoW
barrier (serving/engine.RaggedServeEngine._cow_barrier ->
serving/model.cow_pages), so the scatter indices the device sees always
come from the POST-CoW page table.  A violation is silent cross-request
corruption — the other sequence sharing the page reads poisoned K/V.

No static walk can see this (the scatter is correct code; what matters is
the HOST allocator state the indices were derived from), so the rule
drives a real tiny prefix-cache RaggedServeEngine on the CPU through the
sharing-heavy schedule — concurrent partial-prefix hits, plus the
exact-template FULL-prompt hit whose last-token re-absorption targets the
final shared page (the one organic refcount > 1 write) — and checks,
immediately before EVERY launch of ragged_model_step (the synchronous
tick, the pipelined tick and the speculative paths all go through it),
that each table column the launch's token counts will scatter into
(lengths//page .. (lengths+q_len-1)//page) is held at refcount <= 1.
Afterwards it proves the pool ALGEBRA drains: with every request retired
and the cache fully evicted, the free list must hold every usable page
and every refcount must be zero.

`pool-quant-safe` drives the same schedule on an fp8 pool, whose pages
mean something only WITH their per-token fp32 scale column:

  - every launch on the quantized pool must carry scale banks whose
    shape mirrors the page banks (pair residency);
  - every serving/model._copy_pages CoW copy must carry all FOUR banks —
    K/V pages and K/V scales — byte-exactly from source to private page
    (the copy seam is wrapped; zero copies observed is itself a finding);
  - after every launch, each K/V column the launch wrote must dequantize
    (stored q * stored scale) back to the independently recomputed true
    projection rows within fp8 quantization tolerance.

The port's state is updated IN PLACE, so the checks read the pool before
a launch (the scatter targets, the ground truth) and after it (the
written columns).
"""

from typing import List

import numpy as np

from .core import Finding, rule

rule("pagepool-cow-safe", "trace",
     "no launch scatters K/V into a page held at refcount>1 (post-CoW "
     "table only), and the shared pool drains to empty after retire + "
     "full eviction")(None)
rule("pool-quant-safe", "trace",
     "on a natively quantized (fp8) pool, every scatter and every CoW "
     "copy lands the page and its scale column as one unit — written "
     "columns dequantize to the true projections, privatized pages "
     "carry their scales")(None)

_RULE = "pagepool-cow-safe"
_QRULE = "pool-quant-safe"
_PAGE = 128


def _anchor(fn):
    import inspect

    try:
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<trace>", 0


def _tiny(seed: int):
    """(params, cfg) of a one-layer fp32 model on the CPU."""
    import torch

    from ..models.transformer import ModelConfig, init_params

    cfg = ModelConfig(vocab=61, d_model=32, n_layers=1, n_heads=2,
                      n_kv_heads=1, d_head=16, d_ff=64, dtype=torch.float32)
    return init_params(cfg, seed, device="cpu"), cfg


def _prompts(seed: int):
    """Two partial-prefix hits on one cached template page, then the
    template itself (the FULL-prompt hit: the CoW boundary write)."""
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(1, 61, size=_PAGE)  # exactly one cacheable page
    return [np.concatenate([tmpl, rng.integers(1, 61, size=7)]),
            np.concatenate([tmpl, rng.integers(1, 61, size=11)]),
            tmpl.copy()]


def _patched_step(fn):
    """Install `fn` as ragged_model_step where the engine and the
    pipelined tick look it up; returns the undo."""
    from ..serving import engine as eng_mod
    from ..serving import model as serve_model

    real = (eng_mod.ragged_model_step, serve_model.ragged_model_step)
    eng_mod.ragged_model_step = serve_model.ragged_model_step = fn

    def undo():
        eng_mod.ragged_model_step, serve_model.ragged_model_step = real

    return real[0], undo


def _drive(engine, prompts) -> None:
    # wave 1 registers the template; wave 2 admits concurrent hits
    # including the full-prompt hit whose re-absorbed last token is the
    # one organic write into a shared page
    for _wave in range(2):
        for p in prompts:
            engine.submit(p, 3)
        engine.run()


def _drain_findings(engine, rule_name, path, line) -> List[Finding]:
    """Everything retired, the cache fully evicted: the free list must be
    whole and every refcount zero."""
    engine.cache.evict(engine.pool.n_pages)
    pool = engine.pool
    usable = pool.n_pages - 1
    out = []
    free = [int(p) for p in pool._free]
    if len(free) != len(set(free)):
        out.append(Finding(
            rule=rule_name, file=path, line=line,
            message="double-free: the pool free list holds duplicate "
                    f"page ids after drain ({free})"))
    if pool.available != usable or any(r != 0 for r in pool._refs[1:]):
        held = [i for i in range(1, pool.n_pages) if pool._refs[i] > 0]
        out.append(Finding(
            rule=rule_name, file=path, line=line,
            message="refcount leak: after retiring every request and "
                    f"evicting the whole cache, {usable - pool.available} "
                    f"page(s) never returned to the free list "
                    f"(still-referenced pages: {held})"))
    return out


def _check_cow() -> List[Finding]:
    """Drive the shared-prefix schedule on a tiny engine; every launch is
    precondition-checked against the live allocator."""
    import torch

    from ..serving import engine as eng_mod

    path, line = _anchor(eng_mod.RaggedServeEngine._cow_barrier)
    findings: List[Finding] = []
    params, cfg = _tiny(0)
    violations: List[str] = []
    holder = {}

    def checked_step(params_, toks, q_lens, state, cfg_, **kw):
        # the precondition: at launch time, every column this launch's
        # token counts will scatter into must be private (refcount <= 1)
        pool = holder["pool"]
        ql = torch.as_tensor(q_lens).cpu().numpy()
        lens = state.lengths.cpu().numpy()
        table = state.page_table.cpu().numpy()
        pg = state.k_pages[0].shape[2]
        for slot in range(len(ql)):
            n = int(ql[slot])
            if n <= 0:
                continue
            first = int(lens[slot]) // pg
            last = (int(lens[slot]) + n - 1) // pg
            for col in range(first, min(last, table.shape[1] - 1) + 1):
                pid = int(table[slot, col])
                if pid and pool.refcount(pid) > 1:
                    violations.append(
                        f"slot {slot} col {col}: launch scatters "
                        f"{n} token(s) into page {pid} at refcount "
                        f"{pool.refcount(pid)}")
        return real_step(params_, toks, q_lens, state, cfg_, **kw)

    real_step, undo = _patched_step(checked_step)
    try:
        engine = eng_mod.RaggedServeEngine(
            params, cfg, slots=2, n_pages=12, page=_PAGE,
            max_pages_per_seq=4, prefix_cache=True, chunk=_PAGE,
            device="cpu")
        holder["pool"] = engine.pool
        _drive(engine, _prompts(0x90001))
    except Exception as e:  # noqa: BLE001 — the failure IS the finding
        findings.append(Finding(
            rule=_RULE, file=path, line=line,
            message="shared-prefix engine schedule crashed before the "
                    f"write-barrier check completed ({type(e).__name__}: "
                    f"{e})"))
        return findings
    finally:
        undo()

    if violations:
        findings.append(Finding(
            rule=_RULE, file=path, line=line,
            message=f"{len(violations)} launch(es) scattered K/V into a "
                    "shared page (refcount > 1) — the CoW barrier did not "
                    "privatize the scatter targets: "
                    + "; ".join(violations[:3])))
    return findings + _drain_findings(engine, _RULE, path, line)


def _check_quant() -> List[Finding]:
    """Drive the same sharing-heavy schedule on an fp8 pool; every CoW
    copy and every scatter is checked for (page, scale) atomicity, the
    latter against independently recomputed ground truth."""
    import torch

    from ..models.transformer import _qkv_proj
    from ..serving import engine as eng_mod
    from ..serving import model as serve_model

    path, line = _anchor(serve_model.cow_pages)
    findings: List[Finding] = []
    params, cfg = _tiny(1)
    violations: List[str] = []
    copies = {"n": 0}
    real_copy = serve_model._copy_pages

    def banks_of(st):
        return (("K page", st.k_pages), ("V page", st.v_pages),
                ("K scale", st.k_scales), ("V scale", st.v_scales))

    def checked_copy(state, src, dst):
        # the pair-copy contract: a privatized page column arrives with
        # its K/V bytes AND its scale column, byte-exactly
        ns = real_copy(state, src, dst)
        copies["n"] += len(dst)
        if ns.k_scales is None or ns.v_scales is None:
            violations.append("CoW copy on the quantized pool returned a "
                              "state with no scale banks")
            return ns
        for name, bank in banks_of(ns):
            for li, arr in enumerate(bank):
                a = arr.view(torch.uint8) if arr.dtype.itemsize == 1 \
                    else arr
                for s, d in zip(src, dst):
                    if not torch.equal(a[int(d)], a[int(s)]):
                        violations.append(
                            f"CoW copy {int(s)}->{int(d)} layer {li}: the "
                            f"{name} column was not carried to the private "
                            "page — the (page, scale) pair split")
        return ns

    def checked_step(params_, toks, q_lens, state, cfg_, **kw):
        # (1) pair residency: scale banks present and mirroring the page
        #     banks' [P, Nkv, page] geometry at every launch
        if state.k_scales is None or state.v_scales is None:
            violations.append(
                "a launch on the quantized pool carried no scale banks")
            return real_step(params_, toks, q_lens, state, cfg_, **kw)
        for li, (kpg, ksc) in enumerate(zip(state.k_pages, state.k_scales)):
            if tuple(ksc.shape) != tuple(kpg.shape[:3]):
                violations.append(
                    f"layer {li}: scale bank {tuple(ksc.shape)} does not "
                    f"mirror the page bank {tuple(kpg.shape[:3])}")
        # the scatter targets and the ground-truth projections, read
        # BEFORE the launch (it updates the state in place); with
        # n_layers=1 the layer-0 K/V rows are a pure function of the
        # input tokens
        ql = torch.as_tensor(q_lens).cpu().numpy()
        lens = state.lengths.cpu().numpy()
        table = state.page_table.cpu().numpy()
        pg = state.k_pages[0].shape[2]
        toks_np = torch.as_tensor(toks).cpu().numpy()
        slots_n, qt = toks_np.shape
        live = ql > 0
        base = np.where(live, lens, 0)
        t_ix = np.arange(qt)[None, :]
        real = (t_ix < ql[:, None]) & live[:, None]
        pos = base[:, None] + t_ix
        safe_col = np.minimum(pos // pg, table.shape[1] - 1)
        pids = np.where(real, table[np.arange(slots_n)[:, None], safe_col], 0)
        offs = pos % pg
        with torch.no_grad():
            x = params_["embed"][torch.as_tensor(toks_np).long()].to(
                cfg_.dtype)
            _, k, v = _qkv_proj(params_["layers"][0], x,
                                torch.as_tensor(pos), cfg_)
        k_true = k.transpose(1, 2).float().numpy()
        v_true = v.transpose(1, 2).float().numpy()

        out = real_step(params_, toks, q_lens, state, cfg_, **kw)
        ns = out[1]
        # (2) atomic scatter: every column this launch wrote must
        #     dequantize back to the true projection within quantization
        #     tolerance — stale scales leave a pair that is internally
        #     consistent but numerically wrong, so only ground truth
        #     catches the split
        kpg = ns.k_pages[0].float().numpy()
        vpg = ns.v_pages[0].float().numpy()
        ksc = ns.k_scales[0].float().numpy()
        vsc = ns.v_scales[0].float().numpy()
        for s in range(slots_n):
            for t in range(qt):
                if not real[s, t] or int(pids[s, t]) == 0:
                    continue
                pid, off = int(pids[s, t]), int(offs[s, t])
                for nm, bank, scales, true in (("K", kpg, ksc, k_true),
                                               ("V", vpg, vsc, v_true)):
                    deq = bank[pid, :, off] * scales[pid, :, off][:, None]
                    ref = true[s, t]
                    amax = np.abs(ref).max(axis=-1, keepdims=True)
                    tol = 0.07 * np.abs(ref) + 0.02 * amax + 1e-6
                    err = np.abs(deq - ref)
                    if np.any(err > tol):
                        violations.append(
                            f"slot {s} pos {int(pos[s, t])}: the stored "
                            f"{nm} column dequantizes {float(err.max()):.3g}"
                            " away from the true projection — the scatter "
                            "landed the page without its scale (pair "
                            "split)")
        return out

    real_step, undo = _patched_step(checked_step)
    serve_model._copy_pages = checked_copy
    try:
        engine = eng_mod.RaggedServeEngine(
            params, cfg, slots=2, n_pages=12, page=_PAGE,
            max_pages_per_seq=4, prefix_cache=True, chunk=_PAGE,
            quantize="fp8", device="cpu")
        _drive(engine, _prompts(0x90002))
    except Exception as e:  # noqa: BLE001 — the failure IS the finding
        findings.append(Finding(
            rule=_QRULE, file=path, line=line,
            message="quantized-pool engine schedule crashed before the "
                    f"pair-atomicity check completed ({type(e).__name__}: "
                    f"{e})"))
        return findings
    finally:
        undo()
        serve_model._copy_pages = real_copy

    if copies["n"] == 0:
        # the schedule MUST exercise privatization (the wave-2 full-
        # prompt hit); zero observed copies means the pair-copy check
        # proved nothing — surface that instead of passing silently
        findings.append(Finding(
            rule=_QRULE, file=path, line=line,
            message="the quantized drive observed zero CoW copies — the "
                    "(page, scale) pair-copy check did not run; the "
                    "schedule no longer exercises privatization"))
    if violations:
        findings.append(Finding(
            rule=_QRULE, file=path, line=line,
            message=f"{len(violations)} (page, scale) pair violation(s) "
                    "on the fp8 pool: " + "; ".join(violations[:3])))
    return findings + _drain_findings(engine, _QRULE, path, line)


def check_all() -> List[Finding]:
    return _check_cow() + _check_quant()

"""Deterministic serve-workload traces: synthesize, serialize, replay
(port of burst_attn_tpu/loadgen/trace.py; pure numpy, and the same seed
gives byte-identical JSONL in both packages).

A trace is the unit of serve-hardening evidence: a SEEDED, wall-clock-free
description of heavy traffic (ragged prompt/output lengths, bursty
arrivals, a sprinkling of poison requests) that replays byte-identically
anywhere — the single-process oracle, the multi-process cluster, and a CI
lane three months from now all see the same requests at the same virtual
times.  Determinism rules:

  * every sampled quantity comes from ONE `np.random.default_rng(seed)`
    stream in a fixed draw order — same seed, same trace, bit-for-bit;
  * prompts are NOT stored as tokens: each request carries a
    `prompt_seed` and regenerates its tokens on demand (`prompt()`), so
    a million-token trace file stays kilobytes and the oracle can never
    see different tokens than the cluster;
  * arrival times are virtual seconds from trace start — the replayers
    (loadgen/driver.py, loadgen/cluster.py) map them to wall time with a
    `speed` factor; nothing in this module reads a clock.

Arrival model: a two-state Markov-modulated process (calm | burst).  The
state flips ahead of each arrival (`p_enter_burst` / `p_exit_burst`), and
interarrival gaps are exponential at the calm rate or `burst_factor`×
faster inside a burst — the clumpy, overdispersed arrivals (CV > 1) that
actually stress admission control, rather than a smooth Poisson stream.

Poison requests model malformed traffic the engines must reject without
taking a worker down: empty prompts, zero budgets, and prompts too large
for any pool (`poison-oversize`).

Serialized form (JSONL): one `trace-meta`
header line with the full synthesis recipe, then one `trace-request`
line per request.  `load_trace` is strict — a trace is CI input, not
best-effort telemetry.
"""

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

TRACE_VERSION = 1

REQUEST_KINDS = ("normal", "poison-empty", "poison-budget",
                 "poison-oversize", "shared_prefix")
POISON_KINDS = tuple(k for k in REQUEST_KINDS if k.startswith("poison"))

# Trace-level synthesis families.  `bursty` is the original Markov-
# modulated process (synthesize_trace); `diurnal` rides a sinusoidal
# arrival intensity (synthesize_diurnal_trace); `heavy_tail` draws a
# Zipf tenant mix over shared-prefix templates
# (synthesize_heavy_tail_trace).  load_trace rejects unknown kinds the
# same way it rejects unknown request kinds — a trace is CI input.
TRACE_KINDS = ("bursty", "diurnal", "heavy_tail")


@dataclass(frozen=True)
class TraceRequest:
    """One replayable request: WHEN it arrives and WHAT it asks for."""

    rid: int
    t_arrival: float            # virtual seconds from trace start
    prompt_len: int
    prompt_seed: int            # tokens regenerate from this (see prompt())
    max_new_tokens: int
    kind: str = "normal"        # REQUEST_KINDS
    # shared_prefix requests: the first `overlap_len` tokens regenerate
    # from `template_seed` (drawn from a small per-trace template pool),
    # the remaining prompt_len - overlap_len from prompt_seed — every
    # request on the same template shares a bit-identical prefix, which
    # is what the serving prefix cache hits on
    template_seed: int = -1
    overlap_len: int = 0
    # multi-tenant fields (heavy_tail traces; scheduling policies in
    # fleet/policy.py key on them) — defaults keep legacy traces loading
    tenant: int = -1
    priority: int = 0

    @property
    def poison(self) -> bool:
        return self.kind in POISON_KINDS

    def prompt(self, vocab: int) -> np.ndarray:
        """The request's tokens, regenerated deterministically — every
        replayer and the oracle derive the identical [prompt_len] int32
        array from (prompt_seed, prompt_len, vocab) — plus
        (template_seed, overlap_len) for shared_prefix requests."""
        if self.prompt_len <= 0:
            return np.zeros((0,), np.int32)
        if self.kind == "shared_prefix" and self.overlap_len > 0:
            tmpl = np.random.default_rng(self.template_seed).integers(
                1, vocab, size=self.overlap_len)
            tail = np.random.default_rng(self.prompt_seed).integers(
                1, vocab, size=self.prompt_len - self.overlap_len)
            return np.concatenate([tmpl, tail]).astype(np.int32)
        rng = np.random.default_rng(self.prompt_seed)
        return rng.integers(1, vocab, size=self.prompt_len).astype(np.int32)


@dataclass
class Trace:
    """A meta header (the synthesis recipe) + arrival-ordered requests."""

    meta: Dict[str, object]
    requests: List[TraceRequest] = field(default_factory=list)

    @property
    def vocab(self) -> int:
        return int(self.meta["vocab"])

    @property
    def duration_s(self) -> float:
        """Virtual span from trace start to the last arrival."""
        return max((r.t_arrival for r in self.requests), default=0.0)

    def normal(self) -> List[TraceRequest]:
        return [r for r in self.requests if not r.poison]

    def prompts(self) -> Dict[int, np.ndarray]:
        return {r.rid: r.prompt(self.vocab) for r in self.requests}


def synthesize_trace(
    n_requests: int,
    *,
    seed: int,
    vocab: int,
    mean_interarrival_s: float = 0.05,
    burst_factor: float = 8.0,
    p_enter_burst: float = 0.15,
    p_exit_burst: float = 0.35,
    prompt_len_log_mean: float = 2.5,
    prompt_len_log_sigma: float = 0.6,
    prompt_len_min: int = 1,
    prompt_len_max: int = 64,
    max_new_mean: float = 12.0,
    max_new_min: int = 1,
    max_new_max: int = 48,
    poison_rate: float = 0.0,
    oversize_len: int = 100_000,
    shared_fraction: float = 0.0,
    n_templates: int = 4,
    template_len: int = 256,
    label: str = "synthetic",
) -> Trace:
    """Seeded workload synthesis (see the module docstring for the
    models).  Prompt lengths are clipped lognormal (ragged, heavy-ish
    tail), decode budgets clipped geometric, arrivals Markov-modulated
    exponential.  No wall-clock, no global RNG — the same call is the
    same trace forever.

    `shared_fraction` > 0 turns that fraction of normal requests into
    `shared_prefix` requests: each picks one of `n_templates` seeded
    templates and prepends its `template_len` tokens to the privately
    drawn suffix (so its total prompt is template + lognormal tail).
    Guarded draws keep shared_fraction=0 traces BIT-IDENTICAL to
    traces synthesized without the shared-prefix option."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if not 0.0 <= poison_rate < 1.0:
        raise ValueError(f"poison_rate must be in [0, 1), got {poison_rate}")
    if not 0.0 <= shared_fraction <= 1.0:
        raise ValueError(
            f"shared_fraction must be in [0, 1], got {shared_fraction}")
    rng = np.random.default_rng(seed)
    template_seeds: List[int] = []
    if shared_fraction > 0:
        if n_templates < 1:
            raise ValueError(f"n_templates must be >= 1, got {n_templates}")
        if template_len < 1:
            raise ValueError(f"template_len must be >= 1, got {template_len}")
        template_seeds = [int(s) for s in
                          rng.integers(0, 2**31 - 1, size=n_templates)]
    requests: List[TraceRequest] = []
    t = 0.0
    in_burst = False
    for rid in range(n_requests):
        # state flip AHEAD of each arrival, then the gap at the state rate
        if in_burst:
            in_burst = rng.random() >= p_exit_burst
        else:
            in_burst = rng.random() < p_enter_burst
        scale = mean_interarrival_s / (burst_factor if in_burst else 1.0)
        t += float(rng.exponential(scale))
        kind = "normal"
        if poison_rate and rng.random() < poison_rate:
            kind = POISON_KINDS[int(rng.integers(0, len(POISON_KINDS)))]
        prompt_len = int(np.clip(
            round(rng.lognormal(prompt_len_log_mean, prompt_len_log_sigma)),
            prompt_len_min, prompt_len_max))
        max_new = int(np.clip(rng.geometric(1.0 / max_new_mean),
                              max_new_min, max_new_max))
        if kind == "poison-empty":
            prompt_len = 0
        elif kind == "poison-budget":
            max_new = 0
        elif kind == "poison-oversize":
            prompt_len = oversize_len
        template_seed, overlap_len = -1, 0
        if (kind == "normal" and shared_fraction > 0
                and rng.random() < shared_fraction):
            kind = "shared_prefix"
            template_seed = template_seeds[
                int(rng.integers(0, len(template_seeds)))]
            overlap_len = template_len
            prompt_len += template_len  # template + the drawn private tail
        requests.append(TraceRequest(
            rid=rid, t_arrival=round(t, 6), prompt_len=prompt_len,
            prompt_seed=int(rng.integers(0, 2**31 - 1)),
            max_new_tokens=max_new, kind=kind,
            template_seed=template_seed, overlap_len=overlap_len))
    meta = {
        "version": TRACE_VERSION, "label": label, "seed": int(seed),
        "trace_kind": "bursty",
        "vocab": int(vocab), "n_requests": int(n_requests),
        "mean_interarrival_s": mean_interarrival_s,
        "burst_factor": burst_factor, "p_enter_burst": p_enter_burst,
        "p_exit_burst": p_exit_burst,
        "prompt_len_log_mean": prompt_len_log_mean,
        "prompt_len_log_sigma": prompt_len_log_sigma,
        "prompt_len_min": prompt_len_min, "prompt_len_max": prompt_len_max,
        "max_new_mean": max_new_mean, "max_new_min": max_new_min,
        "max_new_max": max_new_max, "poison_rate": poison_rate,
        "oversize_len": oversize_len,
        "shared_fraction": shared_fraction, "n_templates": n_templates,
        "template_len": template_len,
        "duration_s": round(t, 6),
    }
    return Trace(meta=meta, requests=requests)


def _clipped_lognormal(rng, log_mean, log_sigma, lo, hi, n) -> np.ndarray:
    v = np.rint(rng.lognormal(log_mean, log_sigma, size=n))
    return np.clip(v, lo, hi).astype(np.int64)


def _clipped_geometric(rng, mean, lo, hi, n) -> np.ndarray:
    return np.clip(rng.geometric(1.0 / mean, size=n), lo, hi).astype(np.int64)


def synthesize_diurnal_trace(
    n_requests: int,
    *,
    seed: int,
    vocab: int,
    period_s: float = 3600.0,
    mean_rate: float = 20.0,
    peak_to_trough: float = 4.0,
    prompt_len_log_mean: float = 2.5,
    prompt_len_log_sigma: float = 0.6,
    prompt_len_min: int = 1,
    prompt_len_max: int = 64,
    max_new_mean: float = 12.0,
    max_new_min: int = 1,
    max_new_max: int = 48,
    priority_fraction: float = 0.0,
    label: str = "diurnal",
) -> Trace:
    """Sinusoidal ("diurnal") arrival intensity: a nonhomogeneous
    Poisson process at rate(t) = mean_rate * (1 + A sin(2pi t/period)),
    with A chosen so peak rate / trough rate == peak_to_trough — the
    daily swell autoscaling policies must ride, compressed to whatever
    `period_s` the simulation budget affords.

    Arrivals come from exact time-rescaling: unit-exponential gaps
    accumulate to targets on the integrated intensity, inverted on a
    dense monotone grid (vectorized — a million requests synthesize in
    seconds).  Every stream draws from its own child generator
    `default_rng([seed, i])`, so the synthesis is seeded-deterministic
    and streams never perturb each other.  `priority_fraction` tags that
    fraction of requests priority 1 (the preemption class)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if peak_to_trough < 1.0:
        raise ValueError(
            f"peak_to_trough must be >= 1, got {peak_to_trough}")
    if not 0.0 <= priority_fraction <= 1.0:
        raise ValueError(
            f"priority_fraction must be in [0, 1], got {priority_fraction}")
    n = int(n_requests)
    amp = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    rng_arrival = np.random.default_rng([seed, 0])
    rng_len = np.random.default_rng([seed, 1])
    rng_budget = np.random.default_rng([seed, 2])
    rng_seed = np.random.default_rng([seed, 3])
    rng_prio = np.random.default_rng([seed, 4])

    targets = np.cumsum(rng_arrival.exponential(1.0, size=n))

    def big_lambda(t):  # integrated intensity
        w = 2.0 * np.pi / period_s
        return mean_rate * t + mean_rate * amp / w * (1.0 - np.cos(w * t))

    t_max = targets[-1] / mean_rate + period_s
    while big_lambda(t_max) < targets[-1]:
        t_max *= 2.0
    grid = np.linspace(0.0, t_max,
                       max(4096, int(t_max / period_s * 4096)) + 1)
    arrivals = np.interp(targets, big_lambda(grid), grid)

    prompt_lens = _clipped_lognormal(
        rng_len, prompt_len_log_mean, prompt_len_log_sigma,
        prompt_len_min, prompt_len_max, n)
    budgets = _clipped_geometric(
        rng_budget, max_new_mean, max_new_min, max_new_max, n)
    prompt_seeds = rng_seed.integers(0, 2**31 - 1, size=n)
    priorities = (rng_prio.random(n) < priority_fraction).astype(np.int64)

    requests = [TraceRequest(
        rid=rid, t_arrival=round(float(arrivals[rid]), 6),
        prompt_len=int(prompt_lens[rid]),
        prompt_seed=int(prompt_seeds[rid]),
        max_new_tokens=int(budgets[rid]),
        priority=int(priorities[rid])) for rid in range(n)]
    meta = {
        "version": TRACE_VERSION, "label": label, "seed": int(seed),
        "trace_kind": "diurnal",
        "vocab": int(vocab), "n_requests": n,
        "period_s": period_s, "mean_rate": mean_rate,
        "peak_to_trough": peak_to_trough,
        "prompt_len_log_mean": prompt_len_log_mean,
        "prompt_len_log_sigma": prompt_len_log_sigma,
        "prompt_len_min": prompt_len_min, "prompt_len_max": prompt_len_max,
        "max_new_mean": max_new_mean, "max_new_min": max_new_min,
        "max_new_max": max_new_max,
        "priority_fraction": priority_fraction,
        "duration_s": round(float(arrivals[-1]), 6),
    }
    return Trace(meta=meta, requests=requests)


def synthesize_heavy_tail_trace(
    n_requests: int,
    *,
    seed: int,
    vocab: int,
    n_tenants: int = 64,
    zipf_a: float = 1.2,
    mean_interarrival_s: float = 0.05,
    template_len: int = 256,
    shared_fraction: float = 1.0,
    tail_log_mean: float = 2.5,
    tail_log_sigma: float = 0.6,
    tail_min: int = 1,
    tail_max: int = 64,
    max_new_mean: float = 12.0,
    max_new_min: int = 1,
    max_new_max: int = 48,
    priority_tenants: int = 0,
    label: str = "heavy_tail",
) -> Trace:
    """Zipf tenant mix over shared-prefix templates: tenant k (rank
    order) arrives with probability proportional to (k+1)^-zipf_a, and
    every tenant owns ONE seeded template — the head tenants dominate
    traffic AND share prefixes, which is exactly the workload where the
    prefix cache's rich-get-richer routing bias fights tenant fairness.

    Arrivals are plain exponential (the tenant mix is the stressor
    here, not burstiness); `shared_fraction` of each tenant's requests
    carry its template as a `shared_prefix` overlap, the rest are
    private (`shared_fraction=0` produces a trace with no
    shared_prefix requests at all).  The first `priority_tenants`
    head tenants are tagged priority 1.  Child streams via
    `default_rng([seed, i])`, same determinism contract as the diurnal
    kind."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
    if not 0.0 <= shared_fraction <= 1.0:
        raise ValueError(
            f"shared_fraction must be in [0, 1], got {shared_fraction}")
    if template_len < 1:
        raise ValueError(f"template_len must be >= 1, got {template_len}")
    n = int(n_requests)
    rng_arrival = np.random.default_rng([seed, 0])
    rng_tenant = np.random.default_rng([seed, 1])
    rng_len = np.random.default_rng([seed, 2])
    rng_budget = np.random.default_rng([seed, 3])
    rng_seed = np.random.default_rng([seed, 4])
    rng_template = np.random.default_rng([seed, 5])
    rng_shared = np.random.default_rng([seed, 6])

    arrivals = np.cumsum(rng_arrival.exponential(mean_interarrival_s, size=n))
    weights = (np.arange(1, n_tenants + 1, dtype=np.float64)) ** (-zipf_a)
    cdf = np.cumsum(weights / weights.sum())
    tenants = np.searchsorted(cdf, rng_tenant.random(n), side="right")
    tenants = np.minimum(tenants, n_tenants - 1)
    tails = _clipped_lognormal(rng_len, tail_log_mean, tail_log_sigma,
                               tail_min, tail_max, n)
    budgets = _clipped_geometric(rng_budget, max_new_mean, max_new_min,
                                 max_new_max, n)
    prompt_seeds = rng_seed.integers(0, 2**31 - 1, size=n)
    template_seeds = rng_template.integers(0, 2**31 - 1, size=n_tenants)
    shared = rng_shared.random(n) < shared_fraction

    requests = []
    for rid in range(n):
        tenant = int(tenants[rid])
        if shared[rid]:
            kind = "shared_prefix"
            template_seed = int(template_seeds[tenant])
            overlap_len = template_len
            prompt_len = template_len + int(tails[rid])
        else:
            kind, template_seed, overlap_len = "normal", -1, 0
            prompt_len = int(tails[rid])
        requests.append(TraceRequest(
            rid=rid, t_arrival=round(float(arrivals[rid]), 6),
            prompt_len=prompt_len, prompt_seed=int(prompt_seeds[rid]),
            max_new_tokens=int(budgets[rid]), kind=kind,
            template_seed=template_seed, overlap_len=overlap_len,
            tenant=tenant,
            priority=1 if tenant < priority_tenants else 0))
    meta = {
        "version": TRACE_VERSION, "label": label, "seed": int(seed),
        "trace_kind": "heavy_tail",
        "vocab": int(vocab), "n_requests": n,
        "n_tenants": int(n_tenants), "zipf_a": zipf_a,
        "mean_interarrival_s": mean_interarrival_s,
        "template_len": int(template_len),
        "shared_fraction": shared_fraction,
        "tail_log_mean": tail_log_mean, "tail_log_sigma": tail_log_sigma,
        "tail_min": tail_min, "tail_max": tail_max,
        "max_new_mean": max_new_mean, "max_new_min": max_new_min,
        "max_new_max": max_new_max,
        "priority_tenants": int(priority_tenants),
        "duration_s": round(float(arrivals[-1]), 6),
    }
    return Trace(meta=meta, requests=requests)


def save_trace(trace: Trace, path: str) -> str:
    """JSONL: `trace-meta` header first, one `trace-request` per line.
    Deterministic bytes for a deterministic trace (sorted keys)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        # discriminator key is "record", NOT "kind" — requests already
        # carry a `kind` field (normal | poison-*)
        f.write(json.dumps({"record": "trace-meta", **trace.meta},
                           sort_keys=True) + "\n")
        for req in trace.requests:
            f.write(json.dumps({"record": "trace-request", **asdict(req)},
                               sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return path


def load_trace(path: str) -> Trace:
    """Strict parse: a trace is replay input, so any malformed line or a
    missing/incompatible header raises ValueError."""
    meta: Optional[dict] = None
    requests: List[TraceRequest] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON: {e}") from e
            tag = rec.pop("record", None) if isinstance(rec, dict) else None
            if tag == "trace-meta":
                if meta is not None:
                    raise ValueError(f"{path}:{i}: duplicate trace-meta")
                if rec.get("version") != TRACE_VERSION:
                    raise ValueError(
                        f"{path}:{i}: trace version {rec.get('version')!r} "
                        f"!= supported {TRACE_VERSION}")
                if rec.get("trace_kind", "bursty") not in TRACE_KINDS:
                    raise ValueError(
                        f"{path}:{i}: unknown trace kind "
                        f"{rec.get('trace_kind')!r} (one of {TRACE_KINDS})")
                meta = rec
            elif tag == "trace-request":
                if rec.get("kind", "normal") not in REQUEST_KINDS:
                    raise ValueError(
                        f"{path}:{i}: unknown request kind {rec.get('kind')!r}")
                requests.append(TraceRequest(**rec))
            else:
                raise ValueError(f"{path}:{i}: not a trace record: "
                                 f"{line[:80]}")
    if meta is None:
        raise ValueError(f"{path}: no trace-meta header")
    return Trace(meta=meta, requests=requests)

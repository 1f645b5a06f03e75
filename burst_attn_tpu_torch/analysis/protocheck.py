"""proto-*: the serving protocols, model-checked (burstlint; port of
burst_attn_tpu/analysis/protocheck.py).

Four rules back onto burstcheck (analysis/modelcheck.py), which BFS-
explores every interleaving of the protocol models — crash injected at
every step — and proves the safety invariants the fleet's docs promise:

  proto-transfer-atomic   every KV transfer lands exactly once; a kill
                          or abort at ANY step leaves the receiver pool
                          without a single leaked page.  Checked twice:
                          full-precision, and quantized — where every
                          kv_page frame is a (page, scale) PAIR that
                          must stage/land/abort as one unit
  proto-journal-durable   no token reaches a caller before its journal
                          record is fsynced (delivered ⟹ durable), so a
                          crash never un-happens delivered output
  proto-pool-conserved    free-list/refcount conservation and the CoW
                          write barrier hold under every interleaving
                          of admit/share/append/retire/evict
  proto-no-deadlock       bounded liveness: until the protocol run
                          resolves, some non-fault transition is always
                          enabled (a credit/ack circular wait is the
                          canonical violation)

The models transition through the SAME pure machines production runs
(`burst_attn_tpu_torch.protocols.*` — see each class's delegation), so these
rules watch real code, not a spec that can drift.  Findings carry the
minimal counterexample trace; anchors point at the production method
that executes the violated machine.

The gate runs shallow-bound canaries (exhaustive for these model
sizes — `truncated` stays False); tests/test_torch_modelcheck.py re-runs
the sweep at deep bounds and larger models.  Mutation coverage
(tests/test_torch_analysis.py): dropped fsync, eager-staging page leak,
skipped commit preconditions, no-op CoW, and a per-page credit window
against the commit-time-only ack each fire exactly one rule.
"""

from typing import List

from .core import Finding, rule
from . import modelcheck as mc

rule("proto-transfer-atomic", "model",
     "every KV transfer lands exactly once with zero receiver-pool page "
     "leaks, under all interleavings with kill at every step")(None)
rule("proto-journal-durable", "model",
     "delivered ⟹ durable: no token reaches a caller before its journal "
     "record is fsynced, under all interleavings incl. crash")(None)
rule("proto-pool-conserved", "model",
     "pool free-list/refcount conservation + the CoW write barrier hold "
     "under every admit/share/append/retire/evict interleaving")(None)
rule("proto-no-deadlock", "model",
     "bounded liveness: some non-fault transition stays enabled until "
     "the protocol run resolves (no credit/ack circular wait)")(None)

# which rule owns a model's SAFETY violations (deadlocks all map to
# proto-no-deadlock regardless of model)
_SAFETY_RULE = {
    "transfer": "proto-transfer-atomic",
    "journal": "proto-journal-durable",
    "pool": "proto-pool-conserved",
}

# gate bounds: exhaustive for these model sizes (the clean runs finish
# far below them with truncated=False; a grown model that truncates is
# itself a finding)
_GATE = (
    (mc.transfer_model, {}, 40, 100_000),
    # the quantized-pool variant: kv_page frames carry (page, scale)
    # pairs; exactly-once landing must hold PER PAIR (a split sidecar —
    # SCALE_PAIRED mutated off — fires proto-transfer-atomic)
    (mc.transfer_model, {"quantized": True}, 40, 100_000),
    (mc.journal_model, {}, 24, 50_000),
    (mc.pool_model, {}, 20, 50_000),
)


def _anchor(model_name: str):
    """Anchor findings at the production code that EXECUTES the violated
    machine, so the finding is clickable where the fix goes."""
    import inspect

    try:
        if model_name == "transfer":
            from ..fleet import kvplane
            fn = kvplane.KvReceiver.commit
        elif model_name == "journal":
            from ..serving import checkpoint
            fn = checkpoint.TokenJournal.delivered
        else:
            from ..models import paged_decode
            fn = paged_decode.PagePool._step
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError, ImportError):
        return "<trace>", 0


def run_models(specs=_GATE) -> List[mc.CheckResult]:
    return [mc.check(mk(**kw), max_depth=depth, max_states=states)
            for mk, kw, depth, states in specs]


def check_all() -> List[Finding]:
    findings: List[Finding] = []
    for res in run_models():
        if res.ok:
            if res.truncated:
                # a truncated CLEAN run proved nothing exhaustively;
                # surface it as the model's safety rule rather than
                # passing silently
                f, ln = _anchor(res.model)
                findings.append(Finding(
                    rule=_SAFETY_RULE[res.model],
                    message=(f"model '{res.model}' hit its search bound "
                             f"({res.states} states) before exhausting "
                             f"interleavings — raise the gate bound"),
                    file=f, line=ln))
            continue
        v = res.violation
        name = ("proto-no-deadlock" if v.kind == "deadlock"
                else _SAFETY_RULE[res.model])
        f, ln = _anchor(res.model)
        findings.append(Finding(
            rule=name,
            message=(f"model '{res.model}' ({res.states} states "
                     f"explored): {mc.format_trace(v)}"),
            file=f, line=ln))
    return findings

"""The port's model checker (burst_attn_tpu_torch.analysis.modelcheck) over
the port's own protocol machines (burst_attn_tpu_torch.protocols), held
to the JAX package's checker over the JAX machines: the same state
counts, transitions, depths and verdicts at the gate bounds and in the
deep sweeps (slow, as in the JAX suite), the same minimal
counterexamples under the same seeded mutations, the same event
vocabularies, and the checker's mechanics on toy models."""

from typing import NamedTuple

import pytest

from burst_attn_tpu.analysis import modelcheck as jmc
from burst_attn_tpu.analysis import protocheck as jprotocheck
from burst_attn_tpu.protocols import journal as jjp
from burst_attn_tpu.protocols import kvtransfer as jkvp
from burst_attn_tpu.protocols import pool as jpp

from burst_attn_tpu_torch.analysis import modelcheck as mc
from burst_attn_tpu_torch.analysis import protocheck
from burst_attn_tpu_torch.protocols import ProtocolError
from burst_attn_tpu_torch.protocols import journal as jp
from burst_attn_tpu_torch.protocols import kvtransfer as kvp
from burst_attn_tpu_torch.protocols import pool as pp


def _summary(r):
    v = r.violation
    return (r.model, r.ok, r.states, r.transitions, r.depth, r.truncated,
            None if v is None else (v.kind, v.message, v.trace))


# ---------------------------------------------------------------------------
# the protocol models: port == JAX


def _gate_ids(spec):
    return f"{spec[0].__name__}{'-quantized' if spec[1] else ''}"


@pytest.mark.parametrize("i", range(len(protocheck._GATE)),
                         ids=[_gate_ids(s) for s in protocheck._GATE])
def test_gate_models_explore_what_jax_explores(i):
    mk, kw, depth, states = protocheck._GATE[i]
    jmk, jkw, jdepth, jstates = jprotocheck._GATE[i]
    assert (mk.__name__, kw, depth, states) == (jmk.__name__, jkw, jdepth,
                                                jstates)
    r = mc.check(mk(**kw), max_depth=depth, max_states=states)
    assert r.ok and not r.truncated, mc.format_trace(r.violation)
    assert _summary(r) == _summary(jmc.check(
        jmk(**jkw), max_depth=depth, max_states=states))


@pytest.mark.parametrize("name", ["transfer_model", "journal_model",
                                  "pool_model"])
def test_event_vocabularies_equal_jax(name):
    assert (mc.event_vocabulary(getattr(mc, name)())
            == jmc.event_vocabulary(getattr(jmc, name)()))


def test_transfer_model_vocabulary_is_the_wire_protocol():
    vocab = mc.event_vocabulary(mc.transfer_model())
    for stem in ("ship kv_begin", "ship kv_page", "ship kv_end",
                 "deliver kv_begin", "deliver kv_end", "take kv_ack",
                 "crash receiver (restart from snapshot)",
                 "crash sender (router aborts transfer)"):
        assert stem in vocab, (stem, vocab)


def _mutate(monkeypatch, which):
    """Seed the same defect into both packages' machines."""
    for mod_j, mod_k, mod_p in ((jjp, jkvp, jpp), (jp, kvp, pp)):
        if which == "dropped-fsync":
            real = mod_j.step
            monkeypatch.setattr(
                mod_j, "step",
                lambda st, ev, real=real: (st, ()) if ev[0] == "sync"
                else real(st, ev))
        elif which == "noop-cow":
            real = mod_p.step
            monkeypatch.setattr(
                mod_p, "step",
                lambda st, ev, real=real: (st, (("cow", ev[1], ev[1]),))
                if ev[0] == "cow" else real(st, ev))
        elif which == "credit-window":
            monkeypatch.setattr(mod_k, "PAGE_CREDIT_WINDOW", 1)
        elif which == "scale-split":
            monkeypatch.setattr(mod_k, "SCALE_PAIRED", False)


@pytest.mark.parametrize("which,model,kw", [
    ("dropped-fsync", "journal_model", {}),
    ("noop-cow", "pool_model", {}),
    ("credit-window", "transfer_model", {}),
    ("scale-split", "transfer_model", {"quantized": True})])
def test_mutated_machines_give_jax_minimal_counterexamples(monkeypatch,
                                                           which, model, kw):
    _mutate(monkeypatch, which)
    r = mc.check(getattr(mc, model)(**kw), max_depth=40, max_states=100_000)
    jr = jmc.check(getattr(jmc, model)(**kw), max_depth=40,
                   max_states=100_000)
    assert not r.ok
    assert _summary(r) == _summary(jr)


# ---------------------------------------------------------------------------
# checker mechanics on toy models


class _Toy(NamedTuple):
    x: int


def _counter_model(checker, bug_at=None, stuck_at=None, target=3):
    """Counts 0..target by +1, with an optional seeded invariant bug or a
    wedged state; a 'reset' fault transition is always enabled."""

    def transitions(s):
        out = []
        if s.x < target and s.x != stuck_at:
            out.append((f"inc to {s.x + 1}", _Toy(s.x + 1)))
        out.append(("crash reset", _Toy(0)))
        return tuple(out)

    return checker.Model(
        "toy", _Toy(0), transitions,
        invariant=lambda s: (f"hit the seeded bug at {s.x}"
                             if s.x == bug_at else None),
        quiescent=lambda s: s.x >= target)


@pytest.mark.parametrize("kw,depth", [
    ({}, 10), ({"bug_at": 2}, 10), ({"stuck_at": 1}, 10),
    ({"target": 50}, 3)])
def test_toy_models_equal_jax(kw, depth):
    r = mc.check(_counter_model(mc, **kw), max_depth=depth)
    assert _summary(r) == _summary(jmc.check(_counter_model(jmc, **kw),
                                             max_depth=depth))
    if not kw:
        assert r.ok and r.states == 4
    if "bug_at" in kw:
        assert r.violation.trace == ("inc to 1", "inc to 2")
    if "stuck_at" in kw:
        assert r.violation.kind == "deadlock"
        assert "crash reset" in r.violation.message
    if "target" in kw:
        assert r.ok and r.truncated and r.depth == 3


def test_guarded_turns_protocol_errors_into_violated():
    class Boom(ProtocolError):
        pass

    def blow():
        raise Boom("the machine said no")

    _, state = mc.guarded("step", blow)
    assert isinstance(state, mc.Violated)
    assert "Boom" in state.message and "said no" in state.message


def test_canonicalization_and_format():
    a = ("x", frozenset({1, 2, 3}))
    b = ("x", frozenset({3, 1, 2}))
    assert mc.canon(a) == mc.canon(b) == jmc.canon(a)
    assert mc.state_key(a) == mc.state_key(b)
    v = mc.Violation("invariant", "boom", ("a", "b"))
    assert mc.format_trace(v) == jmc.format_trace(
        jmc.Violation("invariant", "boom", ("a", "b")))


# ---------------------------------------------------------------------------
# deep-bound sweeps (slow in the JAX suite, slow here)


@pytest.mark.slow
@pytest.mark.parametrize("model,kw,depth", [
    ("transfer_model", dict(n_pages=3, pool_pages=5), 80),
    ("transfer_model", dict(n_pages=4, pool_pages=7, table_width=6), 120),
    ("journal_model", dict(n_tokens=5), 60),
    ("pool_model", dict(n_pages=7), 40)])
def test_deep_sweeps_equal_jax(model, kw, depth):
    r = mc.check(getattr(mc, model)(**kw), max_depth=depth,
                 max_states=2_000_000)
    assert r.ok and not r.truncated, mc.format_trace(r.violation)
    assert _summary(r) == _summary(jmc.check(
        getattr(jmc, model)(**kw), max_depth=depth, max_states=2_000_000))

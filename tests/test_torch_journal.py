"""Port parity for the write-ahead token journal: the pure machine
(burst_attn_tpu_torch/protocols/journal.py) against the JAX package's on
the same seeded event sequences, and TokenJournal (serving/checkpoint.py)
against the JAX package's TokenJournal, byte for byte, plus ports of the
JAX package's journal tests (tests/test_protocols.py and
tests/test_checkpoint_serve.py)."""

import numpy as np
import pytest

from burst_attn_tpu.protocols import journal as jjp
from burst_attn_tpu.serving import checkpoint as jckpt
from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.protocols import ProtocolError
from burst_attn_tpu_torch.protocols import journal as jp
from burst_attn_tpu_torch.serving import checkpoint as ckpt

KINDS = ("tokens", "done", "reset", "submit")


def _events(seed, n=60, rids=3):
    """A seeded event sequence over every event kind, deliveries near
    and past the durable count, so some sequences raise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["append"] * 4 + ["sync"] * 2 + ["deliver",
                                                          "crash"])
        rid = int(rng.integers(rids))
        if kind == "append":
            out.append(("append", str(rng.choice(KINDS)), rid,
                        int(rng.integers(0, 4))))
        elif kind == "deliver":
            out.append(("deliver", rid, int(rng.integers(0, 3))))
        else:
            out.append((str(kind),))
    return out


def _run(mod, events):
    """[(state, error message or None)] after each event; stops at the
    first raise."""
    st, trace = mod.init(), []
    for ev in events:
        try:
            st, _ = mod.step(st, ev)
        except mod.DurabilityViolation as e:
            trace.append((None, str(e)))
            break
        trace.append((st, None))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_journal_machine_matches_jax(seed):
    """The same events through both machines: equal states after every
    event, the same DurabilityViolation at the same event, and the same
    invariant verdicts."""
    events = _events(seed)
    want, got = _run(jjp, events), _run(jp, events)
    assert got == want
    for (st, _), (jst, _) in zip(got, want):
        if st is not None:
            assert jp.durable_within_delivered(st) == \
                jjp.durable_within_delivered(jst)
            for rid in range(3):
                assert jp.durable_tokens(st, rid) == \
                    jjp.durable_tokens(jst, rid)
                assert jp.delivered_tokens(st, rid) == \
                    jjp.delivered_tokens(jst, rid)


def test_journal_machine_rejects_unknown_events():
    for ev in [("append", "bogus", 0, 1), ("teleport",)]:
        with pytest.raises(ValueError):
            jp.step(jp.init(), ev)
    assert issubclass(jp.DurabilityViolation, ProtocolError)
    assert issubclass(jp.DurabilityViolation, RuntimeError)


def test_journal_machine_sync_fold_and_crash():
    st = jp.init()
    st, _ = jp.step(st, ("append", "tokens", 0, 2))
    assert jp.durable_tokens(st, 0) == 0  # buffered only
    st, _ = jp.step(st, ("sync",))
    assert jp.durable_tokens(st, 0) == 2
    st, _ = jp.step(st, ("append", "tokens", 0, 3))
    st, _ = jp.step(st, ("crash",))
    assert jp.durable_tokens(st, 0) == 2  # buffered records vanished


def test_journal_deliver_barrier_raises_before_sync():
    st = jp.init()
    st, _ = jp.step(st, ("append", "tokens", 0, 1))
    with pytest.raises(jp.DurabilityViolation, match="only 0 are durable"):
        jp.step(st, ("deliver", 0, 1))
    st, _ = jp.step(st, ("sync",))
    st, _ = jp.step(st, ("deliver", 0, 1))
    assert jp.durable_within_delivered(st)


def test_tokenjournal_executes_the_machine(tmp_path, monkeypatch):
    events = []
    real = jp.step

    def spy(st, ev):
        events.append(ev[0])
        return real(st, ev)

    monkeypatch.setattr(jp, "step", spy)
    j = ckpt.TokenJournal(str(tmp_path / "j.jsonl"), truncate=True)
    j.tokens(0, [1, 2])
    with pytest.raises(RuntimeError, match="sync\\(\\) must run"):
        j.delivered(0, 2)  # tokens buffered, not fsynced: the barrier
    j.sync()
    j.delivered(0, 2)  # durable now
    assert events.count("append") == 1
    assert "sync" in events and "deliver" in events


def _write(mod, path, truncate=True):
    j = mod.TokenJournal(path, truncate=truncate)
    j.submit(3, 103, [5, 6, 7], 4)
    j.tokens(3, [9])
    j.tokens(3, [])            # dropped: no empty record
    j.tokens(3, np.asarray([10, 11], np.int32))
    j.reset(3)
    j.tokens(3, [12])
    j.done(3)
    j.close()


def test_tokenjournal_file_matches_jax(tmp_path):
    """The same calls give the same bytes in both packages; each package
    reads the other's file to the same view; an append-mode reopen keeps
    the file and seeds the delivery check from it."""
    mine, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    _write(ckpt, mine)
    _write(jckpt, theirs)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for path in (mine, theirs):
        a, b = ckpt.journal_view(path), jckpt.journal_view(path)
        assert (a.submits, a.tokens, a.done, a.n_skipped) == \
            (b.submits, b.tokens, b.done, b.n_skipped)
        assert a.tokens == {3: [12]} and a.done == {3}
    assert ckpt.journal_tokens_by_ext(mine) == {103: [12]}
    j = ckpt.TokenJournal(mine)          # append-mode reopen
    j.delivered(3, 1)                    # durable from the file's fold
    with pytest.raises(jp.DurabilityViolation):
        j.delivered(3, 2)
    j.tokens(3, [13])
    j.close()
    assert ckpt.journal_view(mine).tokens[3] == [12, 13]


def test_tokenjournal_reopen_of_a_corrupt_file_warns(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write("garbage\n{\"record\": \"done\", \"rid\": 0}\n")
    before = obs.counter("serve.journal_reopen_corrupt").get()
    j = ckpt.TokenJournal(path)
    assert obs.counter("serve.journal_reopen_corrupt").get() == before + 1
    j.close()


def test_journal_torn_tail_tolerated_bad_middle_loud(tmp_path):
    """A torn FINAL line (the crash landed mid-append) is skipped and
    counted; a bad line anywhere else is corruption and stays loud."""
    path = str(tmp_path / "j.jsonl")
    j = ckpt.TokenJournal(path, truncate=True)
    j.submit(0, 100, [1, 2], 4)
    j.tokens(0, [5, 6])
    j.sync()
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"kind": "tokens", "rid": 0, "toks": [7')
    recs, n_skipped = ckpt.read_journal(path)
    assert n_skipped == 1 and len(recs) == 2
    assert (recs, n_skipped) == jckpt.read_journal(path)
    view = ckpt.journal_view(path)
    assert view.n_skipped == 1 and view.tokens[0] == [5, 6]

    with open(path, "r+b") as f:
        f.seek(0)
        f.write(b"garbage")                 # corrupt the FIRST line
    with pytest.raises(ValueError):
        ckpt.read_journal(path)


def test_trim_complete():
    assert ckpt.trim_complete([3, 4, 9, 5], 8, 9) == [3, 4, 9]  # eos
    assert ckpt.trim_complete([3, 4, 5], 3, 9) == [3, 4, 5]     # budget
    assert ckpt.trim_complete([3, 4], 3, 9) is None             # mid-flight
    assert ckpt.trim_complete([3, 4], 3, None) is None

"""The port's disaggregated fleet (burst_attn_tpu_torch.fleet.FleetCluster)
on CPU members (`"device": "cpu"` in the model spec): a decode replica
SIGKILLed mid-stream, kills mid-KV-transfer in both directions with zero
page leaks, and the socket carrier with every shipped page's digest
matching on both ends — each token-exact against `fleet_oracle`.  Each
run carries its own time limits (start / restart timeouts, max_wall_s)."""

import glob
import json
import os

from burst_attn_tpu_torch.fleet import FleetCluster, FleetFault, fleet_oracle
from burst_attn_tpu_torch.loadgen.trace import Trace, TraceRequest

MODEL_SPEC = dict(vocab=97, d_model=32, n_layers=1, n_heads=2,
                  n_kv_heads=1, d_head=16, d_ff=64, seed=0, device="cpu")
PSPEC = dict(sp=2, page=128, n_pages=4, max_pages_per_seq=8)
DSPEC = dict(sp=2, slots=2, page=128, n_pages=8, max_pages_per_seq=4)
LIMITS = dict(start_timeout_s=120.0, restart_timeout_s=120.0)


def _trace(n, *, prompt_len=128, seed0=100, max_new=4, dt=0.05):
    reqs = [TraceRequest(rid=i, t_arrival=dt * i, prompt_len=prompt_len,
                         prompt_seed=seed0 + i, max_new_tokens=max_new)
            for i in range(n)]
    return Trace(meta={"vocab": 97}, requests=reqs)


def _assert_token_exact(rep, oracle_toks):
    for rid, o in rep.outcomes.items():
        assert o.status == "done", (rid, o)
        assert o.tokens == oracle_toks[rid], (rid, o.tokens, oracle_toks[rid])


def test_fleet_decode_kill_mid_stream_resumes_on_sibling(tmp_path):
    trace = _trace(4, seed0=200, max_new=6)
    oracle, _ = fleet_oracle(trace, MODEL_SPEC, prefill_spec=PSPEC,
                             decode_spec=DSPEC)
    with FleetCluster(MODEL_SPEC, prefill_spec=PSPEC, decode_spec=DSPEC,
                      n_prefill=1, n_decode=2, out_dir=str(tmp_path),
                      checkpoint_every=1, **LIMITS) as fc:
        rep = fc.replay(trace, [FleetFault(t=0.2, pool="decode", worker=0,
                                           kind="kill")],
                        speed=25.0, max_wall_s=120.0)
        boots = list(fc.boot_s)
    _assert_token_exact(rep, oracle)
    assert [k["pool"] for k in rep.kills] == ["decode"]
    assert rep.recovered_tokens_resumed > 0
    assert sorted((b["pool"], b["worker"]) for b in boots) == \
        [("decode", 0), ("decode", 1), ("prefill", 0)]


def test_fleet_kill_mid_transfer_zero_leak_both_directions(tmp_path):
    """The prefill worker dying after page 1 of 2 leaves the replica's
    staging aborted with zero pages leaked, and the request re-runs on a
    sibling; the replica dying after receiving page 1 re-ships the
    router's buffered transfer to a sibling.  Token-exact both ways."""
    trace = _trace(3, prompt_len=256, seed0=300, max_new=5)
    oracle, _ = fleet_oracle(trace, MODEL_SPEC, prefill_spec=PSPEC,
                             decode_spec=DSPEC)
    with FleetCluster(MODEL_SPEC, prefill_spec=PSPEC, decode_spec=DSPEC,
                      n_prefill=2, n_decode=1, out_dir=str(tmp_path / "a"),
                      **LIMITS) as fc:
        rep = fc.replay(trace, [FleetFault(t=0.0, pool="prefill", worker=0,
                                           kind="die_mid_ship", arg=1)],
                        speed=25.0, max_wall_s=120.0)
    _assert_token_exact(rep, oracle)
    aborts = [e for e in rep.transfers["aborts"] if e["kind"] == "abort"]
    assert aborts, rep.transfers
    for e in aborts:  # staging dropped, the pool untouched
        assert e["staged_after"] == 0 and e["avail_after"] >= 1, e
    assert [k["pool"] for k in rep.kills] == ["prefill"]
    with FleetCluster(MODEL_SPEC, prefill_spec=PSPEC, decode_spec=DSPEC,
                      n_prefill=1, n_decode=2, out_dir=str(tmp_path / "b"),
                      **LIMITS) as fc:
        rep = fc.replay(trace, [FleetFault(t=0.0, pool="decode", worker=0,
                                           kind="die_mid_recv", arg=1)],
                        speed=25.0, max_wall_s=120.0)
    _assert_token_exact(rep, oracle)
    assert rep.transfers["reshipped"] >= 1, rep.transfers
    assert [k["pool"] for k in rep.kills] == ["decode"]


def test_fleet_socket_token_exact_digests_match(tmp_path):
    """The socket carrier (the cross-host shape): every request's tokens
    equal the oracle's, and every shipped page's digest, recomputed from
    the replica's own pool after the commit, equals the sender's and the
    oracle's; every member's obs export saw fleet traffic."""
    trace = _trace(4, seed0=200, max_new=6)
    dspec = dict(DSPEC, echo_digests=True)
    oracle, digests = fleet_oracle(trace, MODEL_SPEC, prefill_spec=PSPEC,
                                   decode_spec=dspec)
    with FleetCluster(MODEL_SPEC, prefill_spec=PSPEC, decode_spec=dspec,
                      n_prefill=1, n_decode=2, out_dir=str(tmp_path),
                      transport="socket", **LIMITS) as fc:
        rep = fc.replay(trace, speed=25.0, max_wall_s=120.0)
        fc.stop()
        stopped = dict(fc.stopped)
    _assert_token_exact(rep, oracle)
    assert rep.transfers["committed"] == 4
    assert rep.transfers["digest_checked"] == 4
    assert rep.transfers["digest_mismatch"] == 0
    # every member drained its pool: zero pages leaked on either side
    assert set(stopped) == {("prefill", 0), ("decode", 0), ("decode", 1)}
    for info in stopped.values():
        assert info["pool_free"] == info["pool_usable"], stopped
    assert stopped[("prefill", 0)]["ring_prefills"] == 5  # warm + 4
    names = set()
    for path in glob.glob(os.path.join(str(tmp_path), "obs_*.jsonl")):
        with open(path) as f:
            for line in f:
                names.add(json.loads(line).get("name"))
    assert {"fleet.kv_pages_shipped", "fleet.ring_prefills",
            "fleet.kv_transfers_committed"} <= names
    assert all(len(d) == 1 for d in digests.values())

"""CLI: synthesize traces, replay them, evaluate SLOs (port of
burst_attn_tpu/loadgen/__main__.py).

    python -m burst_attn_tpu_torch.loadgen gen --out build/traces/t.jsonl \
        --n 64 --seed 0 [--vocab 97] [--poison-rate 0.05] ...
    python -m burst_attn_tpu_torch.loadgen replay --trace build/traces/t.jsonl \
        [--workers 2] [--speed 25] [--out-dir build/loadgen] [--device cpu]
    python -m burst_attn_tpu_torch.loadgen slo \
        --obs 'build/loadgen/obs_w*.jsonl' --duration-s 5.0

`replay --workers 1` uses the in-process driver; `--workers N>1` spins
up the fault-injection cluster (without faults — faults are a harness
API, scheduled from tests and scripts, not flags).  The model runs on
the card unless `--device cpu` is given.  Replay always checks the
completed tokens against the single-process oracle and exits 1 on any
corruption, 0 otherwise.
"""

import argparse
import json
import sys


def _cmd_gen(args) -> int:
    from .trace import save_trace, synthesize_trace

    trace = synthesize_trace(
        args.n, seed=args.seed, vocab=args.vocab,
        mean_interarrival_s=args.mean_interarrival_s,
        burst_factor=args.burst_factor, poison_rate=args.poison_rate,
        prompt_len_max=args.prompt_len_max, max_new_max=args.max_new_max,
        label=args.label)
    path = save_trace(trace, args.out)
    print(f"loadgen: wrote {len(trace.requests)} requests "
          f"({trace.duration_s:.3f} virtual s) to {path}")
    return 0


def _default_specs(vocab: int, device=None):
    # head dim 128: the kernels' one head dim, so the same spec runs on
    # the card and (plain versions) on the CPU
    model_spec = dict(vocab=vocab, d_model=64, n_layers=2, n_heads=2,
                      n_kv_heads=1, d_head=128, d_ff=128, seed=0,
                      device=device)
    engine_spec = dict(kind="ragged", slots=4, n_pages=6, page=128,
                       max_pages_per_seq=2, chunk=16, max_queue=32)
    return model_spec, engine_spec


def _cmd_replay(args) -> int:
    from .driver import assert_token_exact, oracle_replay, replay_trace
    from .trace import load_trace
    from .worker import build_engine

    trace = load_trace(args.trace)
    model_spec, engine_spec = _default_specs(trace.vocab, args.device)
    oracle_spec = dict(engine_spec, max_queue=None)
    if args.workers <= 1:
        eng = build_engine(model_spec, engine_spec)
        report = replay_trace(eng, trace, speed=args.speed)
    else:
        from .cluster import LoadGenCluster

        with LoadGenCluster(model_spec, engine_spec,
                            n_workers=args.workers,
                            out_dir=args.out_dir) as cluster:
            report = cluster.replay(trace, speed=args.speed)
    print(f"loadgen: {report.n_done} done, {report.n_rejected} rejected, "
          f"{report.n_shed} shed in {report.wall_s:.2f}s wall "
          f"(speed {report.speed:g})")
    oracle = oracle_replay(trace,
                           lambda: build_engine(model_spec, oracle_spec))
    try:
        assert_token_exact(report.completed(), oracle)
    except AssertionError as e:
        print(f"loadgen: {e}", file=sys.stderr)
        return 1
    print("loadgen: token-exact vs single-process oracle")
    return 0


def _cmd_slo(args) -> int:
    from ..obs.aggregate import merge_files
    from .slo import compute_slo, format_slo

    metrics, _spans, _meta = merge_files(args.obs)
    report = compute_slo(metrics, duration_s=args.duration_s)
    if args.as_json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_slo(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m burst_attn_tpu_torch.loadgen")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="synthesize a replayable trace")
    g.add_argument("--out", required=True)
    g.add_argument("--n", type=int, default=64)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--vocab", type=int, default=97)
    g.add_argument("--mean-interarrival-s", type=float, default=0.05)
    g.add_argument("--burst-factor", type=float, default=8.0)
    g.add_argument("--poison-rate", type=float, default=0.0)
    g.add_argument("--prompt-len-max", type=int, default=64)
    g.add_argument("--max-new-max", type=int, default=48)
    g.add_argument("--label", default="cli")
    g.set_defaults(fn=_cmd_gen)

    r = sub.add_parser("replay", help="replay a trace (driver or cluster) "
                                      "and verify token-exactness")
    r.add_argument("--trace", required=True)
    r.add_argument("--workers", type=int, default=1)
    r.add_argument("--speed", type=float, default=25.0)
    r.add_argument("--out-dir", default="build/loadgen")
    r.add_argument("--device", default=None,
                   help="cpu to run the plain versions on the CPU "
                        "(default: the card)")
    r.set_defaults(fn=_cmd_replay)

    s = sub.add_parser("slo", help="SLO report from merged obs exports")
    s.add_argument("--obs", action="append", required=True, metavar="GLOB")
    s.add_argument("--duration-s", type=float, required=True)
    s.add_argument("--json", action="store_true", dest="as_json")
    s.set_defaults(fn=_cmd_slo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

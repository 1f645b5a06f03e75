"""burstlint CLI for the port:

    python -m burst_attn_tpu_torch.analysis [--json] [--sarif P]
        [--changed-only] [--ast-only] [--disable R] [--list-rules]
        [--cost-json] [--card] [paths...]

Exit status: 0 clean, 1 findings, 2 internal error.  The default run is
the CPU families and needs no card; the rules that need one are reported
as not run.  `--card` adds the card half and fails (exit 2) on a machine
without a CUDA device.
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m burst_attn_tpu_torch.analysis",
        description="burstlint: static ring/protocol/pool/cost verifier "
                    "of the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for the AST rules (default: package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON")
    ap.add_argument("--sarif", metavar="PATH",
                    help="also write findings as SARIF 2.1.0 to PATH "
                         "(CI annotations); stdout output is unchanged")
    ap.add_argument("--changed-only", action="store_true",
                    help="incremental mode: lint files changed since the "
                         "merge-base with the default branch and skip "
                         "dynamic rule families whose watched sources "
                         "are untouched; falls back to a FULL run when "
                         "git is unavailable")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the dynamic families (fast editor hook)")
    ap.add_argument("--disable", action="append", default=[],
                    metavar="RULE", help="disable a rule by name")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    ap.add_argument("--cost-json", action="store_true",
                    help="print the burstcost static resource/roofline "
                         "table (schema burstcost-v2, h100 rows) as JSON "
                         "and exit")
    ap.add_argument("--card", action="store_true",
                    help="add the card half (fused-ring-fused, the "
                         "shared-memory plans against the compiled "
                         "kernels, their SASS accumulators, the sync-debug "
                         "runs and CUDA-graph captures); fails without a "
                         "CUDA device")
    args = ap.parse_args(argv)

    from .core import (RULES, register_all, render, render_sarif,
                       run_analysis)

    if args.list_rules:
        register_all()
        for name in sorted(RULES):
            r = RULES[name]
            print(f"{name:22s} [{r.kind}]  {r.doc}")
        return 0

    if args.cost_json:
        import json

        from . import costmodel

        try:
            print(json.dumps(costmodel.cost_table(), indent=1))
        except Exception as e:  # noqa: BLE001 — CLI boundary
            print(f"burstcost: internal error: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        return 0

    paths = None
    if args.paths:
        from .astlint import default_paths

        paths = []
        for p in args.paths:
            paths += default_paths(p) if os.path.isdir(p) else [p]
    not_run = {}
    try:
        register_all()
        findings = run_analysis(disable=args.disable, ast_only=args.ast_only,
                                paths=paths, changed_only=args.changed_only,
                                card=args.card, not_run=not_run)
    except Exception as e:  # noqa: BLE001 — CLI boundary: report, exit 2
        print(f"burstlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if args.sarif:
        sarif_dir = os.path.dirname(os.path.abspath(args.sarif))
        os.makedirs(sarif_dir, exist_ok=True)
        with open(args.sarif, "w") as fh:
            fh.write(render_sarif(findings))
    print(render(findings, args.as_json, not_run))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""Rule registry, findings, and suppression handling for burstlint (port of
burst_attn_tpu/analysis/core.py).

A rule is a named check registered with @rule; running the analysis invokes
every registered (non-disabled) checker and collects Findings.  Findings
carry file:line so they are clickable in editors and greppable in CI logs.

Suppression: a source line carrying `# burstlint: disable=RULE[,RULE2]`
suppresses those rules' findings for that line (AST rules only — the
dynamic families' findings are anchored to entry-point definitions:
disable those with --disable on the CLI or the `disable` argument of
run_analysis).

Rules that need the card (the `--card` half: `fused-ring-fused`, and the
card half of `kernel-smem-budget`) do not run on a machine without one.
run_analysis records each of them in its `not_run` dict with the reason,
and render() says so: a run without the card is never reported as
having checked them.
"""

import contextlib
import json
import re
from dataclasses import dataclass, asdict
from typing import Callable, Dict, List, Optional

_SUPPRESS_RE = re.compile(r"#\s*burstlint:\s*disable=([\w,\-]+)")


@dataclass
class Finding:
    rule: str
    message: str
    file: str = "<trace>"
    line: int = 0

    def format(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Rule:
    name: str
    kind: str  # "ast" | "trace" | "model" | "cost" | "card"
    doc: str
    checker: Optional[Callable] = None  # astlint: per-tree; others: global


RULES: Dict[str, Rule] = {}


def rule(name: str, kind: str, doc: str):
    """Register a rule.  AST checkers get (tree, src_lines, path) and
    yield Findings; the other families' checkers run from their
    family's check_all()."""

    def deco(fn):
        RULES[name] = Rule(name=name, kind=kind, doc=doc, checker=fn)
        return fn

    return deco


def suppressed_rules(src_line: str) -> List[str]:
    m = _SUPPRESS_RE.search(src_line)
    if not m:
        return []
    return [r.strip() for r in m.group(1).split(",") if r.strip()]


def filter_suppressed(findings: List[Finding], src_lines: List[str]):
    """Drop findings whose anchoring source line disables their rule."""
    out = []
    for f in findings:
        if 1 <= f.line <= len(src_lines):
            if f.rule in suppressed_rules(src_lines[f.line - 1]):
                continue
        out.append(f)
    return out


# Per-family source watchlists for --changed-only: a dynamic family
# re-runs iff some changed file lives under one of its watched
# subpackages.  Each list includes analysis/ so editing a rule always
# re-proves it.
FAMILY_WATCH = {
    "ringcheck": ("ops/", "parallel/", "csrc/", "analysis/"),
    "poolcheck": ("serving/", "models/", "ops/", "analysis/"),
    "protocheck": ("protocols/", "fleet/", "serving/", "models/",
                   "analysis/"),
    "costcheck": ("ops/", "parallel/", "csrc/", "analysis/"),
    "policycheck": ("fleet/", "analysis/"),
}
PACKAGE = "burst_attn_tpu_torch"


def changed_files(root) -> Optional[List[str]]:
    """Absolute paths changed since the merge-base with the default
    branch, plus uncommitted and untracked work.  Returns None when git
    is unavailable or errors — callers MUST fall back to a full run."""
    import os
    import subprocess

    def git(*args):
        return subprocess.run(
            ["git", "-C", root] + list(args), capture_output=True,
            text=True, timeout=30)

    try:
        top = git("rev-parse", "--show-toplevel")
        if top.returncode != 0:
            return None
        repo = top.stdout.strip()
        names = set()
        for branch in ("main", "master"):
            mb = git("merge-base", "HEAD", branch)
            if mb.returncode == 0:
                d = git("diff", "--name-only", mb.stdout.strip(), "HEAD")
                if d.returncode != 0:
                    return None
                names |= set(d.stdout.splitlines())
                break
        for args in (("diff", "--name-only", "HEAD"),
                     ("ls-files", "--others", "--exclude-standard")):
            r = git(*args)
            if r.returncode != 0:
                return None
            names |= set(r.stdout.splitlines())
        return sorted(os.path.join(repo, n) for n in names if n)
    except (OSError, subprocess.SubprocessError):
        return None


def _family_touched(family: str, changed: List[str]) -> bool:
    watch = FAMILY_WATCH.get(family, ())
    return any(f"{PACKAGE}/{w}" in path.replace("\\", "/")
               for path in changed for w in watch)


def register_all() -> None:
    """Import every rule family, so RULES holds all registrations."""
    from . import (astlint, costcheck, policycheck, poolcheck,  # noqa: F401
                   protocheck, ringcheck)


def require_card() -> None:
    """Raise unless a CUDA card is visible: the --card half never skips
    quietly."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "--card runs the analyzer's card half (fused-ring-fused, the "
            "shared-memory plans against the compiled kernels) and needs "
            "a CUDA device; none is visible here")


def run_analysis(root=None, *, disable=(), ast_only=False, paths=None,
                 changed_only=False, card=False,
                 not_run: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Run every registered rule; returns the surviving findings.

    root: package directory to lint (default: this package).  ast_only
    skips the dynamic families (used by fast editor hooks); `paths`
    overrides the AST lint file set.  changed_only restricts the AST
    rules to files changed since the merge-base with the default branch
    and skips dynamic families whose watchlist (FAMILY_WATCH) is
    untouched; when git is unavailable it silently degrades to the full
    run (an incremental lint must never be LESS safe than none).

    card=True adds the card half (raises without a CUDA device);
    otherwise each card rule is entered in `not_run` (when given) with
    the reason it did not run."""
    import os

    from . import astlint

    if card:
        require_card()
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    changed = changed_files(root) if changed_only else None
    incremental = changed_only and changed is not None
    findings: List[Finding] = []
    ast_paths = paths or astlint.default_paths(root)
    if incremental:
        keep = set(changed)
        ast_paths = [p for p in ast_paths if os.path.abspath(p) in keep]
    findings += astlint.lint_paths(ast_paths)
    if not ast_only:
        with _one_thread():
            findings += _run_families(changed if incremental else None, card,
                                      not_run)
    return [f for f in findings if f.rule not in set(disable)]


@contextlib.contextmanager
def _one_thread():
    """The CPU families run tiny shapes: one intra-op thread, so that
    torch's pool neither spins against other processes nor against
    another framework's pool in the same process (restored after)."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _run_families(changed, card, not_run) -> List[Finding]:
    """The dynamic families; `changed` (a changed-file list, or None for
    all) skips the families whose watchlist it does not touch."""
    from . import costcheck, policycheck, poolcheck, protocheck, ringcheck

    findings: List[Finding] = []
    families = (("ringcheck", ringcheck), ("poolcheck", poolcheck),
                ("protocheck", protocheck), ("costcheck", costcheck),
                ("policycheck", policycheck))
    for name, mod in families:
        if changed is not None and not _family_touched(name, changed):
            continue
        findings += mod.check_all()
        if not hasattr(mod, "check_card"):
            continue
        if card:
            findings += mod.check_card()
        elif not_run is not None:
            not_run.update(mod.CARD_RULES)
    return findings


def render(findings: List[Finding], as_json: bool,
           not_run: Optional[Dict[str, str]] = None) -> str:
    not_run = dict(not_run or {})
    if as_json:
        return json.dumps(
            {
                "rules_registered": sorted(RULES),
                "n_findings": len(findings),
                "findings": [asdict(f) for f in findings],
                "not_run": not_run,
            },
            indent=1,
        )
    if not findings:
        out = (f"burstlint: clean "
               f"({len(RULES)} rules: {', '.join(sorted(RULES))})")
        if not_run:
            out += "; NOT RUN here (never counted clean): " + "; ".join(
                f"{r}: {why}" for r, why in sorted(not_run.items()))
        return out
    lines = [f.format() for f in findings]
    lines.append(f"burstlint: {len(findings)} finding(s)")
    if not_run:
        lines.append("not run here: " + ", ".join(sorted(not_run)))
    return "\n".join(lines)


def render_sarif(findings: List[Finding]) -> str:
    """SARIF 2.1.0 — the schema CI annotation uploaders consume; the
    JAX package's shape (tests/test_torch_analysis.py round-trips both)."""
    import os

    def location(f: Finding):
        uri = f.file
        if os.path.isabs(uri):
            uri = os.path.relpath(uri, os.getcwd())
        return {
            "physicalLocation": {
                "artifactLocation": {"uri": uri.replace(os.sep, "/")},
                "region": {"startLine": max(1, f.line)},
            }
        }

    sarif = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "burstlint",
                "informationUri":
                    "https://example.invalid/burst-attn-tpu/docs/analysis",
                "rules": [{"id": name,
                           "shortDescription": {"text": RULES[name].doc},
                           "properties": {"kind": RULES[name].kind}}
                          for name in sorted(RULES)],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [location(f)],
            } for f in findings],
        }],
    }
    return json.dumps(sarif, indent=1)

"""policy-pure: fleet/policy.py is AST-provably pure (port of
burst_attn_tpu/analysis/policycheck.py).

The simulator (fleet/sim.py) and the fleet's router (fleet/fleet.py)
execute the same policy functions, and the fidelity gate compares the
simulator with measured runs: both rest on those functions being pure
functions of their arguments.  A policy that reads the wall clock
simulates differently than it serves; one that draws from a global RNG
is unreplayable; one that accumulates module state gives different
answers on the second sweep; one that touches transport is a scheduler,
not a policy.

So the contract is proven structurally over the module source, zero
suppressions:

  imports      only `typing` (and the purity-neutral stdlib allowlist:
               dataclasses / collections / math / __future__) may be
               imported — transport, time, numpy, torch, random, os, obs
               are all unimportable, which bans whole capability classes
               (sockets, clocks, RNGs, filesystems) at the import site;
  calls        no call rooted at `time` / `datetime` / `random` /
               `np.random` / `numpy.random`, and no `__import__` /
               `eval` / `exec` / `open` escape hatches — belt and
               braces for anything smuggled past the import rule;
  statements   no `global` / `nonlocal` — tick counters thread through
               arguments and return values (see policy.autoscale);
  module state no function may rebind, aug-assign, subscript-assign,
               attribute-assign, delete, or call a known mutator
               (.append/.update/.add/.pop/...) on a module-level
               binding — module constants stay constants.

`check_policy_source` is the seam the mutation tests drive: feed it the
real source with a smuggled `time.time()` or a module-level counter
bump and the rule must fire (tests/test_torch_analysis.py)."""

import ast
import os
from typing import List, Optional, Set

from .core import Finding, rule

rule("policy-pure", "ast",
     "fleet/policy.py imports only typing-tier modules, calls no "
     "clock/RNG/import escape hatch, declares no global/nonlocal, and "
     "never mutates a module-level binding — the sim and the fleet "
     "provably execute the same pure functions")(None)

_POLICY_REL = os.path.join("fleet", "policy.py")

# the purity-neutral allowlist: types and pure math only.  Everything
# interesting (time, random, numpy, os, socket, multiprocessing, obs,
# any package transport module) is banned by omission.
_ALLOWED_IMPORTS = frozenset(
    {"typing", "dataclasses", "collections", "math", "__future__"})

# call roots that mean wall clock / RNG / dynamic escape regardless of
# how the name arrived in scope
_BANNED_CALL_ROOTS = frozenset({"time", "datetime", "random"})
_BANNED_CALL_NAMES = frozenset({"__import__", "eval", "exec", "open",
                                "compile", "globals"})

# attribute calls that mutate their receiver in place
_MUTATOR_ATTRS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "add", "discard", "setdefault", "popitem", "sort", "reverse",
    "__setitem__", "__delitem__"})


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of a Name/Attribute/Subscript/Call chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _module_bindings(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                for node in ast.walk(tgt):
                    if isinstance(node, ast.Name):
                        names.add(node.id)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(stmt.target, ast.Name):
                names.add(stmt.target.id)
        elif isinstance(stmt, ast.Import):
            for alias in stmt.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(stmt, ast.ImportFrom):
            for alias in stmt.names:
                names.add(alias.asname or alias.name)
        elif isinstance(stmt, ast.Try):  # the Protocol fallback idiom
            for sub in stmt.body + [h for hd in stmt.handlers
                                    for h in hd.body]:
                if isinstance(sub, ast.ImportFrom):
                    for alias in sub.names:
                        names.add(alias.asname or alias.name)
                elif isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
    return names


class _FuncScan(ast.NodeVisitor):
    """Walk one function body; record purity violations."""

    def __init__(self, path: str, fn_name: str, module_names: Set[str],
                 findings: List[Finding]):
        self.path = path
        self.fn = fn_name
        self.module_names = module_names
        self.findings = findings
        self.local: Set[str] = set()

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            rule="policy-pure", file=self.path,
            line=getattr(node, "lineno", 0),
            message=f"{self.fn}: {what} — policy functions must be pure "
                    "functions of their arguments (fleet/policy.py "
                    "docstring); the sim's fidelity gate is void "
                    "otherwise"))

    # locals tracking: a module-name shadowed by assignment or an
    # argument is local, mutating it is fine
    def visit_arg(self, node: ast.arg) -> None:
        self.local.add(node.arg)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_target(tgt, kind="assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, kind="augmented assignment")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_target(node.target, kind="assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._check_target(tgt, kind="delete")
        self.generic_visit(node)

    def _check_target(self, tgt: ast.AST, *, kind: str) -> None:
        if isinstance(tgt, ast.Name):
            self.local.add(tgt.id)  # plain rebind creates a local
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._check_target(el, kind=kind)
            return
        root = _root_name(tgt)
        if root is not None and root in self.module_names \
                and root not in self.local:
            self._flag(tgt, f"{kind} through module-level binding "
                            f"`{root}` mutates module state")

    def visit_Global(self, node: ast.Global) -> None:
        self._flag(node, "`global` statement")

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._flag(node, "`nonlocal` statement")

    def visit_Import(self, node: ast.Import) -> None:
        self._flag(node, "function-local import")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self._flag(node, "function-local import")

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        root = chain.split(".")[0] if chain else None
        if isinstance(node.func, ast.Name) \
                and node.func.id in _BANNED_CALL_NAMES:
            self._flag(node, f"call to `{node.func.id}` (dynamic "
                             "import / exec escape hatch)")
        elif root in _BANNED_CALL_ROOTS and root not in self.local:
            self._flag(node, f"call rooted at `{chain}` (wall clock / "
                             "RNG)")
        elif chain.startswith(("np.random.", "numpy.random.")):
            self._flag(node, f"call rooted at `{chain}` (global RNG)")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATOR_ATTRS:
            recv_root = _root_name(node.func.value)
            if recv_root is not None and recv_root in self.module_names \
                    and recv_root not in self.local:
                self._flag(node, f"`.{node.func.attr}()` on "
                                 f"module-level binding `{recv_root}` "
                                 "mutates module state")
        self.generic_visit(node)

    # nested defs get their own scan with an inherited local set
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scan_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._scan_nested(node)

    def _scan_nested(self, node) -> None:
        self.local.add(node.name)
        sub = _FuncScan(self.path, f"{self.fn}.{node.name}",
                        self.module_names, self.findings)
        sub.local = set(self.local)
        for arg_node in ast.walk(node.args):
            if isinstance(arg_node, ast.arg):
                sub.local.add(arg_node.arg)
        for stmt in node.body:
            sub.visit(stmt)


def check_policy_source(src: str, path: str = _POLICY_REL
                        ) -> List[Finding]:
    """Prove one policy-module source pure.  The mutation-test seam:
    tests feed doctored source here and assert the rule fires."""
    findings: List[Finding] = []
    tree = ast.parse(src, filename=path)

    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                top = alias.name.split(".")[0]
                if top not in _ALLOWED_IMPORTS:
                    findings.append(Finding(
                        rule="policy-pure", file=path, line=stmt.lineno,
                        message=f"import of `{alias.name}` — policy "
                                "modules may import only "
                                f"{sorted(_ALLOWED_IMPORTS)} (bans "
                                "clocks, RNGs, transport, and "
                                "filesystems at the import site)"))
        elif isinstance(stmt, ast.ImportFrom):
            top = (stmt.module or "").split(".")[0]
            if stmt.level == 0 and top not in _ALLOWED_IMPORTS:
                findings.append(Finding(
                    rule="policy-pure", file=path, line=stmt.lineno,
                    message=f"import from `{stmt.module}` — policy "
                            "modules may import only "
                            f"{sorted(_ALLOWED_IMPORTS)}"))
            elif stmt.level > 0:
                findings.append(Finding(
                    rule="policy-pure", file=path, line=stmt.lineno,
                    message="relative import — a policy module must "
                            "not reach into the package (transport, "
                            "obs, and engines live there)"))

    module_names = _module_bindings(tree)

    def scan_functions(body, prefix: str = "") -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scanner = _FuncScan(path, prefix + stmt.name,
                                    module_names, findings)
                for arg_node in ast.walk(stmt.args):
                    if isinstance(arg_node, ast.arg):
                        scanner.local.add(arg_node.arg)
                for sub in stmt.body:
                    scanner.visit(sub)
            elif isinstance(stmt, ast.ClassDef):
                scan_functions(stmt.body, prefix=prefix + stmt.name + ".")

    scan_functions(tree.body)
    return findings


def check_all() -> List[Finding]:
    """Run policy-pure over the real fleet/policy.py source."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(os.path.dirname(here), "fleet", "policy.py")
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    rel = os.path.relpath(path, os.path.dirname(os.path.dirname(here)))
    return check_policy_source(src, rel)

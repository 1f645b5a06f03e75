"""AST-level lint rules over the port's source (port of
burst_attn_tpu/analysis/astlint.py).

Rules (each individually suppressible with `# burstlint: disable=RULE` on
the offending line):

  silent-except        except handler whose body is only `pass`: swallowed
                       errors must at least log.
  mesh-shape-index     mesh.shape[axis] hard indexing: require
                       mesh.shape.get(axis, 1) — a mesh without the axis
                       means "not parallelized over it".
  host-transfer-in-jit .item() / .cpu() / .tolist() / .numpy() / a
                       synchronize, or float() / int() / bool() of a
                       tensor, inside a captured function: a host sync,
                       which a CUDA graph capture refuses (or, where the
                       value was read before the capture, a number frozen
                       into every replay).
  time-in-jit          time.* called inside a captured function: read once
                       while capturing, never at replay.
  traced-bool-branch   Python `if`/`while` on a tensor expression inside a
                       captured function: a host sync to decide, and the
                       branch the capture took is the only one a replay
                       runs.
  obs-jit-safe         any call through an obs binding (the port's metrics
                       registry / span tracer / obs logger,
                       burst_attn_tpu_torch.obs) inside a captured
                       function: it runs once while capturing and never at
                       replay.  `obs.devstats` keeps its exemption by name:
                       its functions are tensor arithmetic on the device.

The rule names are the JAX package's, so the two registries compare name
for name.  There a "jit-traced" function is one jax traces; the port
traces nothing with a tracer, and its one traced context is the CUDA
graph capture: the body of a `with torch.cuda.graph(...)` block
(serving/model.py DecodeGraphs._capture) and — transitively, across the
package's modules through their imports — every function it calls.  A
call the index cannot resolve (a method of another object, a library)
is not followed: fewer false positives beats exhaustiveness, the card
tests capture the real graphs.  `torch.utils.checkpoint` is NOT a traced
context here (it re-runs Python eagerly), so the host `int()` of a mesh
size in models/transformer.py stays quiet.
"""

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import PACKAGE, Finding, filter_suppressed, rule

# tensor methods whose result lives on the device: float()/int()/bool()
# of, or a branch on, an expression calling one is a host sync
_TENSOR_METHODS = frozenset({
    "sum", "max", "min", "mean", "amax", "amin", "any", "all", "norm",
    "argmax", "argmin", "prod", "std", "var", "count_nonzero", "nonzero",
    "eq", "ne", "gt", "lt", "ge", "le", "isnan", "isfinite", "equal",
    "allclose", "abs", "float", "long", "to", "clone", "gather",
    "masked_fill", "where"})
# call roots that are host libraries, never tensors
_HOST_ROOTS = frozenset({"np", "numpy", "math", "os", "sys", "json",
                         "time", "dict", "list", "tuple", "str"})
# torch functions that return host objects, not tensors
_HOST_TORCH = frozenset({"device", "dtype", "finfo", "iinfo", "is_tensor",
                         "is_floating_point", "Size", "get_default_dtype",
                         "is_grad_enabled", "Generator"})
# method calls that read a device tensor back to the host
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy",
                           "synchronize"})


# every node of a parsed file, walked once per lint run and shared by the
# rules (the walks dominate the run time)
_NODES: Dict[int, List[ast.AST]] = {}


def _all_nodes(tree) -> List[ast.AST]:
    nodes = _NODES.get(id(tree))
    if nodes is None:
        nodes = _NODES[id(tree)] = list(ast.walk(tree))
    return nodes


def default_paths(root: str) -> List[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def _tail_name(node) -> str:
    """Last attribute segment of a Name/Attribute chain ('torch.cuda.graph'
    -> 'graph')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _root_name(node) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _deep_root(node) -> str:
    """Leftmost Name of an attribute/call/subscript chain:
    `obs.counter("x").inc(...)` -> "obs"."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    return node.id if isinstance(node, ast.Name) else ""


def _chain(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_capture(expr) -> bool:
    """`torch.cuda.graph(...)` (any spelling ending in cuda.graph, or a
    bare `graph(...)` imported from torch.cuda)."""
    if not isinstance(expr, ast.Call):
        return False
    chain = _chain(expr.func)
    return chain.endswith("cuda.graph") or chain == "graph"


def _tensorish(node) -> bool:
    """Heuristic: the expression computes on a tensor (a call rooted at
    `torch` that makes a tensor — not torch.device, torch.cuda.*, ... —
    or a tensor method call on something that is not a host library)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        root = _deep_root(sub.func)
        if root == "torch":
            chain = _chain(sub.func)
            if not (chain.startswith(("torch.cuda.", "torch.backends."))
                    or _tail_name(sub.func) in _HOST_TORCH):
                return True
            continue
        if (isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _TENSOR_METHODS
                and root not in _HOST_ROOTS):
            return True
    return False


# ---------------------------------------------------------------------------
# the package index: modules, their defs and imports, for the capture
# closure across files


class _Module:
    def __init__(self, path: str, tree: ast.Module, name: Optional[str]):
        self.path, self.tree, self.name = path, tree, name
        self.defs: Dict[str, List[ast.AST]] = {}
        # local name -> ("mod", dotted module) | ("sym", dotted module, name)
        self.imports: Dict[str, Tuple] = {}
        for node in _all_nodes(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
        for node in tree.body:
            self._note_import(node)

    def _resolve_from(self, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        if self.name is None:
            return None
        pkg = self.name.split(".")
        # a module's package is its name minus the last part (an
        # __init__ module's name is the package itself)
        if not self.path.endswith("__init__.py"):
            pkg = pkg[:-1]
        up = node.level - 1
        if up > len(pkg):
            return None
        base = pkg[:len(pkg) - up]
        return ".".join(base + ([node.module] if node.module else []))

    def _note_import(self, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    self.imports[a.asname] = ("mod", a.name)
                else:
                    top = a.name.split(".")[0]
                    self.imports[top] = ("mod", top)
        elif isinstance(node, ast.ImportFrom):
            base = self._resolve_from(node)
            if base is None:
                return
            for a in node.names:
                self.imports[a.asname or a.name] = ("sym", base, a.name)


def _module_name(path: str) -> Optional[str]:
    """Dotted module name of `path` if it lies inside the port's package."""
    parts = os.path.abspath(path).split(os.sep)
    if PACKAGE not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
    mod = parts[i:]
    mod[-1] = mod[-1][:-3] if mod[-1].endswith(".py") else mod[-1]
    if mod[-1] == "__init__":
        mod = mod[:-1]
    return ".".join(mod)


class _Index:
    def __init__(self, modules: List[_Module]):
        self.modules = modules
        self.by_name = {m.name: m for m in modules if m.name}

    def _lookup(self, mod: str, name: str) -> List[Tuple[_Module, ast.AST]]:
        m = self.by_name.get(mod)
        if m is not None:
            return [(m, d) for d in m.defs.get(name, ())
                    if d in m.tree.body]  # top-level functions only
        return []

    def callees(self, m: _Module, call: ast.Call):
        """The defs a call resolves to: a def of the same module, a
        function imported by name, a function of an imported module, or
        a method called on self."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in m.defs:
                return [(m, d) for d in m.defs[f.id]]
            imp = m.imports.get(f.id)
            if imp and imp[0] == "sym":
                return self._lookup(imp[1], imp[2])
            return []
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base = f.value.id
            if base == "self":
                return [(m, d) for d in m.defs.get(f.attr, ())]
            imp = m.imports.get(base)
            if imp is None:
                return []
            dotted = imp[1] if imp[0] == "mod" else f"{imp[1]}.{imp[2]}"
            return self._lookup(dotted, f.attr)
        return []


def _captured(index: _Index) -> Dict[str, List[ast.AST]]:
    """path -> the captured nodes of that file: each `with
    torch.cuda.graph(...)` body statement and every function reachable
    from one (nested defs and lambdas of a captured function included)."""
    marked: Dict[int, Tuple[_Module, ast.AST]] = {}
    work: List[Tuple[_Module, ast.AST]] = []

    def mark(m, node):
        if id(node) not in marked:
            marked[id(node)] = (m, node)
            work.append((m, node))

    for m in index.modules:
        for node in _all_nodes(m.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_capture(it.context_expr) for it in node.items):
                for stmt in node.body:
                    mark(m, stmt)
    while work:
        m, node = work.pop()
        for sub in ast.walk(node):
            if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                mark(m, sub)
            elif isinstance(sub, ast.Call):
                for cm, d in index.callees(m, sub):
                    mark(cm, d)
    out: Dict[str, List[ast.AST]] = {}
    for m, node in marked.values():
        out.setdefault(m.path, []).append(node)
    return out


def _iter_captured(nodes: Iterable[ast.AST]):
    seen = set()
    for ctx in nodes:
        for sub in ast.walk(ctx):
            if id(sub) in seen:
                continue
            seen.add(id(sub))
            yield sub


# ---------------------------------------------------------------------------
# rules


def _is_broad_handler(node: ast.ExceptHandler) -> bool:
    """Bare `except:` or except Exception/BaseException (incl. in tuples).
    Narrow typed handlers (ValueError, StopIteration, ...) with pass-only
    bodies are idiomatic flow control and stay exempt."""
    if node.type is None:
        return True
    types = (node.type.elts if isinstance(node.type, ast.Tuple)
             else [node.type])
    return any(_tail_name(t) in ("Exception", "BaseException")
               for t in types)


@rule("silent-except", "ast",
      "except handler whose body is only `pass` — swallowed errors must log")
def _check_silent_except(tree, src_lines, path, captured=()):
    for node in _all_nodes(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad_handler(node):
            continue
        body = [s for s in node.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        if all(isinstance(s, ast.Pass) for s in body):
            yield Finding(
                rule="silent-except", file=path, line=node.lineno,
                message="exception swallowed with bare `pass` — log it "
                        "(logger.warning) or suppress with a justification",
            )


@rule("mesh-shape-index", "ast",
      "mesh.shape[axis] hard indexing — use mesh.shape.get(axis, 1)")
def _check_mesh_shape_index(tree, src_lines, path, captured=()):
    for node in _all_nodes(tree):
        if not isinstance(node, ast.Subscript):
            continue
        v = node.value
        if not (isinstance(v, ast.Attribute) and v.attr == "shape"):
            continue
        base = v.value
        base_name = (base.id if isinstance(base, ast.Name)
                     else base.attr if isinstance(base, ast.Attribute) else "")
        if "mesh" in base_name.lower():
            yield Finding(
                rule="mesh-shape-index", file=path, line=node.lineno,
                message=f"{base_name}.shape[...] hard indexing — a missing "
                        "axis should mean size 1: use .shape.get(axis, 1)",
            )


@rule("host-transfer-in-jit", "ast",
      ".item()/.cpu()/.tolist()/synchronize or float()/int() of a tensor "
      "inside a CUDA-graph-captured function")
def _check_host_transfer(tree, src_lines, path, captured=()):
    for sub in _iter_captured(captured):
        if not isinstance(sub, ast.Call):
            continue
        tail = _tail_name(sub.func)
        if isinstance(sub.func, ast.Attribute) and tail in _SYNC_METHODS:
            what = f".{tail}()"
        elif (isinstance(sub.func, ast.Name)
              and sub.func.id in ("float", "int", "bool") and sub.args
              and _tensorish(sub.args[0])):
            what = f"{sub.func.id}() of a tensor"
        else:
            continue
        yield Finding(
            rule="host-transfer-in-jit", file=path, line=sub.lineno,
            message=f"{what} inside a CUDA-graph-captured function is a "
                    "host sync (the capture refuses it) or a value frozen "
                    "into every replay — keep values on the device",
        )


@rule("time-in-jit", "ast",
      "time.* call inside a CUDA-graph-captured function — read once at "
      "capture, never at replay")
def _check_time_in_jit(tree, src_lines, path, captured=()):
    for sub in _iter_captured(captured):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and _root_name(sub.func) == "time"):
            yield Finding(
                rule="time-in-jit", file=path, line=sub.lineno,
                message=f"time.{sub.func.attr}() inside a CUDA-graph-"
                        "captured function is read once while capturing, "
                        "never when the graph replays",
            )


@rule("traced-bool-branch", "ast",
      "Python if/while on a tensor expression inside a CUDA-graph-captured "
      "function")
def _check_traced_bool(tree, src_lines, path, captured=()):
    for sub in _iter_captured(captured):
        if isinstance(sub, (ast.If, ast.While)) and _tensorish(sub.test):
            yield Finding(
                rule="traced-bool-branch", file=path, line=sub.lineno,
                message="Python branch on a tensor inside a captured "
                        "function — a host sync to decide, and every "
                        "replay runs the branch the capture took; use "
                        "torch.where",
            )


def _obs_bound_names(tree) -> Set[str]:
    """Module-level names bound to the obs subsystem: imports of
    burst_attn_tpu_torch.obs (any spelling/level) and top-level
    assignments whose value is rooted at one of those names (e.g.
    `_C = obs.counter("c")`).

    `obs.devstats` is EXEMPT by name: tensor arithmetic on the device
    with no registry, span or clock access (the scan ring reduces its
    state on the device without a host sync)."""
    bound: Set[str] = set()
    for node in _all_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if "obs" in parts and "devstats" not in parts:
                    bound.add(a.asname or parts[0])
        elif isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".")
            if "devstats" in parts:
                continue
            if "obs" in parts:
                bound.update(a.asname or a.name for a in node.names
                             if a.name != "devstats")
            else:  # `from .. import obs` / `from burst_attn_tpu_torch import obs`
                bound.update(a.asname or a.name for a in node.names
                             if a.name == "obs")
    for node in tree.body:  # module level only: metric singletons + aliases
        if isinstance(node, ast.Assign) \
                and isinstance(node.value,
                               (ast.Call, ast.Name, ast.Attribute)) \
                and _deep_root(node.value) in bound:
            bound.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return bound


@rule("obs-jit-safe", "ast",
      "obs registry/span/logger calls must not be reachable from a CUDA "
      "graph capture (obs.devstats exempt by name)")
def _check_obs_jit_safe(tree, src_lines, path, captured=()):
    bound = _obs_bound_names(tree)
    if not bound:
        return
    seen = set()  # one finding per line: `obs.counter("x").inc()` nests calls
    for sub in _iter_captured(captured):
        if isinstance(sub, ast.Call) and _deep_root(sub.func) in bound \
                and sub.lineno not in seen:
            seen.add(sub.lineno)
            yield Finding(
                rule="obs-jit-safe", file=path, line=sub.lineno,
                message=f"obs call `{_deep_root(sub.func)}…` inside a "
                        "CUDA-graph-captured function runs once while "
                        "capturing and never at replay; hoist it to the "
                        "host dispatch boundary",
            )


_AST_RULES = (_check_silent_except, _check_mesh_shape_index,
              _check_host_transfer, _check_time_in_jit, _check_traced_bool,
              _check_obs_jit_safe)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint the files together: the capture closure follows calls across
    every file of the set that lies inside the package."""
    findings: List[Finding] = []
    modules, sources = [], {}
    _NODES.clear()
    for p in paths:
        with open(p, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=p)
        except SyntaxError as e:
            findings.append(Finding(rule="parse-error", file=p,
                                    line=e.lineno or 0,
                                    message=f"syntax error: {e.msg}"))
            continue
        modules.append(_Module(p, tree, _module_name(p)))
        sources[p] = src.split("\n")
    captured = _captured(_Index(modules))
    for m in modules:
        got: List[Finding] = []
        for checker in _AST_RULES:
            got += list(checker(m.tree, sources[m.path], m.path,
                                captured.get(m.path, ())))
        findings += filter_suppressed(got, sources[m.path])
    _NODES.clear()
    return findings


def lint_file(path: str) -> List[Finding]:
    return lint_paths([path])

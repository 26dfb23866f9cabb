"""Repo-specific AST lints over ``src/repro_torch/``.

The reference's four rules (``repro.analysis.lint``), each tuned to a
guarantee the generic linters cannot state:

* ``untyped-except`` — no bare ``except:`` / ``except Exception`` /
  ``except BaseException`` without an explicit ``# noqa`` on the handler
  line. Swallowing everything hides shape and device bugs.
* ``host-call-in-round-path`` — a round is a pure function of ``(state,
  batches, key)``: every draw comes from a generator seeded through
  ``fold_in`` (``fl.round.client_generator``, ``fl.faults``, the engine's
  batchers). Eager PyTorch freezes nothing at trace time, so the rule
  flags, in every function reachable from the round-path roots
  (``build_fl_round``, ``local_train``, ``aggregate``, ``server_update``,
  the ``CompressionStrategy`` methods):

  - wall-clock reads: ``time.*`` and ``datetime.*.now``/``utcnow``/
    ``today``;
  - host RNG: stdlib ``random.*`` and ``np.random.*``;
  - torch's global RNG: ``torch.manual_seed`` and its kin
    (``GLOBAL_SEEDERS``) always, and a draw (``GLOBAL_DRAWS``, or one of
    the in-place ``INPLACE_DRAWS`` methods on any tensor) whenever the call
    passes no ``generator=`` keyword.

  Keywords are read from the AST, so a draw spread over several lines is
  judged by its own call. Reachability is the reference's name-based
  over-approximation pruned by module imports: a call edge from a function
  in module M resolves to every same-named definition in M or a module M
  imports (dunder names excluded). Nothing reachable is exempt. The
  ``obs`` package's phase spans sit on the round path
  (``make_client_step``'s step, the server phase), but their clock is the
  tracer's injected callable (``Tracer._clock``), which the name index
  never resolves to a definition, and it only stamps span records: it
  never feeds a round's values.
* ``registry-kind-ids`` — every ``@register_strategy("k")`` kind has a
  wire kind-id in ``comm/frame.py``'s ``KIND_IDS`` literal.
* ``public-api-exports`` — package ``__all__`` literals match the GOLDEN
  pins in ``tests/test_torch_public_api.py``; a package without
  ``__all__`` is governed by that test alone.

Everything operates on a ``{path: source}`` mapping so the negative tests
(``tests/test_torch_analysis.py``) can lint synthetic snippets without
touching disk.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
PACKAGE = "repro_torch"
GOLDEN_TEST = os.path.join(REPO, "tests", "test_torch_public_api.py")

# round-path roots: the functions/classes whose transitive callees must
# keep a round a pure function of (state, batches, key)
ROUND_PATH_ROOTS = ("build_fl_round", "local_train", "aggregate",
                    "server_update")
ROUND_PATH_BASE_CLASSES = ("CompressionStrategy",)

# wall clock and host RNG: any call into these modules
BANNED_MODULES = ("time", "random", "numpy.random")
# datetime's wall-clock reads
DATETIME_NOW = ("now", "utcnow", "today")
# calls that reseed torch's global RNG: flagged always
GLOBAL_SEEDERS = ("torch.manual_seed", "torch.seed", "torch.random.seed",
                  "torch.random.manual_seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed",
                  "torch.cuda.seed_all")
# draws from torch's global RNG unless given generator=
GLOBAL_DRAWS = ("torch.rand", "torch.randn", "torch.randint",
                "torch.randperm", "torch.normal", "torch.bernoulli",
                "torch.multinomial", "torch.poisson", "torch.rand_like",
                "torch.randn_like", "torch.randint_like")
INPLACE_DRAWS = ("uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "log_normal_", "cauchy_")
# call names that never resolve through the name index: super().__init__
# (and dunders generally) would edge to every same-named method in the repo
_SKIP_CALL_NAMES = {n for n in dir(object)} | {"__init__", "__call__"}


def collect_sources(root: Optional[str] = None) -> Dict[str, str]:
    """``{relpath: source}`` for every ``.py`` under ``src/repro_torch/``."""
    root = root or os.path.join(REPO, "src", PACKAGE)
    out: Dict[str, str] = {}
    for dirpath, _, names in sorted(os.walk(root)):
        for n in sorted(names):
            if not n.endswith(".py"):
                continue
            p = os.path.join(dirpath, n)
            with open(p, "r") as f:
                out[os.path.relpath(p, REPO)] = f.read()
    return out


def _parse_all(files: Dict[str, str]) -> Dict[str, ast.Module]:
    trees = {}
    for path, src in files.items():
        try:
            trees[path] = ast.parse(src)
        except SyntaxError as e:
            raise SyntaxError(f"{path}: {e}") from e
    return trees


# ---------------------------------------------------------------------------
# rule: untyped-except
# ---------------------------------------------------------------------------


def _is_broad(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = []
    for node in (t.elts if isinstance(t, ast.Tuple) else [t]):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return any(n in ("Exception", "BaseException") for n in names)


def check_untyped_except(files: Dict[str, str],
                         trees: Dict[str, ast.Module]) -> Tuple[int, List[str]]:
    evaluated = 0
    viol: List[str] = []
    for path, tree in trees.items():
        lines = files[path].splitlines()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            evaluated += 1
            if not _is_broad(node):
                continue
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if "# noqa" in line:
                continue
            viol.append(f"{path}:{node.lineno}: broad except "
                        f"({ast.unparse(node.type) if node.type else 'bare'})"
                        f" without a # noqa justification")
    return evaluated, viol


# ---------------------------------------------------------------------------
# rule: host-call-in-round-path
# ---------------------------------------------------------------------------


def _module_name(path: str) -> str:
    """'src/repro_torch/comm/frame.py' -> 'repro_torch.comm.frame'."""
    parts = path.replace(os.sep, "/").split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


def _imports_of(tree: ast.Module, mod_name: str, is_pkg: bool) -> Set[str]:
    """Fully-qualified module names this module imports (repo + external),
    relative imports resolved against ``mod_name``."""
    mods: Set[str] = set()
    parts = mod_name.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mods.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                drop = node.level - (1 if is_pkg else 0)
                base = parts[:len(parts) - drop] if drop else parts
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            mods.add(mod)
            for a in node.names:           # `from pkg import submodule`
                mods.add(f"{mod}.{a.name}")
    return mods


def _name_map(tree: ast.Module) -> Dict[str, str]:
    """Local name -> the fully qualified name it is bound to by an import:
    ``import numpy as np`` -> 'numpy', ``import torch.distributed as
    dist`` -> 'torch.distributed', ``from time import monotonic`` ->
    'time.monotonic'."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom) and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _dotted(f: ast.expr, names: Dict[str, str]) -> Optional[str]:
    """The called name with its head resolved through the imports
    ('np.random.rand' -> 'numpy.random.rand'); None for a call on a
    computed value or an unimported local."""
    attrs: List[str] = []
    while isinstance(f, ast.Attribute):
        attrs.append(f.attr)
        f = f.value
    if not isinstance(f, ast.Name) or f.id not in names:
        return None
    return ".".join([names[f.id]] + attrs[::-1])


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _impure_call(call: ast.Call, names: Dict[str, str]) -> Optional[str]:
    """What makes ``call`` impure, or None."""
    full = _dotted(call.func, names)
    if full is not None:
        if any(full == m or full.startswith(m + ".")
               for m in BANNED_MODULES):
            return full
        if full.startswith("datetime.") and \
                full.rsplit(".", 1)[-1] in DATETIME_NOW:
            return full
        if full in GLOBAL_SEEDERS:
            return f"{full} (reseeds torch's global RNG)"
        if full in GLOBAL_DRAWS and not _has_generator(call):
            return f"{full} without generator= (torch's global RNG)"
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in INPLACE_DRAWS \
            and not _has_generator(call):
        return f".{f.attr} without generator= (torch's global RNG)"
    return None


class _FnInfo:
    __slots__ = ("path", "mod", "node", "names", "calls")

    def __init__(self, path: str, mod: str, node: ast.AST,
                 names: Dict[str, str]):
        self.path = path
        self.mod = mod
        self.node = node
        self.names = names
        self.calls: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Name):
                    self.calls.add(f.id)
                elif isinstance(f, ast.Attribute):
                    self.calls.add(f.attr)


def _function_index(trees: Dict[str, ast.Module]
                    ) -> Tuple[Dict[str, List[_FnInfo]], List[_FnInfo],
                               Dict[str, Set[str]]]:
    """Name -> defs index, the root set, and the module import graph."""
    index: Dict[str, List[_FnInfo]] = {}
    roots: List[_FnInfo] = []
    imports: Dict[str, Set[str]] = {}
    for path, tree in trees.items():
        mod = _module_name(path)
        imports[mod] = _imports_of(tree, mod, path.endswith("__init__.py"))
        names = _name_map(tree)

        def add(node, *, is_root):
            info = _FnInfo(path, mod, node, names)
            index.setdefault(node.name, []).append(info)
            if is_root:
                roots.append(info)

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(node, is_root=node.name in ROUND_PATH_ROOTS)
            elif isinstance(node, ast.ClassDef):
                bases = {b.id if isinstance(b, ast.Name) else
                         getattr(b, "attr", "") for b in node.bases}
                strategic = (node.name in ROUND_PATH_BASE_CLASSES
                             or bool(bases & set(ROUND_PATH_BASE_CLASSES))
                             or any(any(r.node.name == b for r in roots
                                        if isinstance(r.node, ast.ClassDef))
                                    for b in bases))
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        add(sub, is_root=(strategic
                                          or sub.name in ROUND_PATH_ROOTS))
                if strategic:   # keep subclass chains resolvable by name
                    roots.append(_FnInfo(path, mod, node, names))
    return index, roots, imports


def _reachable(index: Dict[str, List[_FnInfo]], roots: List[_FnInfo],
               imports: Dict[str, Set[str]]) -> List[_FnInfo]:
    seen: Set[int] = set()
    out: List[_FnInfo] = []
    stack = [r for r in roots if not isinstance(r.node, ast.ClassDef)]
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        visible = imports.get(fn.mod, set()) | {fn.mod}
        for name in fn.calls:
            if name in _SKIP_CALL_NAMES:
                continue
            for callee in index.get(name, ()):
                if isinstance(callee.node, ast.ClassDef):
                    continue
                if callee.mod in visible:
                    stack.append(callee)
    return out


def _host_calls_in(fn: _FnInfo) -> List[Tuple[int, str]]:
    hits: List[Tuple[int, str]] = []
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Call):
            what = _impure_call(n, fn.names)
            if what is not None:
                hits.append((n.lineno, what))
    return hits


def check_host_calls(files: Dict[str, str],
                     trees: Dict[str, ast.Module]) -> Tuple[int, List[str]]:
    index, roots, imports = _function_index(trees)
    reach = _reachable(index, roots, imports)
    viol: List[str] = []
    for fn in reach:
        for lineno, what in _host_calls_in(fn):
            name = getattr(fn.node, "name", "?")
            viol.append(f"{fn.path}:{lineno}: host call {what} reachable "
                        f"from the round path (via {name})")
    return len(reach), viol


# ---------------------------------------------------------------------------
# rule: registry-kind-ids
# ---------------------------------------------------------------------------


def _registered_kinds(trees: Dict[str, ast.Module]) -> Dict[str, str]:
    """kind string -> defining path, from @register_strategy decorators."""
    kinds: Dict[str, str] = {}
    for path, tree in trees.items():
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and isinstance(dec.func, ast.Name)
                        and dec.func.id == "register_strategy"
                        and dec.args
                        and isinstance(dec.args[0], ast.Constant)):
                    kinds[dec.args[0].value] = path
    return kinds


def _dict_literal(trees: Dict[str, ast.Module], path_suffix: str,
                  name: str) -> Optional[Dict[Any, Any]]:
    for path, tree in trees.items():
        if not path.endswith(path_suffix):
            continue
        for node in tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    try:
                        return ast.literal_eval(
                            node.value)  # type: ignore[arg-type]
                    except (ValueError, TypeError):
                        return None
    return None


def check_registry_kinds(files: Dict[str, str],
                         trees: Dict[str, ast.Module]) -> Tuple[int, List[str]]:
    kinds = _registered_kinds(trees)
    kind_ids = _dict_literal(trees, os.path.join("comm", "frame.py"),
                             "KIND_IDS")
    viol: List[str] = []
    if kind_ids is None:
        viol.append("comm/frame.py: KIND_IDS dict literal not found")
        return len(kinds), viol
    for kind, path in sorted(kinds.items()):
        if kind not in kind_ids:
            viol.append(f"{path}: strategy kind {kind!r} registered but has "
                        f"no wire kind-id in comm/frame.py KIND_IDS "
                        f"(have: {sorted(kind_ids)})")
    return len(kinds), viol


# ---------------------------------------------------------------------------
# rule: public-api-exports
# ---------------------------------------------------------------------------


def _golden_pins(test_path: str) -> Optional[Dict[str, List[str]]]:
    if not os.path.exists(test_path):
        return None
    with open(test_path, "r") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "GOLDEN"
                        for t in node.targets)):
            try:
                return ast.literal_eval(node.value)
            except (ValueError, TypeError):
                return None
    return None


def _list_literal(tree: ast.Module, name: str) -> Optional[List[str]]:
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            try:
                v = ast.literal_eval(node.value)
            except (ValueError, TypeError):
                return None
            return list(v) if isinstance(v, (list, tuple)) else None
    return None


def check_public_exports(files: Dict[str, str],
                         trees: Dict[str, ast.Module],
                         golden: Optional[Dict[str, List[str]]] = None,
                         ) -> Tuple[int, List[str]]:
    if golden is None:
        golden = _golden_pins(GOLDEN_TEST)
    if golden is None:
        return 0, [f"{os.path.relpath(GOLDEN_TEST, REPO)}: GOLDEN pins not "
                   f"found"]
    evaluated = 0
    viol: List[str] = []
    for mod, pinned in sorted(golden.items()):
        rel = os.path.join("src", *mod.split("."), "__init__.py")
        tree = trees.get(rel)
        if tree is None:
            viol.append(f"{rel}: GOLDEN-pinned module has no source file")
            continue
        declared = _list_literal(tree, "__all__")
        if declared is None:
            continue          # no __all__: surface governed by the test only
        evaluated += 1
        if sorted(declared) != sorted(pinned):
            extra = sorted(set(declared) - set(pinned))
            missing = sorted(set(pinned) - set(declared))
            viol.append(f"{rel}: __all__ disagrees with the GOLDEN pin "
                        f"(extra: {extra}, missing: {missing})")
    return evaluated, viol


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

RULES = (
    ("untyped-except", check_untyped_except),
    ("host-call-in-round-path", check_host_calls),
    ("registry-kind-ids", check_registry_kinds),
    ("public-api-exports", check_public_exports),
)


def run_lint(files: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Run every lint rule; returns the report's lint stanza."""
    if files is None:
        files = collect_sources()
    trees = _parse_all(files)
    per: Dict[str, Any] = {}
    total_eval = 0
    total_viol = 0
    for name, fn in RULES:
        evaluated, violations = fn(files, trees)
        per[name] = {"evaluated": evaluated, "violations": violations}
        total_eval += evaluated
        total_viol += len(violations)
    return {"files": len(files), "rules": per,
            "rules_evaluated": total_eval, "violations": total_viol}

"""AST lint for ``src/repro_torch/``.

Port of ``repro/analysis/lint.py``, keeping the rules that guard
contracts the port shares with the reference and giving L004 the
port's meaning:

=====  =================================================================
rule   contract
=====  =================================================================
L002   every public API taking ``tracer=`` must default to ``None`` or
       ``NULL_TRACER`` (tracing is strictly opt-in); ``repro_torch/obs/``
       itself is exempt — its plumbing takes tracers positionally.  Kept:
       the port's tracer is the reference's, with the same "zero
       overhead when tracing is off" contract.
L003   no mutable default arguments (literals, ``list``/``dict``/``set``
       constructors, or dataclasses not declared ``frozen=True``).  Kept:
       a default shared across calls is a fault in any Python.
L004   timing code must synchronize before reading the clock: a function
       that reads the clock twice and launches torch/CUDA work in between
       (a call rooted at ``torch`` or ``F``, or into
       ``repro_torch.kernels.ops``) must also call ``synchronize()``
       (``torch.cuda.synchronize`` or an event's) or read a result back
       to the host (``.item()``/``.cpu()``/``.tolist()``/``.numpy()``),
       else it times the host's enqueue instead of the device's work.
       An event's ``.elapsed_time`` is not enough by itself: it needs a
       ``synchronize`` first.  Kept with the port's calls: CUDA work is
       asynchronous as jax's dispatch is, and ``PERF.md`` §6 records
       the bug this guards against (CUDA events that timed the host's
       enqueue).
L006   lock discipline: in a class that holds a ``threading.Lock`` /
       ``RLock`` attribute, every method that mutates shared instance
       state (attributes assigned in ``__init__``) must do so inside a
       ``with self.<lock>`` block — an unlocked write to state the lock
       exists to protect is a data race by construction.  Assignments in
       ``__init__`` (pre-publication) and in nested ``def``s (unknown
       calling context) are exempt.  Kept: the service, the scheduler and
       the HTTP front end share state across threads as the reference's
       do.
=====  =================================================================

Scoped out, with the reason:

* **L001** (no clock or ``np.random`` calls reachable from a
  ``jit``/``shard_map``/``pallas_call`` entry point): the port never
  traces, so no host call is frozen at trace time; its jit-reachability
  call graph has no seeds here.
* **L005** (no internal imports of the deprecated serving request
  types): the deprecated shims (``engine.service.ClassifyRequest``,
  ``runtime.serve.Request``) were not copied into the port, so there is
  nothing to import.

Suppress a finding with an inline ``# lint: allow(L004)`` comment on the
offending line or on the enclosing ``def`` line; use sparingly and only
with a neighbouring justification.

Run as ``python -m repro_torch.analysis lint [paths]``; CI enforces
exit 0.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from repro_torch.analysis.diagnostics import Report

__all__ = ["lint_paths", "lint_file"]

_CLOCK_CHAINS = {
    ("time", "time"),
    ("time", "perf_counter"),
    ("time", "monotonic"),
    ("time", "process_time"),
    ("datetime", "now"),
    ("datetime", "utcnow"),
    ("datetime", "datetime", "now"),
    ("datetime", "datetime", "utcnow"),
}
# a call to any of these (as a method) waits for the device: an explicit
# synchronize, or a read of a result back to the host
_SYNC_NAMES = {"synchronize", "item", "cpu", "tolist", "numpy"}
# module roots whose calls launch torch/CUDA work
_TORCH_ROOTS = ("torch", "repro_torch.kernels.ops")
_MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "defaultdict", "deque"}
_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([A-Z0-9,\s]+)\)")


def _dotted(node: ast.AST) -> tuple[str, ...] | None:
    """``a.b.c`` -> ("a", "b", "c"); None for non-name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


@dataclasses.dataclass
class _Func:
    module: str
    qualname: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    clock_calls: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    torch_linenos: list[int] = dataclasses.field(default_factory=list)
    synchronizes: bool = False


@dataclasses.dataclass
class _Module:
    name: str
    path: str
    tree: ast.Module
    lines: list[str]
    # local alias -> dotted module it names ("np" -> "numpy")
    mod_aliases: dict = dataclasses.field(default_factory=dict)
    # from-imported name -> (source module, original name)
    from_imports: dict = dataclasses.field(default_factory=dict)
    funcs: list = dataclasses.field(default_factory=list)  # [_Func]
    frozen_classes: set = dataclasses.field(default_factory=set)
    nonfrozen_dataclasses: set = dataclasses.field(default_factory=set)


def _module_name(path: str) -> str:
    """Dotted module name, anchored at the ``repro_torch`` package when
    present."""
    parts = os.path.normpath(os.path.abspath(path))[:-3].split(os.sep)
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    return ".".join(p for p in parts if p)


def _dataclass_frozen(dec: ast.AST) -> bool | None:
    """True/False when *dec* is a dataclass decorator, None otherwise."""
    chain = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
    if not chain or chain[-1] != "dataclass":
        return None
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
    return False


class _Collector(ast.NodeVisitor):
    """One pass per module: functions, imports, classes, call metadata."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.stack: list[str] = []  # enclosing class/function names
        self.fstack: list[_Func] = []  # enclosing _Func entries only

    # -- imports ----------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.mod.mod_aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module:
            for a in node.names:
                self.mod.from_imports[a.asname or a.name] = (
                    node.module, a.name
                )

    # -- classes ----------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef):
        frozen = None
        for dec in node.decorator_list:
            got = _dataclass_frozen(dec)
            if got is not None:
                frozen = got
        if frozen is True:
            self.mod.frozen_classes.add(node.name)
        elif frozen is False:
            self.mod.nonfrozen_dataclasses.add(node.name)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    # -- functions --------------------------------------------------
    def _visit_func(self, node):
        f = _Func(
            module=self.mod.name,
            qualname=".".join(self.stack + [node.name]),
            node=node,
        )
        self.mod.funcs.append(f)
        self.stack.append(node.name)
        self.fstack.append(f)
        self.generic_visit(node)
        self.fstack.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- calls ------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        if self.fstack:
            self._classify(self.fstack[-1], node)
        self.generic_visit(node)

    def _rooted(self, root: str) -> str:
        """The dotted module a call chain's first name stands for."""
        if root in self.mod.mod_aliases:
            return self.mod.mod_aliases[root]
        if root in self.mod.from_imports:
            src, orig = self.mod.from_imports[root]
            return f"{src}.{orig}"
        return "torch.nn.functional" if root == "F" else root

    def _classify(self, f: _Func, node: ast.Call):
        # methods on any receiver (``(a - b).abs().max().item()``)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_NAMES
        ):
            f.synchronizes = True
        chain = _dotted(node.func)
        if not chain:
            return
        root = chain[0]
        rooted = self._rooted(root)
        dotted = ".".join(chain)
        if chain in _CLOCK_CHAINS and (
            rooted.split(".")[0] in ("time", "datetime")
            or self.mod.from_imports.get(root, ("", ""))[1] == "datetime"
        ):
            f.clock_calls.append((node.lineno, dotted))
        if any(rooted == r or rooted.startswith(r + ".")
               for r in _TORCH_ROOTS):
            f.torch_linenos.append(node.lineno)


def _parse(paths: list[str]) -> list[_Module]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(
                    os.path.join(root, n) for n in sorted(names)
                    if n.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
    mods = []
    for path in sorted(set(files)):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue  # ruff owns syntax errors
        mod = _Module(
            name=_module_name(path), path=path, tree=tree,
            lines=src.splitlines(),
        )
        _Collector(mod).visit(tree)
        mods.append(mod)
    return mods


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _allowed(mod: _Module, rule: str, *linenos: int) -> bool:
    for ln in linenos:
        if 1 <= ln <= len(mod.lines):
            m = _ALLOW_RE.search(mod.lines[ln - 1])
            if m and rule in {s.strip() for s in m.group(1).split(",")}:
                return True
    return False


def _loc(mod: _Module, lineno: int) -> str:
    return f"{os.path.relpath(mod.path)}:{lineno}"


def _rule_l002(r: Report, mod: _Module, f: _Func, in_obs: bool):
    if in_obs or f.node.name.startswith("_"):
        return
    args = f.node.args
    named = args.posonlyargs + args.args + args.kwonlyargs
    defaults = dict(
        zip([a.arg for a in reversed(args.posonlyargs + args.args)],
            list(reversed(args.defaults)))
    )
    defaults.update(
        (a.arg, d)
        for a, d in zip(args.kwonlyargs, args.kw_defaults)
        if d is not None
    )
    for a in named:
        if a.arg != "tracer":
            continue
        d = defaults.get(a.arg)
        ok = (
            isinstance(d, ast.Constant) and d.value is None
        ) or (isinstance(d, ast.Name) and d.id == "NULL_TRACER") or (
            isinstance(d, ast.Attribute) and d.attr == "NULL_TRACER"
        )
        if not ok and not _allowed(mod, "L002", f.node.lineno):
            r.add(
                "L002",
                f"public API {f.qualname}() takes tracer= without a "
                "None/NULL_TRACER default — tracing must be opt-in",
                layer=f.module, location=_loc(mod, f.node.lineno),
            )


def _mutable_default(d: ast.AST, nonfrozen: set[str], frozen: set[str]):
    if isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                      ast.DictComp, ast.SetComp)):
        return "mutable literal"
    if isinstance(d, ast.Call):
        chain = _dotted(d.func) or ()
        name = chain[-1] if chain else ""
        if name in _MUTABLE_CTORS:
            return f"{name}() constructor"
        if name in nonfrozen and name not in frozen:
            return f"non-frozen dataclass {name}()"
    return None


def _rule_l003(r: Report, mod: _Module, f: _Func, nonfrozen, frozen):
    args = f.node.args
    for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
        why = _mutable_default(d, nonfrozen, frozen)
        if why and not _allowed(mod, "L003", d.lineno, f.node.lineno):
            r.add(
                "L003",
                f"mutable default argument ({why}) in {f.qualname}(): "
                "shared across calls",
                layer=f.module, location=_loc(mod, d.lineno),
            )


def _rule_l004(r: Report, mod: _Module, f: _Func):
    if len(f.clock_calls) < 2 or f.synchronizes:
        return
    lo = min(ln for ln, _ in f.clock_calls)
    hi = max(ln for ln, _ in f.clock_calls)
    # only torch work *between* the clock reads is being (mis)timed
    timed = [ln for ln in f.torch_linenos if lo < ln < hi]
    if not timed or _allowed(mod, "L004", lo, f.node.lineno):
        return
    r.add(
        "L004",
        f"{f.qualname}() launches torch work (line {timed[0]}) between "
        "clock reads without synchronize()/.item()/.cpu() — it times the "
        "host's enqueue, not the device's work",
        layer=f.module, location=_loc(mod, lo),
    )


_LOCK_CTORS = {"Lock", "RLock"}


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` or ``self.X[...]`` -> ``"X"``; anything else -> None."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_ctor(mod: _Module, value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    chain = _dotted(value.func) or ()
    if not chain or chain[-1] not in _LOCK_CTORS:
        return False
    root = mod.mod_aliases.get(chain[0], chain[0])
    if root.split(".")[0] == "threading":
        return True
    # `from threading import Lock` / `RLock`
    src, orig = mod.from_imports.get(chain[0], ("", ""))
    return len(chain) == 1 and src.split(".")[-1] == "threading" and (
        orig in _LOCK_CTORS
    )


class _LockScan(ast.NodeVisitor):
    """Record ``self.<shared>`` mutations made outside ``with self.<lock>``.

    Nested ``def``/``lambda`` bodies are skipped entirely: a closure
    defined under a lock may run after it is released (and vice versa),
    so neither flagging nor excusing it is sound.
    """

    def __init__(self, lock_attrs: set, shared: set):
        self.lock_attrs = lock_attrs
        self.shared = shared
        self.depth = 0  # nesting level of with-self.<lock> blocks
        self.offences: list[tuple[int, str]] = []

    def _record(self, target: ast.AST, lineno: int):
        attr = _self_attr(target)
        if attr in self.shared and self.depth == 0:
            self.offences.append((lineno, attr))

    def _visit_with(self, node):
        locked = any(
            _self_attr(item.context_expr) in self.lock_attrs
            for item in node.items
        )
        self.depth += locked
        self.generic_visit(node)
        self.depth -= locked

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # skip nested defs
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _rule_l006(r: Report, mod: _Module):
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        lock_attrs = {
            attr
            for m in methods
            for node in ast.walk(m)
            if isinstance(node, ast.Assign) and _is_lock_ctor(mod, node.value)
            for attr in map(_self_attr, node.targets)
            if attr
        }
        if not lock_attrs:
            continue
        shared: set[str] = set()
        for m in methods:
            if m.name != "__init__":
                continue
            for node in ast.walk(m):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target] if isinstance(node, ast.AnnAssign)
                    else []
                )
                for t in targets:
                    # plain `self.x = ...` only — subscripts in __init__
                    # are construction detail, not attribute declaration
                    if isinstance(t, ast.Attribute):
                        attr = _self_attr(t)
                        if attr:
                            shared.add(attr)
        shared -= lock_attrs
        if not shared:
            continue
        locks = "/".join(f"self.{a}" for a in sorted(lock_attrs))
        for m in methods:
            if m.name == "__init__":
                continue
            scan = _LockScan(lock_attrs, shared)
            for stmt in m.body:
                scan.visit(stmt)
            for lineno, attr in scan.offences:
                if _allowed(mod, "L006", lineno, m.lineno):
                    continue
                r.add(
                    "L006",
                    f"{cls.name}.{m.name}() mutates self.{attr} outside a "
                    f"`with {locks}` block — shared state in a "
                    "lock-holding class must be mutated under the lock",
                    layer=mod.name, location=_loc(mod, lineno),
                )


def lint_paths(paths: list[str]) -> Report:
    """Lint *paths* (files or directories) and return a Report."""
    mods = _parse(paths)
    frozen = {c for m in mods for c in m.frozen_classes}
    nonfrozen = {c for m in mods for c in m.nonfrozen_dataclasses}

    r = Report()
    for mod in mods:
        in_obs = f"{os.sep}obs{os.sep}" in mod.path or mod.name.startswith(
            "repro_torch.obs"
        )
        _rule_l006(r, mod)
        for f in mod.funcs:
            _rule_l002(r, mod, f, in_obs)
            _rule_l003(r, mod, f, nonfrozen, frozen)
            _rule_l004(r, mod, f)
    return r


def lint_file(path: str) -> Report:
    return lint_paths([path])

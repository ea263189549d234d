"""Repo-specific AST lint — ``python -m repro_torch.analysis.lint src/repro_torch``.

The port of ``repro.analysis.lint``, with the rules pointed at the port's
tree.  Pure-stdlib static checks (no tracing, no device work) enforcing the
phase-1 / phase-2 split the package is built around:

``host-np`` (error)
    No host ``np.`` / ``numpy.`` calls in functions reachable from the
    phase-2 entry points (``apply`` / ``execute`` / ``__call__`` /
    ``_apply*``).  Host numpy in an apply means a host round trip (or a
    re-plan) per execution.  Escape hatch for deliberate host-side fast
    paths (e.g. pattern checks on host arrays): append ``# lint: host-ok``
    to the line.

``plan-frozen`` (error)
    Every dataclass named ``*Plan`` must be frozen
    (``@dataclasses.dataclass(frozen=True)``): plans are pattern-frozen
    phase-1 products that caches hand out to many callers, so none may
    change under them.  (The JAX package's ``plan-pytree`` rule also
    admits a registered pytree; the port has no pytrees.)

``kernel-call`` (error)
    ctypes — the binding of the CUDA kernels — may appear only under
    ``repro_torch/kernels/``: no ``import ctypes``, no ``CDLL`` /
    ``build.library`` / ``_lib()`` call and no call through a ``lib.``
    handle anywhere else.  A kernel called past its wrapper skips the
    wrapper's host-side checks and its launch counter.

``schedule-call`` (error)
    Raw ``StreamSchedule(...)`` / ``DeviceSchedule(...)`` construction may
    appear only under ``repro_torch/kernels/`` — the one place the
    schedule self-description contract is upheld.  A schedule hand-built
    anywhere else bypasses ``schedule_from_ip`` / ``schedule_from_stream``
    / ``pad_schedule`` / ``device_schedule`` and therefore everything the
    schedule checker proves about planner-emitted schedules.

``obs-time`` (error)
    No direct ``time.time()`` / ``time.monotonic()`` /
    ``time.perf_counter()`` calls in ``repro_torch/`` outside
    ``repro_torch.obs`` — telemetry goes through :mod:`repro_torch.obs`
    (``obs.now_ns`` for raw timestamps, ``span`` / histogram ``observe``
    for latencies).  Escape hatch for deliberate measurement loops: append
    ``# lint: time-ok`` to the line.

``obs-stats`` (warning)
    No ad-hoc stats-dict accumulation (``self.stats[...] += ...``)
    outside ``repro_torch.obs`` — counters belong in a
    :class:`repro_torch.obs.MetricsRegistry`.  Escape hatch:
    ``# lint: stats-ok``.

The call graph is name-keyed and deliberately over-approximate: an edge is
recorded for every called name, every referenced function name, and every
function name referenced from a module-level binding (dispatch tables like
``_EXECUTORS``) that a reachable function touches.  False reachability is
acceptable — a pragma documents the exception; false *un*reachability is
not.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .diagnostics import ERROR, WARNING, PlanDiagnostic

__all__ = ["lint_paths", "main"]

ENTRY_NAMES = ("apply", "execute", "__call__")
PRAGMA = "# lint:"
#: the only place ctypes kernel bindings and raw schedules may live
KERNELS_DIR = "repro_torch/kernels/"
#: callables that load or reach a ctypes kernel library
KERNEL_LOADERS = ("CDLL", "LoadLibrary", "library", "_lib")
SCHEDULE_CALL_NAMES = ("StreamSchedule", "DeviceSchedule")
#: host-clock calls the obs layer replaces (obs.now_ns / span / histograms)
OBS_TIME_FUNCS = ("time", "monotonic", "perf_counter", "perf_counter_ns",
                  "process_time")
#: files/dirs where raw clocks stay legitimate: the obs layer itself
OBS_TIME_ALLOWED = ("repro_torch/obs/",)


def _is_entry(name: str) -> bool:
    return name in ENTRY_NAMES or name.startswith("_apply")


def _terminal_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name or Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """The leftmost identifier of an Attribute chain (``np`` in
    ``np.linalg.norm``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@dataclasses.dataclass
class _Func:
    name: str
    path: str
    node: ast.AST                      # FunctionDef / AsyncFunctionDef
    cls: Optional[str]                 # enclosing class name, if a method
    # resolved-edge inputs (see _edges_of):
    bare_calls: Set[str]               # f(...) / lax.scan(f, ...) by Name
    self_calls: Set[str]               # self.f(...)
    module_calls: Set[str]             # alias.f(...) where alias is a module
    name_loads: Set[str]               # bare Name loads (dispatch tables)


@dataclasses.dataclass
class _Module:
    path: str
    tree: ast.Module
    lines: List[str]
    funcs: List[_Func]
    imported: Set[str]                 # from x import f  ->  {"f"}
    module_aliases: Set[str]           # import x as y / from . import z
    # module-level binding name -> function names referenced in its RHS
    bindings: Dict[str, Set[str]]


def _line_has_pragma(mod: _Module, lineno: int) -> bool:
    if 1 <= lineno <= len(mod.lines):
        return PRAGMA in mod.lines[lineno - 1]
    return False


def _collect_refs(fn: _Func, module_aliases: Set[str],
                  lines: List[str]) -> None:
    """Populate ``fn``'s edge inputs from its body.

    Resolution is deliberately conservative: a call is an edge only when
    its target is nameable — a bare name (module function, import, or a
    function handed to another call as an argument),
    ``self.method``, or ``module_alias.function``.  Method calls on other
    objects (``layout.compress(...)``) are NOT edges; resolving them by
    bare method name makes every ``.get``/``.write`` in the repo collide
    into ``PlanCache.get``/``Checkpointer.write`` and marks the entire
    phase-1 planner "reachable from apply".

    A ``# lint:`` pragma on a call line cuts that edge too: the call is
    declared a deliberate host-side operation, so the code behind it is
    not treated as phase-2.
    """
    for sub in ast.walk(fn.node):
        if isinstance(sub, ast.Call):
            if 1 <= sub.lineno <= len(lines) \
                    and PRAGMA in lines[sub.lineno - 1]:
                continue
            func = sub.func
            if isinstance(func, ast.Name):
                fn.bare_calls.add(func.id)
            elif isinstance(func, ast.Attribute):
                root = _root_name(func)
                if root == "self":
                    fn.self_calls.add(func.attr)
                elif root in module_aliases:
                    fn.module_calls.add(func.attr)
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(arg, ast.Name):
                    fn.bare_calls.add(arg.id)
        elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            fn.name_loads.add(sub.id)


def _index_module(path: str, source: str) -> Optional[_Module]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    mod = _Module(path=path, tree=tree, lines=source.splitlines(),
                  funcs=[], imported=set(), module_aliases=set(),
                  bindings={})
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.module_aliases.add(
                    alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                name = alias.asname or alias.name
                # "from . import sub" aliases a module; "from .x import f"
                # aliases a function/class — record as both, resolution
                # only fires where a matching def exists
                mod.imported.add(name)
                mod.module_aliases.add(name)

    def _visit(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = _Func(name=child.name, path=path, node=child, cls=cls,
                           bare_calls=set(), self_calls=set(),
                           module_calls=set(), name_loads=set())
                _collect_refs(fn, mod.module_aliases, mod.lines)
                mod.funcs.append(fn)
                # nested defs are walked as part of the parent body; no
                # separate _Func (a scan body belongs to its builder)
            elif isinstance(child, ast.ClassDef):
                _visit(child, child.name)
            else:
                _visit(child, cls)

    _visit(tree, None)
    for stmt in tree.body:
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        refs: Set[str] = set()
        for sub in ast.walk(value):
            t = _terminal_name(sub)
            if t:
                refs.add(t)
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                mod.bindings[tgt.id] = refs
    return mod


def _reachable_funcs(modules: List[_Module]) -> Set[int]:
    """ids of function nodes reachable from the phase-2 entry points."""
    # global indexes
    global_funcs: Dict[str, List[_Func]] = {}     # module-level functions
    methods: Dict[Tuple[str, str], List[_Func]] = {}   # (class, name)
    per_module: Dict[str, Dict[str, List[_Func]]] = {}
    for mod in modules:
        local: Dict[str, List[_Func]] = {}
        for fn in mod.funcs:
            if fn.cls is None:
                global_funcs.setdefault(fn.name, []).append(fn)
                local.setdefault(fn.name, []).append(fn)
            else:
                methods.setdefault((fn.cls, fn.name), []).append(fn)
        per_module[mod.path] = local

    def _edges_of(fn: _Func, mod: _Module) -> List[_Func]:
        out: List[_Func] = []
        binding_refs: Set[str] = set()
        for ref in fn.name_loads:
            binding_refs |= mod.bindings.get(ref, set())
        for name in fn.bare_calls | binding_refs:
            out.extend(per_module[mod.path].get(name, ()))
            if name in mod.imported:
                out.extend(global_funcs.get(name, ()))
        for name in fn.module_calls | binding_refs:
            out.extend(global_funcs.get(name, ()))
        for name in fn.self_calls:
            out.extend(methods.get((fn.cls, name), ()))
        return out

    mod_of = {id(fn.node): mod for mod in modules for fn in mod.funcs}
    frontier = [fn for mod in modules for fn in mod.funcs
                if _is_entry(fn.name)]
    reachable: Set[int] = set()
    while frontier:
        fn = frontier.pop()
        if id(fn.node) in reachable:
            continue
        reachable.add(id(fn.node))
        for callee in _edges_of(fn, mod_of[id(fn.node)]):
            if id(callee.node) not in reachable:
                frontier.append(callee)
    return reachable


def _dataclass_info(node: ast.ClassDef) -> Tuple[bool, bool]:
    """(is_dataclass, frozen) from the decorators."""
    is_dc = frozen = False
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        t = _terminal_name(target)
        if t == "dataclass":
            is_dc = True
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen" and isinstance(kw.value,
                                                        ast.Constant):
                        frozen = bool(kw.value.value)
    return is_dc, frozen


def _obs_scope(rel: str) -> bool:
    """Is this file policed by the obs-time / obs-stats rules?

    ``repro_torch/`` only (``chip_smoke.py``, benchmarks and tests time
    things freely), minus the allowlist: the obs layer itself.
    """
    if "repro_torch/" not in rel:
        return False
    return not any(allowed in rel for allowed in OBS_TIME_ALLOWED)


def _kernel_binding(node: ast.AST) -> Optional[str]:
    """What ctypes kernel binding ``node`` makes, or ``None``."""
    if isinstance(node, ast.Import) \
            and any(a.name.split(".")[0] == "ctypes" for a in node.names):
        return "import ctypes"
    if isinstance(node, ast.ImportFrom) \
            and (node.module or "").split(".")[0] == "ctypes":
        return "from ctypes import"
    if not isinstance(node, ast.Call):
        return None
    name = _terminal_name(node.func)
    if name in KERNEL_LOADERS:
        return f"{name}(...)"
    if isinstance(node.func, ast.Attribute) \
            and _root_name(node.func) == "lib":
        return f"lib.{node.func.attr}(...)"
    if isinstance(node.func, ast.Call) \
            and _terminal_name(node.func.func) == "getattr" \
            and node.func.args and _root_name(node.func.args[0]) == "lib":
        return "getattr(lib, ...)(...)"
    return None


def _lint_module(mod: _Module, reachable: Set[int],
                 diags: List[PlanDiagnostic]) -> None:
    rel = mod.path.replace(os.sep, "/")

    # -- kernel-call / schedule-call / plan-frozen / obs-*: whole-file -----
    in_scope = "repro_torch/" in rel
    in_kernels = KERNELS_DIR in rel
    obs_scope = _obs_scope(rel)
    for node in ast.walk(mod.tree):
        if obs_scope and isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and _root_name(node.func) == "time" \
                and node.func.attr in OBS_TIME_FUNCS \
                and not _line_has_pragma(mod, node.lineno):
            diags.append(PlanDiagnostic(
                code="obs-time", severity=ERROR,
                message=f"direct time.{node.func.attr}() outside repro.obs "
                        "— telemetry bypasses the shared clock/export path",
                location=f"{rel}:{node.lineno}",
                hint="use repro.obs.now_ns (timestamps), span() (regions), "
                     "or a registry histogram (latencies); append "
                     "'# lint: time-ok' for a deliberate measurement loop"))
        if obs_scope and isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Subscript) \
                and _terminal_name(node.target.value) == "stats" \
                and isinstance(node.target.slice, ast.Constant) \
                and isinstance(node.target.slice.value, str) \
                and not _line_has_pragma(mod, node.lineno):
            diags.append(PlanDiagnostic(
                code="obs-stats", severity=WARNING,
                message="ad-hoc stats-dict accumulation "
                        "(stats[...] += ...) outside repro.obs",
                location=f"{rel}:{node.lineno}",
                hint="increment a MetricsRegistry counter instead; expose "
                     "the dict as a snapshot view if callers need it"))
        if in_scope and not in_kernels \
                and not _line_has_pragma(mod, getattr(node, "lineno", 0)):
            what = _kernel_binding(node)
            if what:
                diags.append(PlanDiagnostic(
                    code="kernel-call", severity=ERROR,
                    message=f"{what} outside repro_torch/kernels/ — a "
                            "kernel called past its wrapper skips the "
                            "host-side checks and the launch counter",
                    location=f"{rel}:{node.lineno}",
                    hint="call the kernel's wrapper in repro_torch.kernels"))
        if isinstance(node, ast.Call) \
                and _terminal_name(node.func) in SCHEDULE_CALL_NAMES \
                and in_scope and not in_kernels \
                and not _line_has_pragma(mod, node.lineno):
            diags.append(PlanDiagnostic(
                code="schedule-call", severity=ERROR,
                message=f"{_terminal_name(node.func)}(...) outside "
                        "repro_torch/kernels/ — hand-built schedules "
                        "bypass the self-description contract the "
                        "schedule checker verifies",
                location=f"{rel}:{node.lineno}",
                hint="build schedules via schedule_from_ip/"
                     "schedule_from_stream/pad_schedule/device_schedule in "
                     "the kernel library"))
        if isinstance(node, ast.ClassDef) and node.name.endswith("Plan"):
            is_dc, frozen = _dataclass_info(node)
            if is_dc and not frozen \
                    and not _line_has_pragma(mod, node.lineno):
                diags.append(PlanDiagnostic(
                    code="plan-frozen", severity=ERROR,
                    message=f"dataclass {node.name} is not frozen=True — "
                            "a cached plan could change under its callers",
                    location=f"{rel}:{node.lineno}",
                    hint="add frozen=True (plans are pattern-frozen "
                         "phase-1 products)"))

    # -- host-np: reachable-function rule -----------------------------------
    for fn in mod.funcs:
        if id(fn.node) not in reachable:
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and _root_name(node.func) in ("np", "numpy") \
                    and not _line_has_pragma(mod, node.lineno):
                diags.append(PlanDiagnostic(
                    code="host-np", severity=ERROR,
                    message=f"host numpy call np.{node.func.attr} in "
                            f"{fn.name}(), reachable from a phase-2 "
                            "apply/execute path",
                    location=f"{rel}:{node.lineno}",
                    hint="use torch on the device, hoist to phase 1, or "
                         "append '# lint: host-ok' if this is a deliberate "
                         "host fast path"))


def _iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path) and path.endswith(".py"):
            yield path
        elif os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Iterable[str]) -> List[PlanDiagnostic]:
    """Run all lint rules over ``paths`` (files or directories)."""
    modules: List[_Module] = []
    for path in _iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        mod = _index_module(path, source)
        if mod is not None:
            modules.append(mod)
    reachable = _reachable_funcs(modules)
    diags: List[PlanDiagnostic] = []
    for mod in modules:
        _lint_module(mod, reachable, diags)
    # nested functions are walked under their parent too — dedup
    unique = {(d.location, d.code): d for d in diags}
    return sorted(unique.values(), key=lambda d: (d.location, d.code))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific phase-1/phase-2 AST lint")
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--json", action="store_true",
                        help="emit diagnostics as JSON")
    args = parser.parse_args(argv)

    diags = lint_paths(args.paths)
    if args.json:
        print(json.dumps([dataclasses.asdict(d) for d in diags], indent=2))
    else:
        for d in diags:
            print(f"{d.location}: [{d.severity}] {d.code}: {d.message}")
        errors = sum(d.is_error for d in diags)
        warnings = len(diags) - errors
        print(f"{errors} error(s), {warnings} warning(s) across "
              f"{len(diags)} finding(s)")
    return 1 if any(d.is_error for d in diags) else 0


if __name__ == "__main__":
    sys.exit(main())

"""AST-level lints over the port's own sources (the port's copy of
flexflow_tpu/analysis/source_lints.py: its rule ids and diagnostics).

The rules that are plain Python are the JAX package's: LINT002 (id-keyed
persistent caches), LINT003 (iteration over a set), LINT005 (a blocking
host transfer lexically inside a `_fit_*` training-loop driver), LINT006
(a swallowed exception in runtime/ or a fit-loop driver) and LINT007 (a
runtime/ thread that mutates shared state without its class's lock, or has
no fault route). The JAX-only ones have their PyTorch counterparts:

LINT001 host-read-in-graph-body   `.item()`, `.cpu()`, `.tolist()`,
                            `float(t)`/`int(t)` of a non-constant, or
                            `np.asarray(...)` inside a CUDA-graph body: a
                            captured fused window (`fused_multi_step`, an
                            instance's `_multi_step`) or the captured decode
                            window (`decode_window_eager`), or a `*_kernel`
                            function. A host read there cannot be captured
                            (the capture fails) or, run eagerly, stalls the
                            card once a step.
LINT009 literal-seed-in-step  `torch.manual_seed(<literal>)` or
                            `<generator>.manual_seed(<literal>)` inside a
                            step body (`_step`, `_multi_step`,
                            `fused_multi_step`, `decode_window_eager`):
                            bitwise resume carries ONE generator through
                            the fit loop; a fresh constant seed mid-step
                            restarts the stream at the same value every
                            step (correlated dropout masks) and is
                            invisible to the restored generator state.
                            Seeding outside step bodies (initialization,
                            the default generator of a call that got none)
                            is fine.

LINT004, LINT008 and LINT010 keep their catalog entries, with the reason
the port has no counterpart: there is no shard_map body (each rank runs
its own Python, whose host reads LINT001 and LINT005 judge), no jit
donation (a step updates its state in place, which DON001/DON002 check on
the recorded step), and no committed-sharding placement (a rank's tensor
lives on its one device).

`lint_source` lints one source text (tests feed seeded snippets);
`lint_package` walks a package directory (default: the port's).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error

LINT_CATALOG: Dict[str, str] = {
    "LINT001": "host-read-in-graph-body: .item()/.cpu()/.tolist()/float(t)/np.asarray inside a CUDA-graph body (a fused window or the decode window)",
    "LINT002": "id-keyed-cache: id(...) keys a persistent (attribute/module-level) store",
    "LINT003": "unordered-iteration: for/listcomp directly over a set",
    "LINT004": "host-read-in-shard-map: no counterpart in the port (no shard_map: each rank runs its own Python, judged by LINT001/LINT005)",
    "LINT005": "host-transfer-in-fit-loop: blocking host transfer on the training-loop critical path (a _fit_* driver)",
    "LINT006": "swallowed-exception: bare except / pass-only broad handler inside runtime/ or a fit-loop driver",
    "LINT007": "unsupervised-thread: runtime/ thread target mutating shared state without the class lock, or a Thread lacking a FaultChannel route",
    "LINT008": "undonated-step-jit: no counterpart in the port (no jit donation: a step updates its state in place, checked by DON001/DON002 on the recorded step)",
    "LINT009": "literal-seed-in-step: torch.manual_seed(<literal>) or <generator>.manual_seed(<literal>) inside a step body breaks the carried generator bitwise resume depends on",
    "LINT010": "committed-state-reshard: no counterpart in the port (no committed-sharding placement: a rank's tensor lives on its one device)",
}

# training-loop drivers: functions holding the step-dispatch critical path
# (FFModel._fit_loop/_fit_epochs/_fit_epochs_fused and kin)
_FIT_LOOP_PREFIX = "_fit_"

# CUDA-graph bodies (LINT001): the captured fused windows and decode window
_GRAPH_BODIES = frozenset({"fused_multi_step", "_multi_step", "decode_window_eager"})
# step bodies (LINT009)
_STEP_BODIES = frozenset({"_step", "_multi_step", "fused_multi_step", "decode_window_eager"})

_HOST_SYNC_ATTRS = {"item"}
# host reads a graph body may not hold besides `.item()`
_GRAPH_READ_ATTRS = {"item", "cpu", "tolist"}
_HOST_SYNC_CALLS = {
    ("np", "asarray"),
    ("numpy", "asarray"),
}


def _dotted(node: ast.AST) -> Optional[tuple]:
    """('np', 'asarray') for np.asarray; ('torch', 'manual_seed') for
    torch.manual_seed; a 1-tuple for bare names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_graph_body(fn: ast.AST) -> bool:
    return fn.name in _GRAPH_BODIES or fn.name.endswith("_kernel")


def _walk_excluding_nested_defs(fn: ast.AST):
    """The nodes of `fn`'s own body, NOT descending into nested function
    definitions (nested defs are background-thread bodies or helpers with
    their own linting context — LINT005 must judge only the code the
    driver itself executes)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lint_jit_body(
    fn: ast.AST,
    path: str,
    diags: List[Diagnostic],
    rule: str = "LINT001",
    context: str = "CUDA-graph body",
    nodes=None,
) -> None:
    if rule == "LINT005":
        consequence = "stalls async dispatch of the next step"
        hint = (
            "move the transfer into a named helper outside the driver, or "
            "onto a background producer/writer thread"
        )
        attrs = _HOST_SYNC_ATTRS
    else:
        consequence = "cannot be captured (a host round-trip)"
        hint = "keep device scalars on the device; read them back once outside the window"
        attrs = _GRAPH_READ_ATTRS
    for node in nodes if nodes is not None else ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in attrs:
            if not node.args and not node.keywords:  # x.item()
                diags.append(
                    error(
                        rule,
                        f".{func.attr}() inside {context} "
                        f"{fn.name!r} forces a host sync per step",
                        path=path,
                        line=node.lineno,
                        hint=hint,
                    )
                )
            continue
        if (rule == "LINT001" and isinstance(func, ast.Name)
                and func.id in ("float", "int") and len(node.args) == 1
                and not isinstance(node.args[0], ast.Constant)):
            diags.append(
                error(
                    rule,
                    f"{func.id}(...) inside {context} {fn.name!r} reads a "
                    f"tensor back to the host and {consequence}",
                    path=path,
                    line=node.lineno,
                    hint=hint,
                )
            )
            continue
        d = _dotted(func)
        if d is not None and len(d) >= 2 and (d[-2], d[-1]) in _HOST_SYNC_CALLS:
            diags.append(
                error(
                    rule,
                    f"{'.'.join(d)}(...) inside {context} {fn.name!r} "
                    f"{consequence}",
                    path=path,
                    line=node.lineno,
                    hint=hint,
                )
            )


def _contains_id_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "id"
        ):
            return True
    return False


def _is_persistent_store(node: ast.AST) -> bool:
    """self._cache / obj.attr / MODULE_CONSTANT — stores that outlive the
    local scope."""
    if isinstance(node, ast.Attribute):
        return True
    if isinstance(node, ast.Name):
        return node.id.isupper()
    return False


def _lint_id_keys(tree: ast.AST, path: str, diags: List[Diagnostic]) -> None:
    for node in ast.walk(tree):
        store = None
        key = None
        if isinstance(node, ast.Subscript):
            store, key = node.value, node.slice
        elif isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
        ):
            store, key = node.comparators[0], node.left
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr in ("get", "setdefault", "add") and node.args:
                store, key = node.func.value, node.args[0]
        if (
            store is not None
            and key is not None
            and _is_persistent_store(store)
            and _contains_id_call(key)
        ):
            diags.append(
                error(
                    "LINT002",
                    "id(...) keys a persistent store: ids are recycled "
                    "after GC, so the cache can alias a dead object",
                    path=path,
                    line=node.lineno,
                    hint="key by a stable identity (index, name, or the "
                    "object itself if hashable)",
                )
            )


def _is_unordered_iterable(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _lint_unordered_iteration(
    tree: ast.AST, path: str, diags: List[Diagnostic]
) -> None:
    def flag(node):
        diags.append(
            error(
                "LINT003",
                "iteration order over a set is hash-seed dependent; "
                "anything built from it is nondeterministic",
                path=path,
                line=node.lineno,
                hint="iterate sorted(...) instead",
            )
        )

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_unordered_iterable(node.iter):
            flag(node.iter)
        elif isinstance(node, ast.ListComp):
            for gen in node.generators:
                if _is_unordered_iterable(gen.iter):
                    flag(gen.iter)


_BROAD_EXC_NAMES = ("Exception", "BaseException")


def _is_runtime_path(path: str) -> bool:
    """True for files under the package's runtime/ — the fault-domain
    supervision package LINT006 keeps swallow-free."""
    parts = path.replace("\\", "/").split("/")
    return "runtime" in parts


def _is_broad_handler_type(node: ast.AST) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Tuple):
        return any(_is_broad_handler_type(e) for e in node.elts)
    d = _dotted(node)
    return d is not None and d[-1] in _BROAD_EXC_NAMES


def _is_swallow_body(body: List[ast.stmt]) -> bool:
    """A handler body that discards the exception without routing it
    anywhere: only pass/continue/constant-expression statements."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / bare `...`
        return False
    return True


def _lint_swallows_in(nodes, path: str, context: str, diags: List[Diagnostic]) -> None:
    for node in nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            diags.append(
                error(
                    "LINT006",
                    f"bare `except:` inside {context}: catches "
                    "KeyboardInterrupt/SystemExit and hides the fault "
                    "from the supervision layer",
                    path=path,
                    line=node.lineno,
                    hint="name the exception types, and route the error "
                    "(FaultChannel.post, structured re-raise) instead of "
                    "discarding it",
                )
            )
        elif _is_broad_handler_type(node.type) and _is_swallow_body(node.body):
            diags.append(
                error(
                    "LINT006",
                    f"`except {ast.unparse(node.type)}` with a pass-only "
                    f"body inside {context}: the error never reaches the "
                    "supervision layer",
                    path=path,
                    line=node.lineno,
                    hint="narrow the exception type or route the error "
                    "(post to the FaultChannel, raise a structured "
                    "error, record-and-fall-back)",
                )
            )


def _lint_swallows(tree: ast.AST, path: str, diags: List[Diagnostic]) -> None:
    """LINT006: swallowed exceptions where the supervision layer needs
    errors to propagate — everywhere in runtime/ modules, and inside the
    `_fit_*` training-loop drivers of any module."""
    if _is_runtime_path(path):
        _lint_swallows_in(
            ast.walk(tree), path, "a runtime/ module", diags
        )
        return
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) and node.name.startswith(_FIT_LOOP_PREFIX):
            _lint_swallows_in(
                ast.walk(node),
                path,
                f"training-loop driver {node.name!r}",
                diags,
            )


# -- LINT007: concurrency discipline for runtime/ ---------------------------

_LOCK_FACTORIES = (
    "Lock",
    "RLock",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
)
# the supervision layer's routing primitives (see module docstring): a
# thread with access to any of these can surface its death/failure
_ROUTE_PRIMITIVES = ("on_hang", "raise_pending", "_async_raise")


def _is_lock_factory_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    return d is not None and d[-1] in _LOCK_FACTORIES


def _self_attr_name(node: ast.AST) -> Optional[str]:
    """'x' for a `self.x` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _has_fault_route(nodes) -> bool:
    """A FaultChannel reference (any *channel* identifier), a .post(...)
    call, or a supervision primitive anywhere in `nodes`."""
    for node in nodes:
        if isinstance(node, ast.Attribute):
            ident = node.attr
        elif isinstance(node, ast.Name):
            ident = node.id
        else:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "post"
            ):
                return True
            continue
        low = ident.lower()
        if "channel" in low or ident in _ROUTE_PRIMITIVES:
            return True
    return False


def _thread_target_attr(call: ast.Call) -> Optional[str]:
    """'_run' for threading.Thread(target=self._run, ...) / Thread(...);
    the bare name for Thread(target=worker). None otherwise."""
    d = _dotted(call.func)
    if d is None or d[-1] != "Thread":
        return None
    for kw in call.keywords:
        if kw.arg == "target":
            td = _dotted(kw.value)
            if td is not None:
                return td[-1]
    return None


def _lint_unlocked_mutations(
    fn: ast.AST, lock_attrs, path: str, diags: List[Diagnostic]
) -> None:
    """Flag `self.attr = ...` in the thread target's OWN body outside a
    `with self.<lock>:` block (nested defs are their own context)."""

    def visit(node, locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.With):
            holds = locked or any(
                _self_attr_name(item.context_expr) in lock_attrs
                for item in node.items
            )
            for child in ast.iter_child_nodes(node):
                visit(child, holds)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)) and not locked:
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                attr = _self_attr_name(t)
                if attr is not None and attr not in lock_attrs:
                    diags.append(
                        error(
                            "LINT007",
                            f"thread target {fn.name!r} assigns shared "
                            f"instance state `self.{attr}` without "
                            "holding the owning class's lock — a "
                            "cross-thread data race",
                            path=path,
                            line=node.lineno,
                            hint="wrap the mutation in `with self.<lock>:`"
                            " (Lock/RLock/Condition) or hand the value "
                            "over through a queue/FaultChannel",
                        )
                    )
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in fn.body:
        visit(stmt, False)


def _lint_thread_discipline(
    tree: ast.AST, path: str, diags: List[Diagnostic]
) -> None:
    """LINT007 over one runtime/ module (see module docstring)."""
    if not _is_runtime_path(path):
        return
    # TOP-LEVEL functions only: a class method sharing a module function's
    # name must not shadow it (ast.walk order would let it), or a bare
    # `Thread(target=module_fn)` silently escapes the route check
    module_funcs = {
        n.name: n
        for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    for cls in classes:
        methods = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        lock_attrs = {
            _self_attr_name(t)
            for m in methods.values()
            for node in ast.walk(m)
            if isinstance(node, ast.Assign)
            and _is_lock_factory_call(node.value)
            for t in node.targets
            if _self_attr_name(t)
        }
        thread_sites: List[Tuple[str, int]] = []  # (target name, lineno)
        for m in methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Call):
                    target = _thread_target_attr(node)
                    if target is not None:
                        thread_sites.append((target, node.lineno))
        if any(
            _dotted(b) is not None and _dotted(b)[-1] == "Thread"
            for b in cls.bases
        ) and "run" in methods:
            thread_sites.append(("run", methods["run"].lineno))
        if not thread_sites:
            continue
        for target, _lineno in thread_sites:
            fn = methods.get(target)
            if fn is not None:
                _lint_unlocked_mutations(fn, lock_attrs, path, diags)
        # the route is a CLASS-level property: check once, not per site
        if not _has_fault_route(ast.walk(cls)):
            targets = ", ".join(repr(t) for t, _ in thread_sites)
            diags.append(
                error(
                    "LINT007",
                    f"class {cls.name!r} starts thread(s) "
                    f"(target {targets}) with no fault route: a "
                    "failure in them never reaches the supervision "
                    "layer (the run keeps going silently "
                    "uncheckpointed/unfed)",
                    path=path,
                    line=thread_sites[0][1],
                    hint="post failures to a FaultChannel (or invoke "
                    "a supervision primitive) so the fit loop's next "
                    "window boundary surfaces them",
                )
            )
    # bare-function thread targets (no owning class): the route must live
    # in the target body itself. Construction sites inside classes were
    # handled above — a class's `Thread(target=self._run)` must not be
    # re-attributed to a same-named top-level function.
    class_calls = {
        id(node)
        for cls in classes
        for node in ast.walk(cls)
        if isinstance(node, ast.Call)
    }
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or id(node) in class_calls:
            continue
        target = _thread_target_attr(node)
        if target is None:
            continue
        fn = module_funcs.get(target)
        if fn is None:
            continue
        _lint_unlocked_mutations(fn, frozenset(), path, diags)
        if not _has_fault_route(ast.walk(fn)):
            diags.append(
                error(
                    "LINT007",
                    f"thread target {target!r} has no fault route: a "
                    "failure in it never reaches the supervision layer",
                    path=path,
                    line=node.lineno,
                    hint="post failures to a FaultChannel so the fit "
                    "loop's next window boundary surfaces them",
                )
            )


# -- LINT009: literal seeds inside step bodies -------------------------------


def _lint_literal_seed(fn: ast.AST, path: str, diags: List[Diagnostic]) -> None:
    """Flag `torch.manual_seed(<literal>)` and `<g>.manual_seed(<literal>)`
    anywhere inside step body `fn` (nested defs included: they run inside
    the step)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed"):
            continue
        seeds = list(node.args) + [kw.value for kw in node.keywords]
        if not seeds or not all(isinstance(a, ast.Constant) for a in seeds):
            continue  # a seed derived from the carried state is a different discussion
        diags.append(
            error(
                "LINT009",
                f"literal {ast.unparse(node.func)}(...) inside step body {fn.name!r}: a "
                "fresh constant seed mid-step restarts the stream every step and is "
                "invisible to the restored generator — bitwise resume replays different "
                "randomness",
                path=path,
                line=node.lineno,
                hint="draw from the generator the step is given (the fit loop carries and "
                "checkpoints it); seed literals only outside step bodies",
            )
        )


def lint_source(text: str, path: str = "<string>") -> List[Diagnostic]:
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [
            error(
                "LINT000",
                f"syntax error: {e.msg}",
                path=path,
                line=e.lineno,
            )
        ]
    diags: List[Diagnostic] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _is_graph_body(node):
            _lint_jit_body(node, path, diags)
        if node.name in _STEP_BODIES:
            _lint_literal_seed(node, path, diags)
        if node.name.startswith(_FIT_LOOP_PREFIX):
            _lint_jit_body(
                node, path, diags, rule="LINT005",
                context="training-loop driver",
                nodes=_walk_excluding_nested_defs(node),
            )
    _lint_id_keys(tree, path, diags)
    _lint_unordered_iteration(tree, path, diags)
    _lint_swallows(tree, path, diags)
    _lint_thread_discipline(tree, path, diags)
    return diags


def lint_file(path: str) -> List[Diagnostic]:
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [error("LINT000", f"cannot read file: {e}", path=path)]
    return lint_source(text, path)


def lint_package(root: Optional[str] = None) -> List[Diagnostic]:
    """Lint every .py file under `root` (default: the port's package, which
    this module lives in)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    diags: List[Diagnostic] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                diags.extend(lint_file(os.path.join(dirpath, fn)))
    return diags

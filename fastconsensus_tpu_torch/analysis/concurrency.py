"""fcheck-concurrency: static race and lock-discipline analysis of the
port.

The port's own copy of the reference's ``analysis/concurrency.py``.  The
serving stack runs HTTP handler threads, a dispatcher, device-pinned
worker threads and the mesh group's ``MeshWorker``; a snapshot read
racing a worker's dict mutation changes no result, only whether
``/metricsz`` now and then throws ``RuntimeError: dictionary changed
size during iteration`` (the kernel-launch block of the replica's
``/metricsz`` once did, found by hand in review).  This pass makes the
discipline machine-checked.

The analysis is whole-program: ``lint_paths`` hands it the complete
scanned source set, and summaries resolve across modules the way the
cross-function ``key-reuse`` table does: local defs, import aliases,
plus one deliberately type-blind fallback for attribute calls
(``self.cache.get`` reaches every scanned method named ``get`` on a
class whose name contains the receiver identifier).  Over-approximate
on purpose: extra edges mean extra findings, never missed ones, and the
pragma convention absorbs the occasional false positive.

Five rules, as in the reference:

``guarded-field``
    Per class, every ``self._x`` touched at least once inside
    ``with self.<lock>:`` is inferred to be *lock-guarded*; an access to
    the same field outside any own-lock ``with`` (outside ``__init__``,
    which runs before the object is shared) is a race candidate.  Fires
    only when the accessing methods are reachable from more than one
    thread root (``threading.Thread(target=...)`` targets plus the
    implicit external caller root, propagated through the call graph).
    Accesses in *receiver position* (``self._reg.inc(...)``) are exempt;
    reads of another class's underscore-private guarded field
    (``other._events[...]``) fire too.

``lock-order``
    The acquisition-order digraph: ``with B:`` while A is held adds the
    edge A -> B, lexically and through call chains.  Locks are keyed
    per declaration site (``module.Class._attr`` / ``module._name``),
    so all instances of one class are one node and a self-edge IS a
    finding.  Any cycle is a potential deadlock.  The runtime half
    (``analysis/lockorder.py``, turned on by ``lockorder.recording()``)
    records the *observed* digraph, and its union with this static
    graph must stay acyclic.

``blocking-under-lock``
    A call that can block indefinitely, executed while holding any
    lock, resolved transitively through helpers: device dispatch
    (``run_consensus`` / ``run_consensus_batch``: each runs a whole
    consensus job on the card), the host syncs of eager PyTorch
    (``torch.cuda.synchronize()`` and ``Event`` / ``Stream``
    ``.synchronize()``, and the readbacks ``.item()``, ``.tolist()``,
    ``.cpu()`` and ``.numpy()``, each of which waits for the card's
    queue to drain up to that tensor), ``Thread.join``, socket/HTTP
    traffic, ``subprocess.run``, ``time.sleep``, or ``Condition.wait()``
    with no timeout while a lock *other than the condition's own* is
    held.  The reference's jax entries (``jax.device_get``,
    ``.block_until_ready()``) are dropped: no torch code calls them, and
    the torch syncs above take their place.

``notify-outside-lock``
    ``Condition.notify()`` / ``notify_all()`` not lexically inside
    ``with <same condition>:``.

``unguarded-root-write``
    A write inside a worker-thread root to shared state (a ``self``
    attribute or ``global`` name also touched from a different thread
    root) with no lock held and no guarded access anywhere.

All rules honor ``# fcheck: ok=<rule>: <reason>`` pragmas
(diagnostics.parse_pragmas), counted in the JSON report like every
other suppression.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                          apply_pragmas)

# threading factories whose assignment declares a lock (lock identity is
# keyed on the declaration site).
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
# Intrinsically blocking calls (rule `blocking-under-lock`), by method
# name on any receiver: I/O, and the host syncs of eager PyTorch
# (``torch.cuda.synchronize`` and ``Event``/``Stream.synchronize``, and
# the readbacks that wait for the card's queue):
_BLOCKING_ATTRS = {"recv", "recv_into", "accept", "connect", "sendall",
                   "getresponse", "synchronize", "item", "tolist", "cpu",
                   "numpy"}
# ... and by (module, function):
_BLOCKING_QUALIFIED = {
    ("torch.cuda", "synchronize"), ("time", "sleep"),
    ("subprocess", "run"), ("subprocess", "check_call"),
    ("subprocess", "check_output"),
}
# Project device-dispatch entry points: a consensus call is an
# unbounded wait on the card's queue from the host's point of view.
_DEVICE_DISPATCH = {"run_consensus", "run_consensus_batch"}
_THREADISH = ("thread", "worker", "dispatcher", "proc", "child")

EXTERNAL_ROOT = "<external>"

CONCURRENCY_RULES = ("guarded-field", "lock-order",
                     "blocking-under-lock", "notify-outside-lock",
                     "unguarded-root-write")


def _call_name(node: ast.Call) -> Tuple[Optional[str], str]:
    """(dotted qualifier, attr/function name) of a call target."""
    f = node.func
    if isinstance(f, ast.Name):
        return None, f.id
    if isinstance(f, ast.Attribute):
        parts = []
        v = f.value
        while isinstance(v, ast.Attribute):
            parts.append(v.attr)
            v = v.value
        if isinstance(v, ast.Name):
            parts.append(v.id)
            return ".".join(reversed(parts)), f.attr
        return None, f.attr
    return None, ""


def _module_name(path: str) -> str:
    """Dotted module key of a scanned file — the SAME keying the
    key-reuse summary table uses, so the two cross-module passes
    resolve identically."""
    from fastconsensus_tpu_torch.analysis import _module_name as shared

    return shared(path)


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — display-only fallback
        return "<expr>"


class _FnInfo:
    """Per-function concurrency summary (one pass over the body)."""

    def __init__(self, module: str, cls: Optional[str], name: str,
                 node: ast.FunctionDef, filename: str) -> None:
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.filename = filename
        self.ref = f"{module}.{cls}.{name}" if cls else f"{module}.{name}"
        # (lock key, line, col) acquisitions; lexical nesting edges
        self.acquisitions: List[Tuple[str, int, int]] = []
        self.lexical_edges: Set[Tuple[str, str]] = set()
        # calls with >= 1 lock lexically held: (held, qual, name, node)
        self.calls_under: List[Tuple[FrozenSet[str], Optional[str], str,
                                     ast.Call]] = []
        # every call (call graph / reachability / lock propagation)
        self.calls: List[Tuple[Optional[str], str]] = []
        # structural accesses on self: attr -> [(guard lock key | None,
        # line, col, is_write)]
        self.self_accesses: Dict[str, List[Tuple[Optional[str], int, int,
                                                 bool]]] = {}
        # structural reads on non-self receivers: (attr, line, col, held)
        self.other_accesses: List[Tuple[str, int, int,
                                        FrozenSet[str]]] = []
        # self attributes that appear as a dotted-through receiver
        # (``self._batches.popleft()`` / ``self.buckets.get``): the
        # mutation-signal half of the guarded-field table — containers
        # are mutated through bound methods, which the structural
        # access record cannot see as writes
        self.receiver_uses: Set[str] = set()
        # global-declared name accesses: name -> [(guard, line, col,
        # is_write)]
        self.global_accesses: Dict[str, List[Tuple[Optional[str], int,
                                                   int, bool]]] = {}
        self.global_names: Set[str] = {
            n for g in ast.walk(node) if isinstance(g, ast.Global)
            for n in g.names}
        self.direct_diags: List[Diagnostic] = []
        self.blocks_directly = False
        self.thread_targets: List[str] = []   # Thread(target=...) refs


class _ModuleInfo:
    def __init__(self, module: str, filename: str, source: str) -> None:
        self.module = module
        self.filename = filename
        self.source = source
        self.functions: Dict[str, _FnInfo] = {}
        self.classes: Dict[str, Dict[str, _FnInfo]] = {}
        self.class_locks: Dict[str, Dict[str, int]] = {}
        self.module_locks: Dict[str, int] = {}
        self.alias_modules: Dict[str, str] = {}
        self.from_imports: Dict[str, Tuple[str, str]] = {}


class ConcurrencyAnalyzer:
    """Whole-program pass over a ``{filename: source}`` set."""

    def __init__(self, sources: Dict[str, str]) -> None:
        self.sources = sources
        self.modules: Dict[str, _ModuleInfo] = {}
        self.diags: List[Diagnostic] = []
        # lock declaration sites: (abspath, line) -> lock key
        self.lock_sites: Dict[Tuple[str, int], str] = {}
        # static acquisition-order digraph: edge -> first witness site
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # ---------------- collection ----------------

    def collect(self) -> None:
        for filename, source in self.sources.items():
            try:
                tree = ast.parse(source, filename=filename)
            # fcheck: ok=swallowed-error (astlint reports the syntax
            # error itself; this pass just skips the unparsable file)
            except SyntaxError:
                continue  # astlint reports the syntax error itself
            mod = _ModuleInfo(_module_name(filename), filename, source)
            self._collect_imports(tree, mod)
            self._collect_locks(tree, mod)
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fn = _FnInfo(mod.module, None, node.name, node,
                                 filename)
                    self._summarize(fn, mod)
                    mod.functions[node.name] = fn
                elif isinstance(node, ast.ClassDef):
                    methods: Dict[str, _FnInfo] = {}
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            fn = _FnInfo(mod.module, node.name,
                                         sub.name, sub, filename)
                            self._summarize(fn, mod)
                            methods[sub.name] = fn
                    mod.classes[node.name] = methods
            self.modules[mod.module] = mod

    @staticmethod
    def _collect_imports(tree: ast.Module, mod: _ModuleInfo) -> None:
        for stmt in tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.asname:
                        mod.alias_modules[a.asname] = a.name
            elif isinstance(stmt, ast.ImportFrom) and stmt.level == 0 \
                    and stmt.module:
                for a in stmt.names:
                    alias = a.asname or a.name
                    mod.alias_modules.setdefault(
                        alias, f"{stmt.module}.{a.name}")
                    mod.from_imports[alias] = (stmt.module, a.name)

    def _collect_locks(self, tree: ast.Module, mod: _ModuleInfo) -> None:
        """Lock declaration sites: module-level ``X = threading.Lock()``
        and ``self._x = threading.Lock()`` anywhere inside a class."""
        def is_lock_call(value: ast.AST) -> bool:
            if not isinstance(value, ast.Call):
                return False
            qual, name = _call_name(value)
            return name in _LOCK_FACTORIES and (
                qual is None or qual == "threading" or
                qual.endswith(".threading"))

        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and is_lock_call(stmt.value):
                name = stmt.targets[0].id
                mod.module_locks[name] = stmt.lineno
                self.lock_sites[(os.path.abspath(mod.filename),
                                 stmt.lineno)] = f"{mod.module}.{name}"
            elif isinstance(stmt, ast.ClassDef):
                attrs: Dict[str, int] = {}
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Assign) and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0], ast.Attribute) \
                            and isinstance(node.targets[0].value,
                                           ast.Name) \
                            and node.targets[0].value.id == "self" \
                            and is_lock_call(node.value):
                        attr = node.targets[0].attr
                        attrs[attr] = node.lineno
                        self.lock_sites[
                            (os.path.abspath(mod.filename),
                             node.lineno)] = \
                            f"{mod.module}.{stmt.name}.{attr}"
                if attrs:
                    mod.class_locks[stmt.name] = attrs

    # ---------------- per-function summary ----------------

    def _lock_key_of(self, expr: ast.AST, fn: _FnInfo,
                     mod: _ModuleInfo) -> Optional[str]:
        """The lock key an expression denotes, or None: ``self._x``
        against the class's declared lock attrs, a bare name against
        the module's lock globals."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and fn.cls is not None:
            if expr.attr in mod.class_locks.get(fn.cls, {}):
                return f"{mod.module}.{fn.cls}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in mod.module_locks:
            return f"{mod.module}.{expr.id}"
        return None

    def _summarize(self, fn: _FnInfo, mod: _ModuleInfo) -> None:
        self._with_exprs: Tuple[str, ...] = ()
        self._walk(list(fn.node.body), fn, mod, held=(), with_exprs=())

    def _walk(self, stmts: List[ast.stmt], fn: _FnInfo,
              mod: _ModuleInfo, held: Tuple[str, ...],
              with_exprs: Tuple[str, ...]) -> None:
        for stmt in stmts:
            # the notify rule needs the lexical with-stack at expression
            # scan time; re-established per statement because nested
            # _walk calls overwrite it
            self._with_exprs = with_exprs
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs run on unknown threads; skipped
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = list(held)
                new_with = list(with_exprs)
                for item in stmt.items:
                    self._expr(item.context_expr, fn, mod, held, "plain")
                    key = self._lock_key_of(item.context_expr, fn, mod)
                    if key is not None:
                        for h in new_held:
                            fn.lexical_edges.add((h, key))
                        fn.acquisitions.append(
                            (key, stmt.lineno, stmt.col_offset))
                        new_held.append(key)
                    new_with.append(_unparse(item.context_expr))
                self._walk(stmt.body, fn, mod, tuple(new_held),
                           tuple(new_with))
                continue
            if isinstance(stmt, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                if stmt.value is not None:
                    self._expr(stmt.value, fn, mod, held, "plain")
                for t in targets:
                    self._store(t, fn, mod, held,
                                also_read=isinstance(stmt, ast.AugAssign))
                continue
            if isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    self._store(t, fn, mod, held, also_read=False)
                continue
            for field in ("test", "iter", "value", "exc", "msg"):
                child = getattr(stmt, field, None)
                if isinstance(child, ast.expr):
                    self._expr(child, fn, mod, held, "plain")
            if isinstance(stmt, ast.Expr):
                pass  # covered by the "value" field above
            for field in ("body", "orelse", "finalbody"):
                block = getattr(stmt, field, None)
                if isinstance(block, list) and block and \
                        isinstance(block[0], ast.stmt):
                    self._walk(block, fn, mod, held, with_exprs)
            for h in getattr(stmt, "handlers", ()):
                self._walk(h.body, fn, mod, held, with_exprs)

    def _store(self, target: ast.AST, fn: _FnInfo, mod: _ModuleInfo,
               held: Tuple[str, ...], also_read: bool) -> None:
        guard = held[-1] if held else None
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._store(el, fn, mod, held, also_read)
            return
        if isinstance(target, ast.Starred):
            self._store(target.value, fn, mod, held, also_read)
            return
        if isinstance(target, ast.Subscript):
            # writing THROUGH a container mutates the container: the
            # base is a structural access (del self._jobs[k] included)
            self._expr(target.value, fn, mod, held, "plain",
                       force_write=True)
            self._expr(target.slice, fn, mod, held, "plain")
            return
        if isinstance(target, ast.Attribute):
            if isinstance(target.value, ast.Name) and \
                    target.value.id == "self":
                fn.self_accesses.setdefault(target.attr, []).append(
                    (guard, target.lineno, target.col_offset, True))
                if also_read:
                    fn.self_accesses[target.attr].append(
                        (guard, target.lineno, target.col_offset,
                         False))
            else:
                self._expr(target.value, fn, mod, held, "base")
            return
        if isinstance(target, ast.Name):
            if target.id in fn.global_names and \
                    target.id not in mod.module_locks:
                fn.global_accesses.setdefault(target.id, []).append(
                    (guard, target.lineno, target.col_offset, True))

    def _expr(self, node: Optional[ast.AST], fn: _FnInfo,
              mod: _ModuleInfo, held: Tuple[str, ...], role: str,
              force_write: bool = False) -> None:
        """Role-aware expression scan.  ``role``:

        * ``plain`` — a genuine data read (argument, operand, subscript
          base, iteration source): records structural accesses;
        * ``callee`` — the func of a Call (``self._reg.inc``): the
          terminal attribute is a method name, and the chain below it
          is reference plumbing — nothing is recorded;
        * ``base`` — the receiver chain under an attribute/callee:
          plumbing, nothing recorded.
        """
        if node is None:
            return
        guard = held[-1] if held else None
        if isinstance(node, ast.Call):
            self._scan_call(node, fn, mod, held)
            self._expr(node.func, fn, mod, held, "callee")
            for a in node.args:
                self._expr(a.value if isinstance(a, ast.Starred) else a,
                           fn, mod, held, "plain")
            for kw in node.keywords:
                self._expr(kw.value, fn, mod, held, "plain")
            return
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                if role == "plain":
                    fn.self_accesses.setdefault(node.attr, []).append(
                        (guard, node.lineno, node.col_offset,
                         force_write))
                else:
                    fn.receiver_uses.add(node.attr)
                return
            if role == "plain":
                fn.other_accesses.append(
                    (node.attr, node.lineno, node.col_offset,
                     frozenset(held)))
            self._expr(node.value, fn, mod, held, "base")
            return
        if isinstance(node, ast.Subscript):
            self._expr(node.value, fn, mod, held, "plain")
            self._expr(node.slice, fn, mod, held, "plain")
            return
        if isinstance(node, ast.Name):
            if role == "plain" and node.id in fn.global_names and \
                    node.id not in mod.module_locks:
                fn.global_accesses.setdefault(node.id, []).append(
                    (guard, node.lineno, node.col_offset, False))
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, fn, mod, held, "plain")
            elif isinstance(child, (ast.comprehension,)):
                self._expr(child.iter, fn, mod, held, "plain")
                for cond in child.ifs:
                    self._expr(cond, fn, mod, held, "plain")

    # -- calls: graph edges, thread roots, blocking, notify ------------

    def _scan_call(self, node: ast.Call, fn: _FnInfo,
                   mod: _ModuleInfo, held: Tuple[str, ...]) -> None:
        qual, name = _call_name(node)
        fn.calls.append((qual, name))
        if held:
            fn.calls_under.append((frozenset(held), qual, name, node))
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    ref = self._target_ref(kw.value, fn, mod)
                    if ref is not None:
                        fn.thread_targets.append(ref)
        if name in ("notify", "notify_all") and \
                isinstance(node.func, ast.Attribute):
            recv = _unparse(node.func.value)
            if self._lock_key_of(node.func.value, fn, mod) is not None \
                    and recv not in self._with_exprs:
                fn.direct_diags.append(Diagnostic(
                    rule="notify-outside-lock",
                    message=f"{recv}.{name}() is not lexically inside "
                            f"'with {recv}:': notifying an unheld "
                            "condition raises RuntimeError on exactly "
                            "the path nobody tested",
                    file=fn.filename, line=node.lineno,
                    col=node.col_offset))
        blocking = self._blocking_reason(qual, name, node, fn, mod,
                                         held)
        if blocking is not None:
            fn.blocks_directly = True
            if held:
                fn.direct_diags.append(Diagnostic(
                    rule="blocking-under-lock",
                    message=f"{blocking} while holding "
                            f"{sorted(held)}: every thread that needs "
                            "the lock now waits on this call too",
                    file=fn.filename, line=node.lineno,
                    col=node.col_offset))

    def _blocking_reason(self, qual: Optional[str], name: str,
                         node: ast.Call, fn: _FnInfo, mod: _ModuleInfo,
                         held: Tuple[str, ...]) -> Optional[str]:
        """Why this call is intrinsically blocking, or None.  (Sets the
        transitive may-block bit even with no lock held; the report
        itself only fires under a lock.)"""
        if name in _DEVICE_DISPATCH:
            return f"device dispatch {name}(...)"
        if name in _BLOCKING_ATTRS and isinstance(node.func,
                                                  ast.Attribute):
            return f".{name}() (blocking I/O / device sync)"
        if qual is not None:
            base = mod.alias_modules.get(qual, qual)
            for bq, bn in _BLOCKING_QUALIFIED:
                if name == bn and (base == bq or
                                   base.startswith(bq + ".")):
                    return f"{bq}.{bn}(...)"
            if name == "urlopen" and "urllib" in base:
                return "urllib urlopen(...)"
        if name == "join" and isinstance(node.func, ast.Attribute) \
                and not node.args and not node.keywords:
            recv = _unparse(node.func.value).lower()
            if any(t in recv for t in _THREADISH) or \
                    recv.startswith("self."):
                return f"{_unparse(node.func.value)}.join() " \
                       "(unbounded thread join)"
        if name == "wait" and isinstance(node.func, ast.Attribute) \
                and not node.args and not any(
                    kw.arg == "timeout" for kw in node.keywords):
            # Condition.wait() with no timeout: holding the condition's
            # OWN lock is the protocol; any OTHER held lock sleeps with
            # the waiter forever
            own = self._lock_key_of(node.func.value, fn, mod)
            foreign = [h for h in held if h != own]
            if foreign:
                return f"{_unparse(node.func.value)}.wait() with no " \
                       f"timeout (foreign lock(s) {sorted(foreign)} " \
                       "held through the wait)"
            return None
        return None

    def _target_ref(self, expr: ast.AST, fn: _FnInfo,
                    mod: _ModuleInfo) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and fn.cls is not None:
            return f"{mod.module}.{fn.cls}.{expr.attr}"
        if isinstance(expr, ast.Name):
            if expr.id in mod.functions:
                return f"{mod.module}.{expr.id}"
            tgt = mod.from_imports.get(expr.id)
            if tgt is not None:
                return f"{tgt[0]}.{tgt[1]}"
        return None

    # ---------------- cross-function resolution ----------------

    def _all_fns(self):
        for mod in self.modules.values():
            yield from mod.functions.values()
            for methods in mod.classes.values():
                yield from methods.values()

    def _build_tables(self) -> None:
        self.by_ref: Dict[str, _FnInfo] = {}
        self.by_method: Dict[str, List[_FnInfo]] = {}
        for fn in self._all_fns():
            self.by_ref[fn.ref] = fn
            self.by_method.setdefault(fn.name, []).append(fn)

    def _resolve(self, caller: _FnInfo, qual: Optional[str],
                 name: str) -> List[_FnInfo]:
        """Callees a call may reach (module docstring: name-based with
        a receiver-identifier/class-name containment fallback)."""
        mod = self.modules[caller.module]
        if qual is None:
            local = self.by_ref.get(f"{caller.module}.{name}")
            if local is not None:
                return [local]
            tgt = mod.from_imports.get(name)
            if tgt is not None:
                hit = self.by_ref.get(f"{tgt[0]}.{tgt[1]}")
                return [hit] if hit is not None else []
            return []
        if qual == "self" and caller.cls is not None:
            own = self.by_ref.get(f"{caller.module}.{caller.cls}.{name}")
            if own is not None:
                return [own]
        base = mod.alias_modules.get(qual, qual)
        direct = self.by_ref.get(f"{base}.{name}")
        if direct is not None:
            return [direct]
        ident = qual.rsplit(".", 1)[-1].lstrip("_").lower()
        if not ident:
            return []
        out = []
        for cand in self.by_method.get(name, ()):
            if cand.cls is None:
                continue
            cname = cand.cls.lstrip("_").lower()
            if ident in cname or cname in ident:
                out.append(cand)
        return out

    def _compute_roots(self) -> Dict[str, Set[str]]:
        """Thread-root sets per function ref, to fixpoint: Thread
        targets are worker roots; callers' roots propagate to callees;
        a function nobody scanned calls is an entry point and carries
        the implicit EXTERNAL root."""
        callers: Dict[str, Set[str]] = {}
        worker_roots: Set[str] = set()
        for fn in self._all_fns():
            worker_roots.update(fn.thread_targets)
            for qual, name in fn.calls:
                for callee in self._resolve(fn, qual, name):
                    callers.setdefault(callee.ref, set()).add(fn.ref)
        roots: Dict[str, Set[str]] = {}
        for fn in self._all_fns():
            r: Set[str] = set()
            if fn.ref in worker_roots:
                r.add(fn.ref)
            elif fn.ref not in callers:
                r.add(EXTERNAL_ROOT)
            roots[fn.ref] = r
        changed = True
        while changed:
            changed = False
            for ref, callset in callers.items():
                cur = roots.setdefault(ref, set())
                for caller in callset:
                    extra = roots.get(caller, set()) - cur
                    if extra:
                        cur.update(extra)
                        changed = True
        return roots

    def _transitive_acquisitions(self) -> Dict[str, Set[str]]:
        acq: Dict[str, Set[str]] = {
            fn.ref: {k for k, _, _ in fn.acquisitions}
            for fn in self._all_fns()}
        changed = True
        while changed:
            changed = False
            for fn in self._all_fns():
                cur = acq[fn.ref]
                for qual, name in fn.calls:
                    for callee in self._resolve(fn, qual, name):
                        extra = acq.get(callee.ref, set()) - cur
                        if extra:
                            cur.update(extra)
                            changed = True
        return acq

    def _transitive_blocking(self) -> Set[str]:
        blocks = {fn.ref for fn in self._all_fns() if fn.blocks_directly}
        changed = True
        while changed:
            changed = False
            for fn in self._all_fns():
                if fn.ref in blocks:
                    continue
                for qual, name in fn.calls:
                    if any(c.ref in blocks
                           for c in self._resolve(fn, qual, name)):
                        blocks.add(fn.ref)
                        changed = True
                        break
        return blocks

    # ---------------- rules ----------------

    def run(self) -> List[Diagnostic]:
        self.collect()
        self._build_tables()
        roots = self._compute_roots()
        self._rule_guarded_field(roots)
        self._rule_lock_order()
        self._rule_blocking_transitive()
        self._rule_root_writes(roots)
        for fn in self._all_fns():
            self.diags.extend(fn.direct_diags)
        return self.diags

    # -- rule 1: guarded-field ----------------------------------------

    def _rule_guarded_field(self, roots: Dict[str, Set[str]]) -> None:
        guarded: Dict[Tuple[str, str], Dict[str, str]] = {}
        for mod in self.modules.values():
            for cls, methods in mod.classes.items():
                if cls not in mod.class_locks:
                    continue
                init_names = ("__init__", "__new__", "__post_init__")
                mutated: Set[str] = set()
                for fn in methods.values():
                    if fn.name in init_names:
                        continue
                    mutated.update(fn.receiver_uses)
                    for attr, accs in fn.self_accesses.items():
                        if any(w for _, _, _, w in accs):
                            mutated.add(attr)
                table: Dict[str, str] = {}
                for fn in methods.values():
                    for attr, accs in fn.self_accesses.items():
                        if attr in mod.class_locks[cls] or \
                                attr not in mutated:
                            # no mutation outside __init__ anywhere in
                            # the class: an immutable reference (idx,
                            # config) needs no guard even when some
                            # method happens to read it under one
                            continue
                        for guard, _, _, _ in accs:
                            if guard is not None:
                                table.setdefault(attr, guard)
                if table:
                    guarded[(mod.module, cls)] = table
        # (a) same-class unguarded access, multi-root gated
        for (module, cls), table in guarded.items():
            mod = self.modules[module]
            methods = mod.classes[cls]
            for attr, lock_key in table.items():
                sites = []
                fn_roots: Set[str] = set()
                for fn in methods.values():
                    for guard, line, col, is_write in \
                            fn.self_accesses.get(attr, ()):
                        fn_roots.update(roots.get(fn.ref, ()))
                        if guard is None and fn.name not in (
                                "__init__", "__new__", "__post_init__"):
                            sites.append((fn, line, col, is_write))
                if len(fn_roots) < 2:
                    continue  # one thread root: no interleaving
                lock_attr = lock_key.rsplit(".", 1)[-1]
                for fn, line, col, is_write in sites:
                    what = "written" if is_write else "read"
                    self.diags.append(Diagnostic(
                        rule="guarded-field",
                        message=f"self.{attr} {what} outside 'with "
                                f"self.{lock_attr}:' but lock-guarded "
                                f"elsewhere in {cls}; its methods run "
                                f"on {len(fn_roots)} thread roots — "
                                "guard the access or pragma it with "
                                "the reason it is safe",
                        file=fn.filename, line=line, col=col))
        # (b) cross-object structural read of a private guarded field
        private = {attr: (cls, lock)
                   for (module, cls), table in guarded.items()
                   for attr, lock in table.items()
                   if attr.startswith("_")}
        for fn in self._all_fns():
            for attr, line, col, held in fn.other_accesses:
                hit = private.get(attr)
                if hit is None:
                    continue
                cls, lock_key = hit
                if fn.cls == cls or lock_key in held:
                    continue
                self.diags.append(Diagnostic(
                    rule="guarded-field",
                    message=f".{attr} of {cls} is lock-guarded inside "
                            f"its class ({lock_key}) but dereferenced "
                            "here from outside it without that lock — "
                            "use a locked accessor on the owner",
                    file=fn.filename, line=line, col=col))

    # -- rule 2: lock-order -------------------------------------------

    def _rule_lock_order(self) -> None:
        acq = self._transitive_acquisitions()
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for fn in self._all_fns():
            for a, b in fn.lexical_edges:
                edges.setdefault((a, b), (fn.filename, fn.node.lineno))
            for held, qual, name, node in fn.calls_under:
                for callee in self._resolve(fn, qual, name):
                    for b in acq.get(callee.ref, ()):
                        for a in held:
                            edges.setdefault(
                                (a, b), (fn.filename, node.lineno))
        self.edges = edges
        cyc = find_cycle(set(edges))
        if cyc is not None:
            nxt = cyc[1] if len(cyc) > 1 else cyc[0]
            filename, line = edges.get((cyc[0], nxt), ("<unknown>", 0))
            self.diags.append(Diagnostic(
                rule="lock-order",
                message="lock acquisition-order cycle: "
                        + " -> ".join(cyc + [cyc[0]])
                        + " — threads entering the cycle at different "
                        "locks deadlock; pick one global order (or "
                        "pragma the acquisition with why the orders "
                        "can never interleave)",
                file=filename, line=line))

    # -- rule 3: blocking through call chains -------------------------

    def _rule_blocking_transitive(self) -> None:
        blocks = self._transitive_blocking()
        for fn in self._all_fns():
            mod = self.modules[fn.module]
            for held, qual, name, node in fn.calls_under:
                if self._blocking_reason(qual, name, node, fn, mod,
                                         held) is not None:
                    continue  # direct hit, already reported
                hit = [c for c in self._resolve(fn, qual, name)
                       if c.ref in blocks]
                if hit:
                    self.diags.append(Diagnostic(
                        rule="blocking-under-lock",
                        message=f"{name}(...) can block (via "
                                f"{hit[0].ref}) and is called while "
                                f"holding {sorted(held)}: move the "
                                "call outside the lock or pragma it "
                                "with why the block is bounded",
                        file=fn.filename, line=node.lineno,
                        col=node.col_offset))

    # -- rule 5: unguarded writes from thread roots -------------------

    def _rule_root_writes(self, roots: Dict[str, Set[str]]) -> None:
        worker_roots: Set[str] = set()
        for fn in self._all_fns():
            worker_roots.update(fn.thread_targets)
        for fn in self._all_fns():
            if fn.ref not in worker_roots:
                continue
            mod = self.modules[fn.module]
            if fn.cls is not None:
                methods = mod.classes[fn.cls]
                lock_attrs = mod.class_locks.get(fn.cls, {})
                for attr, accs in fn.self_accesses.items():
                    if attr in lock_attrs:
                        continue
                    if any(g is not None for m in methods.values()
                           for g, _, _, _ in
                           m.self_accesses.get(attr, ())):
                        continue  # guarded-field's jurisdiction
                    others = [m for m in methods.values()
                              if m is not fn
                              and attr in m.self_accesses
                              and roots.get(m.ref, set())
                              - roots.get(fn.ref, set())]
                    if not others:
                        continue  # thread-confined (or same root)
                    for guard, line, col, is_write in accs:
                        if is_write and guard is None:
                            self.diags.append(Diagnostic(
                                rule="unguarded-root-write",
                                message=f"self.{attr} written in "
                                        f"thread root {fn.name}() "
                                        "with no lock, and also "
                                        f"touched by "
                                        f"{others[0].name}() on a "
                                        "different thread root — "
                                        "guard both sides or pragma "
                                        "with why the race is benign",
                                file=fn.filename, line=line, col=col))
            peers = list(mod.functions.values()) + [
                m for ms in mod.classes.values() for m in ms.values()]
            for name, accs in fn.global_accesses.items():
                if any(g is not None for p in peers
                       for g, _, _, _ in p.global_accesses.get(
                           name, ())):
                    continue
                shared = any(
                    p is not fn and name in p.global_accesses
                    and roots.get(p.ref, set())
                    - roots.get(fn.ref, set())
                    for p in peers)
                if not shared:
                    continue
                for guard, line, col, is_write in accs:
                    if is_write and guard is None:
                        self.diags.append(Diagnostic(
                            rule="unguarded-root-write",
                            message=f"module global {name!r} written "
                                    f"in thread root {fn.name}() with "
                                    "no lock while functions on other "
                                    "thread roots touch it — guard "
                                    "both sides or pragma with why "
                                    "the race is benign",
                            file=fn.filename, line=line, col=col))


def find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    """A cycle in the digraph as a node list (start not repeated), or
    None.  Deterministic: nodes and neighbors visited in sorted order.
    Shared by the static rule and the runtime recorder's assertion
    (analysis/lockorder.py)."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    for k in adj:
        adj[k].sort()
    color: Dict[str, int] = {}   # 1 = on stack, 2 = done
    path: List[str] = []

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = 1
        path.append(u)
        for v in adj.get(u, ()):
            c = color.get(v, 0)
            if c == 1:
                return path[path.index(v):]
            if c == 0:
                found = dfs(v)
                if found is not None:
                    return found
        path.pop()
        color[u] = 2
        return None

    for node in sorted(adj):
        if color.get(node, 0) == 0:
            found = dfs(node)
            if found is not None:
                return found
    return None


def check_concurrency(sources: Dict[str, str]
                      ) -> Tuple[List[Diagnostic], int]:
    """Run the whole-program concurrency pass over ``{filename:
    source}``; returns (diagnostics, n_suppressed), pragmas already
    applied per file."""
    analyzer = ConcurrencyAnalyzer(sources)
    raw = analyzer.run()
    by_file: Dict[str, List[Diagnostic]] = {}
    for d in raw:
        by_file.setdefault(d.file, []).append(d)
    kept: List[Diagnostic] = []
    suppressed = 0
    for filename, diags in by_file.items():
        k, s = apply_pragmas(diags, sources.get(filename, ""))
        kept.extend(k)
        suppressed += s
    return kept, suppressed


def static_lock_graph(sources: Dict[str, str]) -> Set[Tuple[str, str]]:
    """The static acquisition-order digraph over a source set (edge =
    (held, acquired) lock keys) — the half the runtime recorder
    (analysis/lockorder.py) is checked against."""
    analyzer = ConcurrencyAnalyzer(sources)
    analyzer.run()
    return set(analyzer.edges)


def lock_sites(sources: Dict[str, str]) -> Dict[Tuple[str, int], str]:
    """(abspath, lineno) of every lock declaration -> its static lock
    key, for mapping the runtime recorder's creation sites onto the
    static graph's vocabulary."""
    analyzer = ConcurrencyAnalyzer(sources)
    analyzer.collect()
    return dict(analyzer.lock_sites)

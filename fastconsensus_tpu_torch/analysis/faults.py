"""fcheck-fault: exception-flow and resource-lifecycle analysis of the
port.

The port's own copy of the reference's ``analysis/faults.py``.  The
serving stack lives by failure-isolation contracts: per-job error
absorption in ``server.py`` (a bad graph fails as itself, never as its
batch), cordon and requeue-with-exclusion in ``pool.py``, watchdog
post-mortem bundles, SIGTERM drain.  The concurrency pass audits who
may touch what; this pass audits where errors GO: which exception types
can reach which boundaries, which handlers eat errors the observability
stack can never see, and which resources leak on exactly the path
nobody tested.

Whole-program like concurrency.py: ``lint_paths`` hands it the
complete scanned source set, and per-function raise sets propagate
through the same name-based call resolution (local defs, ``from``
imports, ``self`` methods, and the deliberately type-blind
receiver-identifier/class-name containment fallback).  Over-approximate
on purpose: extra propagation edges mean extra findings, never missed
ones, and the pragma convention absorbs the occasional false positive.

The raise set of a function is: its explicit ``raise`` statements
(including handler re-raises, which re-throw the handler's caught
types), everything escaping its callees, plus a curated builtin-raiser
table (``urlopen`` -> URLError/HTTPError, ``socket.*`` -> OSError,
``np.load`` -> OSError/ValueError, ``torch.load`` -> OSError/
RuntimeError/UnpicklingError, ``json.loads`` -> JSONDecodeError,
``open`` -> OSError, ...).  Escape = not caught by any lexically
enclosing handler at the raise/call site, resolved through a merged
exception hierarchy: the builtin tree (plus ``torch.cuda.
OutOfMemoryError``, a RuntimeError) and every scanned ``class
X(SomeError)`` definition, the port's kernel-build errors among them;
unknown types are assumed direct Exception subclasses, so ``except
Exception`` absorbs them and nothing narrower does.
``NotImplementedError`` and ``AssertionError`` are excluded from the
escape rules (abstract-method stubs and invariant checks are supposed
to be loud), as are BaseException-only types (KeyboardInterrupt /
SystemExit: the drain path handles those by design, not by handler).

Four rules:

``escape-thread-root``
    An exception type reachable from a ``threading.Thread`` target
    that no handler absorbs before ``Thread.run``.  CPython prints the
    traceback to stderr and the thread dies — no cordon, no counter,
    no flight event, and for the dispatcher no pool.  Every thread
    root must route failures to the death machinery
    (``_Worker._die``-style) or carry a pragma saying why dying
    silently is acceptable.

``swallowed-error``
    An ``except`` body with no outlet: it neither re-raises, returns,
    records an error value (any assignment counts — binding a fallback
    IS the handled result), stamps an fcobs counter
    (``inc``/``gauge``/``observe``), records a flight event
    (``record``/``mark``), nor routes to the failure machinery
    (``_die``/``cordon``/``_fail*``/``send*``).  Logging is NOT an
    outlet: the obs stack cannot see a log line, and the fcobs core
    guarantees that failures are visible in ``/metricsz`` and the
    flight recorder.

``unmapped-http-error``
    An exception type reachable from an HTTP handler body
    (``do_GET``/``do_POST``/...) with no mapping to a status code.
    ``BaseHTTPRequestHandler`` turns an escaped exception into a
    silently dropped connection (or a 500 with a raw traceback) — the
    client sees a hang, not the 4xx/5xx + JSON error body the wire
    contract promises.

``resource-leak``
    Lifecycle holes on the error path: a ``threading.Thread`` started
    without ``daemon=`` and never joined; ``.acquire()`` with no
    ``.release()`` in a ``finally``; a file/socket/tempdir opened
    outside ``with`` whose close/cleanup is skipped when an exception
    fires between open and close.  Returning the resource (ownership
    transfer) and class-attribute bindings closed by any method of the
    class (object lifetime) are compliant.

The runtime half closes the loop the way ``analysis/lockorder.py``
does for the lock-order rule: ``--emit-fault-inventory`` writes every
raise site in the port's ``serve/`` plus the boundary this pass claims
absorbs it (committed as ``analysis/fault_inventory.json``), and
``serve/faultinject.py`` (``FCTPU_FAULT_INJECT=<site_id>``) patches any
inventoried site to throw on demand, so a live pool can show per site
that the claimed contract holds.

All rules honor ``# fcheck: ok=<rule>: <reason>`` pragmas
(diagnostics.parse_pragmas), counted like every other suppression.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                          apply_pragmas)

FAULT_RULES = ("escape-thread-root", "swallowed-error",
               "unmapped-http-error", "resource-leak")

EXTERNAL_BOUNDARY = "<external>"

# The builtin exception tree, child -> parent, restricted to what the
# codebase's raise sites and the raiser table below can produce.  The
# project's own ``class X(SomeError)`` definitions are merged on top at
# collect time; anything still unknown is treated as a direct Exception
# subclass.
_EXC_PARENTS: Dict[str, str] = {
    "Exception": "BaseException",
    "KeyboardInterrupt": "BaseException",
    "SystemExit": "BaseException",
    "GeneratorExit": "BaseException",
    "ArithmeticError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "AssertionError": "Exception",
    "AttributeError": "Exception",
    "ImportError": "Exception",
    "ModuleNotFoundError": "ImportError",
    "LookupError": "Exception",
    "KeyError": "LookupError",
    "IndexError": "LookupError",
    "MemoryError": "Exception",
    "NameError": "Exception",
    "OSError": "Exception",
    "IOError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "PermissionError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "InterruptedError": "OSError",
    "BlockingIOError": "OSError",
    "ConnectionError": "OSError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "BrokenPipeError": "ConnectionError",
    "TimeoutError": "OSError",
    "URLError": "OSError",
    "HTTPError": "URLError",
    "RuntimeError": "Exception",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "StopIteration": "Exception",
    "TypeError": "Exception",
    "ValueError": "Exception",
    "UnicodeError": "ValueError",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
    "JSONDecodeError": "ValueError",
    "PickleError": "Exception",
    "UnpicklingError": "PickleError",
    # torch.cuda.OutOfMemoryError
    "OutOfMemoryError": "RuntimeError",
}

# Curated builtin raisers, (module prefix, function) -> raised types.
# Deliberately short: explicit ``raise`` statements dominate the
# project's fault surface; this table covers the I/O edges whose
# failures arrive from outside the process.
_RAISERS_QUALIFIED: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("urllib.request", "urlopen"): ("URLError", "HTTPError"),
    ("socket", "create_connection"): ("OSError",),
    ("socket", "socket"): ("OSError",),
    ("numpy", "load"): ("OSError", "ValueError"),
    ("numpy", "save"): ("OSError",),
    ("torch", "load"): ("OSError", "RuntimeError", "UnpicklingError"),
    ("json", "loads"): ("JSONDecodeError",),
    ("json", "load"): ("JSONDecodeError", "OSError"),
    ("os", "makedirs"): ("OSError",),
    ("os", "replace"): ("OSError",),
    ("os", "remove"): ("OSError",),
    ("os", "unlink"): ("OSError",),
    ("os", "rename"): ("OSError",),
    ("shutil", "rmtree"): ("OSError",),
    ("tempfile", "mkdtemp"): ("OSError",),
}
_RAISERS_BARE: Dict[str, Tuple[str, ...]] = {
    "open": ("OSError",),
}

# Types the escape rules ignore (module docstring: stubs and invariant
# checks are supposed to be loud; BaseException-only types are the
# drain path's business).
_ESCAPE_IGNORED = {"NotImplementedError", "AssertionError",
                   "KeyboardInterrupt", "SystemExit", "GeneratorExit",
                   "StopIteration", "MemoryError"}

_HTTP_HANDLER_NAMES = {"do_GET", "do_POST", "do_PUT", "do_DELETE",
                       "do_PATCH", "do_HEAD"}

# except-body call names that count as an outlet (terminal attr/func
# name, underscores stripped): the fcobs registry verbs, the flight
# recorder verbs, and the serving stack's failure machinery.
_OUTLET_CALL_NAMES = {"inc", "gauge", "observe", "record", "mark",
                      "cordon", "write_bundle", "die", "fail",
                      "fail_job", "requeue_pending", "on_worker_death",
                      "set_exception", "abort"}

# resource factories for the leak rule: (resolved module, name) or
# bare-name builtins -> human kind
_RESOURCE_QUALIFIED: Dict[Tuple[str, str], str] = {
    ("socket", "socket"): "socket",
    ("socket", "create_connection"): "socket",
    ("tempfile", "mkdtemp"): "tempdir",
    ("tempfile", "TemporaryDirectory"): "tempdir",
    ("tempfile", "NamedTemporaryFile"): "tempfile",
}
_RESOURCE_BARE: Dict[str, str] = {"open": "file"}

# verbs that end a resource's life, for the leak rule's close scan
_CLOSE_VERBS = {"close", "cleanup", "rmtree", "unlink", "remove",
                "shutdown", "terminate"}


def _call_name(node: ast.Call) -> Tuple[Optional[str], str]:
    """(dotted qualifier, attr/function name) of a call target — the
    same shape concurrency.py uses, so the two passes resolve calls
    identically."""
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
    from fastconsensus_tpu_torch.analysis import _module_name as shared

    return shared(path)


def _repo_path(path: str) -> str:
    """``path`` relative to the directory that holds the package (the
    checkout's root) when it lies below it, so an inventory does not
    depend on where the checkout is; other paths as given."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    full = os.path.abspath(path)
    if full.startswith(root + os.sep):
        return os.path.relpath(full, root).replace(os.sep, "/")
    return path


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — display-only fallback
        return "<expr>"


def _handler_types(h: ast.ExceptHandler) -> Tuple[str, ...]:
    """Terminal type names an except clause catches; ``*`` = bare
    except (or an unresolvable type expression, same effect)."""
    def term(e: ast.AST) -> str:
        if isinstance(e, ast.Name):
            return e.id
        if isinstance(e, ast.Attribute):
            return e.attr
        return "*"

    if h.type is None:
        return ("*",)
    if isinstance(h.type, ast.Tuple):
        return tuple(term(el) for el in h.type.elts) or ("*",)
    return (term(h.type),)


class _ExceptInfo:
    """One except clause: what it catches, whether its body has an
    outlet, where it is."""

    def __init__(self, types: Tuple[str, ...], node: ast.ExceptHandler,
                 filename: str) -> None:
        self.types = types
        self.node = node
        self.filename = filename
        self.has_outlet = _body_has_outlet(node.body)


def _body_has_outlet(body: List[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Return)):
                return True
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign, ast.NamedExpr)):
                return True
            if isinstance(node, ast.Call):
                _, name = _call_name(node)
                if name.lstrip("_").lower() in _OUTLET_CALL_NAMES or \
                        name.lstrip("_").lower().startswith("send"):
                    return True
    return False


class _FnFault:
    """Per-function fault summary (one pass over the body)."""

    def __init__(self, module: str, cls: Optional[str], name: str,
                 node: ast.FunctionDef, filename: str) -> None:
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.filename = filename
        self.ref = f"{module}.{cls}.{name}" if cls else f"{module}.{name}"
        self.qualname = f"{cls}.{name}" if cls else name
        # explicit raise sites: (exc type name, line, coverage stack)
        self.raises: List[Tuple[str, int,
                                Tuple[FrozenSet[str], ...]]] = []
        # every call: (qual, name, line, coverage stack)
        self.calls: List[Tuple[Optional[str], str, int,
                               Tuple[FrozenSet[str], ...]]] = []
        self.handlers: List[_ExceptInfo] = []
        self.thread_targets: List[str] = []    # Thread(target=...) refs
        # Thread(...) constructions: (line, daemon given, binding)
        self.thread_news: List[Tuple[int, bool, Optional[str]]] = []
        # resource factory calls: (kind, line, call id, binding)
        self.resources: List[Tuple[str, int, int, Optional[str]]] = []
        # .acquire() sites: (receiver text, line)
        self.acquires: List[Tuple[str, int]] = []
        # lifecycle verbs seen: (verb, target text, inside a finally)
        self.closes: List[Tuple[str, str, bool]] = []
        self.daemon_sets: Set[str] = set()     # ``x.daemon = True``
        self.returned: Set[str] = set()        # names returned
        self.with_ctx_ids: Set[int] = set()    # Call nodes used as ctx
        self.with_names: Set[str] = set()      # ``with f:`` names
        self.chained_close_ids: Set[int] = set()
        self.is_ctx_helper = any(
            isinstance(d, (ast.Name, ast.Attribute)) and
            _unparse(d).rsplit(".", 1)[-1] in ("contextmanager",
                                               "asynccontextmanager")
            for d in node.decorator_list)


class _ModFault:
    def __init__(self, module: str, filename: str, source: str) -> None:
        self.module = module
        self.filename = filename
        self.source = source
        self.functions: Dict[str, _FnFault] = {}
        self.classes: Dict[str, Dict[str, _FnFault]] = {}
        self.alias_modules: Dict[str, str] = {}
        self.from_imports: Dict[str, Tuple[str, str]] = {}


class FaultAnalyzer:
    """Whole-program exception-flow pass over a ``{filename: source}``
    set."""

    def __init__(self, sources: Dict[str, str]) -> None:
        self.sources = sources
        self.modules: Dict[str, _ModFault] = {}
        self.diags: List[Diagnostic] = []
        # merged hierarchy: builtin tree + scanned class definitions
        self.exc_parents: Dict[str, str] = dict(_EXC_PARENTS)
        self.esc: Dict[str, Set[str]] = {}

    # ---------------- collection ----------------

    def collect(self) -> None:
        for filename, source in self.sources.items():
            try:
                tree = ast.parse(source, filename=filename)
            # fcheck: ok=swallowed-error (astlint reports the syntax
            # error itself; this pass just skips the unparsable file)
            except SyntaxError:
                continue  # astlint reports the syntax error itself
            mod = _ModFault(_module_name(filename), filename, source)
            self._collect_imports(tree, mod)
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fn = _FnFault(mod.module, None, node.name, node,
                                  filename)
                    self._summarize(fn, mod)
                    mod.functions[node.name] = fn
                elif isinstance(node, ast.ClassDef):
                    self._collect_class_exc(node)
                    methods: Dict[str, _FnFault] = {}
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            fn = _FnFault(mod.module, node.name,
                                          sub.name, sub, filename)
                            self._summarize(fn, mod)
                            methods[sub.name] = fn
                    mod.classes[node.name] = methods
            self.modules[mod.module] = mod

    @staticmethod
    def _collect_imports(tree: ast.Module, mod: _ModFault) -> None:
        for stmt in tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.asname:
                        mod.alias_modules[a.asname] = a.name
                    else:
                        mod.alias_modules.setdefault(a.name, a.name)
            elif isinstance(stmt, ast.ImportFrom) and stmt.level == 0 \
                    and stmt.module:
                for a in stmt.names:
                    alias = a.asname or a.name
                    mod.alias_modules.setdefault(
                        alias, f"{stmt.module}.{a.name}")
                    mod.from_imports[alias] = (stmt.module, a.name)

    def _collect_class_exc(self, node: ast.ClassDef) -> None:
        """Project exception hierarchy: every scanned class whose base
        chain might be an exception contributes child -> first base.
        Harmless for non-exception classes (only consulted on names
        that appear in raise/except position)."""
        for base in node.bases:
            if isinstance(base, ast.Name):
                self.exc_parents.setdefault(node.name, base.id)
                break
            if isinstance(base, ast.Attribute):
                self.exc_parents.setdefault(node.name, base.attr)
                break

    # ---------------- per-function summary ----------------

    def _summarize(self, fn: _FnFault, mod: _ModFault) -> None:
        self._walk(list(fn.node.body), fn, mod, coverage=(),
                   handler_types=(), handler_name=None,
                   in_finally=False)

    def _walk(self, stmts: List[ast.stmt], fn: _FnFault,
              mod: _ModFault, coverage: Tuple[FrozenSet[str], ...],
              handler_types: Tuple[str, ...],
              handler_name: Optional[str], in_finally: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs run on their own schedule
            if isinstance(stmt, ast.Try):
                group = frozenset(
                    t for h in stmt.handlers for t in _handler_types(h))
                self._walk(stmt.body, fn, mod,
                           coverage + ((group,) if group else ()),
                           handler_types, handler_name, in_finally)
                for h in stmt.handlers:
                    htypes = _handler_types(h)
                    fn.handlers.append(
                        _ExceptInfo(htypes, h, fn.filename))
                    # the handler's own body is NOT covered by its try
                    self._walk(h.body, fn, mod, coverage, htypes,
                               h.name, in_finally)
                self._walk(stmt.orelse, fn, mod, coverage,
                           handler_types, handler_name, in_finally)
                self._walk(stmt.finalbody, fn, mod, coverage,
                           handler_types, handler_name, True)
                continue
            if isinstance(stmt, ast.Raise):
                for expr in (stmt.exc, stmt.cause):
                    if expr is not None:
                        self._scan_expr(expr, fn, mod, coverage,
                                        in_finally)
                for exc in self._raise_types(stmt, handler_types,
                                             handler_name):
                    fn.raises.append((exc, stmt.lineno, coverage))
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Call):
                        fn.with_ctx_ids.add(id(ce))
                        # ``closing(open(...))``-style wrappers manage
                        # their direct call arguments too
                        for a in ce.args:
                            if isinstance(a, ast.Call):
                                fn.with_ctx_ids.add(id(a))
                    elif isinstance(ce, ast.Name):
                        fn.with_names.add(ce.id)
                    self._scan_expr(ce, fn, mod, coverage, in_finally)
                self._walk(stmt.body, fn, mod, coverage, handler_types,
                           handler_name, in_finally)
                continue
            if isinstance(stmt, ast.Return):
                if isinstance(stmt.value, ast.Name):
                    fn.returned.add(stmt.value.id)
                elif isinstance(stmt.value, ast.Call):
                    fn.returned.add(f"<call:{id(stmt.value)}>")
                if stmt.value is not None:
                    self._scan_expr(stmt.value, fn, mod, coverage,
                                    in_finally)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                self._note_binding(stmt.value, targets, fn)
                for t in targets:
                    # ``x.daemon = True`` keeps a non-daemon Thread
                    # from blocking interpreter exit
                    if isinstance(t, ast.Attribute) and \
                            t.attr == "daemon":
                        fn.daemon_sets.add(_unparse(t.value))
                    self._scan_expr(t, fn, mod, coverage, in_finally)
                if stmt.value is not None:
                    self._scan_expr(stmt.value, fn, mod, coverage,
                                    in_finally)
                continue
            # generic statement: scan its expression fields, recurse
            # into its statement-list fields
            for _field, value in ast.iter_fields(stmt):
                if isinstance(value, ast.expr):
                    self._scan_expr(value, fn, mod, coverage,
                                    in_finally)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.stmt):
                            self._walk([v], fn, mod, coverage,
                                       handler_types, handler_name,
                                       in_finally)
                        elif isinstance(v, ast.expr):
                            self._scan_expr(v, fn, mod, coverage,
                                            in_finally)
                        elif hasattr(ast, "match_case") and \
                                isinstance(v, ast.match_case):
                            self._walk(v.body, fn, mod, coverage,
                                       handler_types, handler_name,
                                       in_finally)

    def _note_binding(self, value: Optional[ast.AST],
                      targets: List[ast.AST], fn: _FnFault) -> None:
        """Remember which name/attr a resource or Thread call binds to
        so the leak rule can look for its close/join later."""
        if not isinstance(value, ast.Call) or len(targets) != 1:
            return
        t = targets[0]
        binding: Optional[str] = None
        if isinstance(t, ast.Name):
            binding = t.id
        elif isinstance(t, ast.Attribute):
            binding = _unparse(t)
        if binding is not None:
            self._pending_binding = (id(value), binding)

    def _raise_types(self, stmt: ast.Raise,
                     handler_types: Tuple[str, ...],
                     handler_name: Optional[str]) -> List[str]:
        if stmt.exc is None:
            # bare ``raise``: re-throws whatever the enclosing handler
            # caught (``*`` from a bare except re-throws anything)
            return [t if t != "*" else "Exception"
                    for t in handler_types] or ["Exception"]
        node = stmt.exc
        if isinstance(node, ast.Call):
            node = node.func
        if isinstance(node, ast.Attribute):
            return [node.attr]
        if isinstance(node, ast.Name):
            if handler_name is not None and node.id == handler_name:
                return [t if t != "*" else "Exception"
                        for t in handler_types]
            if node.id[:1].isupper():
                return [node.id]
            return ["Exception"]  # some variable: type unknown
        return ["Exception"]

    def _scan_expr(self, expr: ast.AST, fn: _FnFault, mod: _ModFault,
                   coverage: Tuple[FrozenSet[str], ...],
                   in_finally: bool) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            qual, name = _call_name(node)
            fn.calls.append((qual, name, node.lineno, coverage))
            if name == "Thread":
                daemon = any(kw.arg == "daemon"
                             for kw in node.keywords)
                binding = None
                pend = getattr(self, "_pending_binding", None)
                if pend is not None and pend[0] == id(node):
                    binding = pend[1]
                fn.thread_news.append((node.lineno, daemon, binding))
                for kw in node.keywords:
                    if kw.arg == "target":
                        ref = self._target_ref(kw.value, fn, mod)
                        if ref is not None:
                            fn.thread_targets.append(ref)
            kind = self._resource_kind(qual, name, mod)
            if kind is not None:
                binding = None
                pend = getattr(self, "_pending_binding", None)
                if pend is not None and pend[0] == id(node):
                    binding = pend[1]
                fn.resources.append((kind, node.lineno, id(node),
                                     binding))
            if name == "acquire" and isinstance(node.func,
                                                ast.Attribute):
                fn.acquires.append((_unparse(node.func.value),
                                    node.lineno))
            if name in _CLOSE_VERBS or name == "release" or \
                    name == "join":
                target = None
                if isinstance(node.func, ast.Attribute):
                    target = _unparse(node.func.value)
                    if isinstance(node.func.value, ast.Call):
                        # ``open(...).close()``: closed on the spot,
                        # no exception path between open and close
                        fn.chained_close_ids.add(id(node.func.value))
                elif node.args:
                    # ``rmtree(path)`` / ``os.remove(path)`` style
                    target = _unparse(node.args[0])
                if target is not None:
                    fn.closes.append((name, target, in_finally))

    def _target_ref(self, expr: ast.AST, fn: _FnFault,
                    mod: _ModFault) -> Optional[str]:
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

    def _resource_kind(self, qual: Optional[str], name: str,
                       mod: _ModFault) -> Optional[str]:
        if qual is None:
            hit = _RESOURCE_BARE.get(name)
            if hit is not None:
                return hit
            tgt = mod.from_imports.get(name)
            if tgt is not None:
                return _RESOURCE_QUALIFIED.get((tgt[0], tgt[1]))
            return None
        base = mod.alias_modules.get(qual, qual)
        for (m, n), kind in _RESOURCE_QUALIFIED.items():
            if name == n and (base == m or base.startswith(m + ".") or
                              base.endswith("." + m)):
                return kind
        return None

    def _raiser_types(self, qual: Optional[str], name: str,
                      mod: _ModFault) -> Tuple[str, ...]:
        if qual is None:
            hit = _RAISERS_BARE.get(name)
            if hit is not None:
                return hit
            tgt = mod.from_imports.get(name)
            if tgt is not None:
                for (m, n), types in _RAISERS_QUALIFIED.items():
                    if n == tgt[1] and (tgt[0] == m or
                                        tgt[0].startswith(m + ".")):
                        return types
            return ()
        base = mod.alias_modules.get(qual, qual)
        for (m, n), types in _RAISERS_QUALIFIED.items():
            if name == n and (base == m or base.startswith(m + ".") or
                              base.endswith("." + m)):
                return types
        return ()

    # ---------------- hierarchy / coverage ----------------

    def _catches(self, group: FrozenSet[str], exc: str) -> bool:
        """Does any type in a handler group catch ``exc``?  Unknown
        types are assumed direct Exception subclasses."""
        if "*" in group or "BaseException" in group:
            return True
        seen: Set[str] = set()
        cur: Optional[str] = exc
        while cur is not None and cur not in seen:
            if cur in group:
                return True
            seen.add(cur)
            if cur in ("Exception", "BaseException"):
                cur = self.exc_parents.get(cur)
            else:
                cur = self.exc_parents.get(cur, "Exception")
        return False

    def _covered(self, coverage: Tuple[FrozenSet[str], ...],
                 exc: str) -> bool:
        return any(self._catches(g, exc) for g in coverage)

    # ---------------- cross-function resolution ----------------

    def _all_fns(self):
        for mod in self.modules.values():
            yield from mod.functions.values()
            for methods in mod.classes.values():
                yield from methods.values()

    def _build_tables(self) -> None:
        self.by_ref: Dict[str, _FnFault] = {}
        self.by_method: Dict[str, List[_FnFault]] = {}
        for fn in self._all_fns():
            self.by_ref[fn.ref] = fn
            self.by_method.setdefault(fn.name, []).append(fn)

    def _resolve(self, caller: _FnFault, qual: Optional[str],
                 name: str) -> List[_FnFault]:
        """Callees a call may reach — the concurrency pass's
        resolution, verbatim: local def, from-import, self method,
        alias/direct module, then the type-blind class-name
        containment fallback."""
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
            own = self.by_ref.get(
                f"{caller.module}.{caller.cls}.{name}")
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

    # ---------------- escape fixpoint ----------------

    def _escape_sets(self) -> Dict[str, Set[str]]:
        """escape(fn) = locally uncaught raises | per-call-site
        (escape(callee) | builtin raisers) minus that site's handler
        coverage, to fixpoint."""
        esc: Dict[str, Set[str]] = {}
        for fn in self._all_fns():
            s: Set[str] = set()
            for exc, _line, cov in fn.raises:
                if not self._covered(cov, exc):
                    s.add(exc)
            esc[fn.ref] = s
        changed = True
        while changed:
            changed = False
            for fn in self._all_fns():
                mod = self.modules[fn.module]
                cur = esc[fn.ref]
                for qual, name, _line, cov in fn.calls:
                    incoming: Set[str] = set(
                        self._raiser_types(qual, name, mod))
                    for callee in self._resolve(fn, qual, name):
                        incoming.update(esc[callee.ref])
                    for exc in incoming:
                        if exc not in cur and \
                                not self._covered(cov, exc):
                            cur.add(exc)
                            changed = True
        return esc

    def _worker_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for fn in self._all_fns():
            roots.update(fn.thread_targets)
        return roots

    # ---------------- rules ----------------

    def run(self) -> List[Diagnostic]:
        self.collect()
        self._build_tables()
        self.esc = self._escape_sets()
        self._rule_escape_thread_root()
        self._rule_unmapped_http()
        self._rule_swallowed()
        self._rule_resource_leak()
        return self.diags

    def _escapes_of(self, fn: _FnFault) -> List[str]:
        return sorted(e for e in self.esc.get(fn.ref, ())
                      if e not in _ESCAPE_IGNORED)

    # -- rule 1: escape-thread-root -----------------------------------

    def _rule_escape_thread_root(self) -> None:
        roots = self._worker_roots()
        for fn in self._all_fns():
            if fn.ref not in roots:
                continue
            for exc in self._escapes_of(fn):
                self.diags.append(Diagnostic(
                    rule="escape-thread-root",
                    message=f"{exc} can escape thread root "
                            f"{fn.qualname}() — Thread.run prints a "
                            "traceback and the thread dies with no "
                            "cordon, no counter, no flight event; "
                            "absorb it into the death machinery "
                            "(except Exception -> die/cordon + "
                            "counter) or pragma with why silent death "
                            "is acceptable",
                    file=fn.filename, line=fn.node.lineno,
                    col=fn.node.col_offset))

    # -- rule 2: unmapped-http-error ----------------------------------

    def _rule_unmapped_http(self) -> None:
        for fn in self._all_fns():
            if fn.cls is None or fn.name not in _HTTP_HANDLER_NAMES:
                continue
            for exc in self._escapes_of(fn):
                self.diags.append(Diagnostic(
                    rule="unmapped-http-error",
                    message=f"{exc} can escape HTTP handler "
                            f"{fn.qualname}() with no status-code "
                            "mapping — the client sees a dropped "
                            "connection or a raw-traceback 500 "
                            "instead of the promised JSON error body; "
                            "add an except arm mapping it to a "
                            "4xx/5xx response or pragma with why it "
                            "cannot fire",
                    file=fn.filename, line=fn.node.lineno,
                    col=fn.node.col_offset))

    # -- rule 3: swallowed-error --------------------------------------

    def _rule_swallowed(self) -> None:
        for fn in self._all_fns():
            for h in fn.handlers:
                if h.has_outlet:
                    continue
                types = ", ".join(h.types)
                self.diags.append(Diagnostic(
                    rule="swallowed-error",
                    message=f"except ({types}) in {fn.qualname}() "
                            "absorbs the error with no outlet: no "
                            "re-raise, no return, no error-value "
                            "assignment, no fcobs counter, no flight "
                            "event — the failure is invisible to "
                            "/metricsz and the flight recorder; stamp "
                            "a counter, record the event, or pragma "
                            "with why silence is correct",
                    file=h.filename, line=h.node.lineno,
                    col=h.node.col_offset))

    # -- rule 4: resource-leak ----------------------------------------

    def _class_lifecycle(self, mod: _ModFault, cls: str
                         ) -> Tuple[Set[str], Set[str]]:
        """(targets closed/joined by any method, targets daemon-set by
        any method) across a class — object-lifetime resources are
        compliant when ANY method ends them."""
        closed: Set[str] = set()
        daemon: Set[str] = set()
        for m in mod.classes.get(cls, {}).values():
            for _verb, target, _fin in m.closes:
                closed.add(target)
            daemon.update(m.daemon_sets)
        return closed, daemon

    def _rule_resource_leak(self) -> None:
        for fn in self._all_fns():
            if fn.is_ctx_helper:
                continue  # @contextmanager: cleanup lives past yield
            mod = self.modules[fn.module]
            cls_closed: Set[str] = set()
            cls_daemon: Set[str] = set()
            if fn.cls is not None:
                cls_closed, cls_daemon = self._class_lifecycle(
                    mod, fn.cls)
            # (a) threads without join-or-daemon
            for line, daemon, binding in fn.thread_news:
                if daemon:
                    continue
                ok = False
                if binding is not None:
                    if binding.startswith("self."):
                        ok = binding in cls_closed or \
                            binding in cls_daemon
                    else:
                        ok = binding in fn.daemon_sets or any(
                            verb == "join" and target == binding
                            for verb, target, _fin in fn.closes)
                if not ok:
                    what = f"bound to {binding}" if binding else \
                        "never bound"
                    self.diags.append(Diagnostic(
                        rule="resource-leak",
                        message="Thread created without daemon= and "
                                f"never joined ({what}): a non-daemon "
                                "thread blocks interpreter exit and "
                                "outlives SIGTERM drain — pass "
                                "daemon=True, join it, or pragma "
                                "with who owns its shutdown",
                        file=fn.filename, line=line))
            # (b) acquire() without release() in a finally
            for recv, line in fn.acquires:
                ok = any(verb == "release" and target == recv and fin
                         for verb, target, fin in fn.closes)
                if not ok:
                    self.diags.append(Diagnostic(
                        rule="resource-leak",
                        message=f"{recv}.acquire() with no "
                                f"{recv}.release() in a finally: an "
                                "exception between acquire and "
                                "release leaves the lock held forever "
                                "— use 'with', add try/finally, or "
                                "pragma with where the release lives",
                        file=fn.filename, line=line))
            # (c) files/sockets/tempdirs opened outside with
            for kind, line, call_id, binding in fn.resources:
                if call_id in fn.with_ctx_ids or \
                        call_id in fn.chained_close_ids or \
                        f"<call:{call_id}>" in fn.returned:
                    continue
                ok = False
                if binding is not None:
                    if binding in fn.returned or \
                            binding in fn.with_names:
                        ok = True  # ownership transferred / with-bound
                    elif binding.startswith("self."):
                        ok = binding in cls_closed
                    else:
                        ok = any(target == binding and fin
                                 for _verb, target, fin in fn.closes)
                if not ok:
                    what = f"bound to {binding}" if binding else \
                        "never bound"
                    self.diags.append(Diagnostic(
                        rule="resource-leak",
                        message=f"{kind} opened outside 'with' "
                                f"({what}) and not closed in a "
                                "finally: an exception on the path "
                                "between open and close leaks the "
                                f"{kind} — use 'with', add "
                                "try/finally, or pragma with who "
                                "closes it",
                        file=fn.filename, line=line))

    # ---------------- injection-site inventory ----------------

    def build_inventory(self, module_prefix: str =
                        "fastconsensus_tpu_torch.serve") -> dict:
        """The committed injection-site inventory (analysis/
        fault_inventory.json): every raise site in ``serve/`` (explicit
        raise or curated builtin raiser) + the boundary this pass claims
        absorbs it.  ``injectable`` marks sites serve/faultinject.py
        can model faithfully: the exception leaves the raising
        function and every absorber is a real caller-side handler
        (entry injection raises before the function's own try blocks
        run, so self-absorbed sites cannot be exercised that way).

        The port adds one kind to the reference's ``raise`` and
        ``builtin-call``: ``escape``, a ``serve/`` function an exception
        leaves without being raised there (a callee raised it, at the
        listed call lines), listed only when injectable.  Entry
        injection there throws what the function really lets through,
        from its callers' point of view: ``ResultCache.spill`` is the
        drain-time spill, whose OSError comes from
        ``ResultCache._spill_locked``, shared with the periodic spill."""
        if not self.esc:
            self.run()
        roots = self._worker_roots()
        # reverse call table: callee ref -> [(caller, site coverage)]
        rev: Dict[str, List[Tuple[_FnFault,
                                  Tuple[FrozenSet[str], ...]]]] = {}
        for fn in self._all_fns():
            for qual, name, _line, cov in fn.calls:
                for callee in self._resolve(fn, qual, name):
                    rev.setdefault(callee.ref, []).append((fn, cov))
        rows: Dict[Tuple[str, str], dict] = {}
        for fn in self._all_fns():
            if not fn.module.startswith(module_prefix) or \
                    fn.module.endswith(".faultinject"):
                continue
            mod = self.modules[fn.module]
            sites: List[Tuple[str, int, Tuple[FrozenSet[str], ...],
                              str]] = []
            for exc, line, cov in fn.raises:
                sites.append((exc, line, cov, "raise"))
            for qual, name, line, cov in fn.calls:
                for exc in self._raiser_types(qual, name, mod):
                    sites.append((exc, line, cov, "builtin-call"))
            for exc, line, cov, kind in sites:
                if exc in _ESCAPE_IGNORED or exc == "Exception":
                    continue
                key = (fn.ref, exc)
                row = rows.get(key)
                if row is None:
                    boundary, injectable = self._boundary(
                        fn, exc, cov, rev, roots)
                    row = {
                        "site_id": f"{fn.module}:{fn.qualname}:{exc}",
                        "file": _repo_path(fn.filename),
                        "function": fn.qualname,
                        "exception": exc,
                        "kind": kind,
                        "lines": [],
                        "boundary": boundary,
                        "injectable": injectable,
                    }
                    rows[key] = row
                if line not in row["lines"]:
                    row["lines"].append(line)
                if kind == "raise":
                    row["kind"] = "raise"
            through: Dict[str, List[int]] = {}
            for qual, name, line, cov in fn.calls:
                for callee in self._resolve(fn, qual, name):
                    for exc in self.esc.get(callee.ref, ()):
                        if exc not in _ESCAPE_IGNORED and \
                                exc != "Exception" and \
                                (fn.ref, exc) not in rows and \
                                not self._covered(cov, exc):
                            through.setdefault(exc, []).append(line)
            for exc, lines in through.items():
                boundary, injectable = self._boundary(fn, exc, (), rev,
                                                      roots)
                if injectable:
                    rows[(fn.ref, exc)] = {
                        "site_id": f"{fn.module}:{fn.qualname}:{exc}",
                        "file": _repo_path(fn.filename),
                        "function": fn.qualname,
                        "exception": exc,
                        "kind": "escape",
                        "lines": sorted(set(lines)),
                        "boundary": boundary,
                        "injectable": True,
                    }
        for row in rows.values():
            row["lines"].sort()
        return {
            "tool": "fcheck-fault",
            "version": 1,
            "module_prefix": module_prefix,
            "sites": sorted(rows.values(),
                            key=lambda r: r["site_id"]),
        }

    def _boundary(self, fn: _FnFault, exc: str,
                  cov: Tuple[FrozenSet[str], ...],
                  rev: Dict[str, List[Tuple[_FnFault,
                                            Tuple[FrozenSet[str],
                                                  ...]]]],
                  roots: Set[str]) -> Tuple[List[str], bool]:
        """Who absorbs ``exc`` raised at a site in ``fn`` — BFS up the
        reverse call table from the raising function, stopping at the
        first covering handler per path; sentinels mark paths nobody
        absorbs ('<thread-root:ref>' / '<external>')."""
        if self._covered(cov, exc):
            return [fn.ref], False
        absorbers: Set[str] = set()
        visited: Set[str] = {fn.ref}
        frontier: List[str] = [fn.ref]
        while frontier:
            nxt: List[str] = []
            for ref in frontier:
                callers = rev.get(ref, [])
                if not callers:
                    if ref in roots:
                        absorbers.add(f"<thread-root:{ref}>")
                    else:
                        absorbers.add(EXTERNAL_BOUNDARY)
                    continue
                escaped_any = False
                for caller, site_cov in callers:
                    if self._covered(site_cov, exc):
                        absorbers.add(caller.ref)
                    elif caller.ref not in visited:
                        visited.add(caller.ref)
                        nxt.append(caller.ref)
                        escaped_any = True
                if ref in roots and escaped_any:
                    # an uncaught path ends at this thread root even
                    # though other callers absorb it
                    absorbers.add(f"<thread-root:{ref}>")
            frontier = nxt
        boundary = sorted(absorbers)
        injectable = bool(boundary) and \
            all(not b.startswith("<") for b in boundary)
        return boundary, injectable


def check_faults(sources: Dict[str, str]
                 ) -> Tuple[List[Diagnostic], int]:
    """Run the whole-program fault pass over ``{filename: source}``;
    returns (diagnostics, n_suppressed), pragmas already applied per
    file."""
    analyzer = FaultAnalyzer(sources)
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


def build_fault_inventory(sources: Dict[str, str]) -> dict:
    """The injection-site inventory over a source set (see
    FaultAnalyzer.build_inventory)."""
    analyzer = FaultAnalyzer(sources)
    analyzer.run()
    return analyzer.build_inventory()


def fault_inventory_from_paths(paths: List[str]) -> dict:
    """Load every ``.py`` under ``paths`` the way lint_paths does and
    build the injection-site inventory: the ``--emit-fault-inventory``
    entry point (the committed ``analysis/fault_inventory.json`` is its
    output over the package)."""
    from fastconsensus_tpu_torch.analysis import read_sources

    return build_fault_inventory(read_sources(paths))

"""Layer 1 of the port's fcheck: the AST lint rules that apply to eager
PyTorch.

The port's own copy of the reference's ``analysis/astlint.py``, cut to
the four rules whose hazard survives in eager PyTorch on the card:

``key-reuse``
    The same PRNG key consumed by two draws on one execution path (or by
    a draw inside a Python loop with the key derived outside it).  The
    port keeps the reference's stateless threefry keys
    (``utils/prng.py``): ``prng.split``, ``fold_in``, ``stream``,
    ``partition_keys``, ``key``, ``wrap_key_data`` and ``key_data``
    derive, and ``prng.bits``, ``uniform``, ``bernoulli`` and
    ``randint`` draw.  Reuse silently correlates draws.

    The rule is **cross-function**: passing a key to a helper counts by
    what the helper actually does with it.  A per-function summary
    (:func:`summarize_key_params`) classifies every key-ish parameter as
    a pure *deriver* (weight 0: only split/fold_in-style derivations,
    safe to call repeatedly), a single *draw* (weight 1, e.g.
    ``segment.pair_jitter``, which salts one ``prng.bits`` from its
    key), or an internal *re-user* (weight 2).  Summaries resolve
    through module-local defs and import aliases (``from
    fastconsensus_tpu_torch.ops import segment as seg`` ->
    ``seg.pair_jitter``); ``lint_paths`` builds the table over the whole
    scanned file set first, so the weights cross module boundaries.
    Unknown callees keep the conservative weight of 1.

``sync-in-loop``
    A host sync inside a Python loop: the readbacks ``.item()``,
    ``.tolist()``, ``.cpu()`` and ``.numpy()``, ``torch.cuda.
    synchronize()``, and ``np.array`` / ``np.asarray`` (of a tensor,
    which copies it to the host; the rule cannot see types, so it flags
    every such call).  Each waits for the card's queue to drain, so a
    loop of them serializes the host and the device.  Deliberate
    once-per-round readbacks carry a ``# fcheck: ok=sync-in-loop``
    pragma with the reason.

``f64-dtype``
    float64 in tensor code: ``torch.float64`` / ``torch.double`` as a
    ``dtype=`` or a ``.to()`` / ``.type()`` target, and ``.double()``.
    On the H100 a float64 tensor moves twice the bytes of float32 and
    its arithmetic runs at half the fp32 rate, so float64 belongs only
    where it buys exactness (integer-weight sums that must not depend on
    summation order); such uses carry a pragma saying what exactness
    they buy.  Host-side ``np.float64`` is fine and not flagged.

``syntax-error``
    A file that does not parse.

The reference's jit-only rules (``traced-branch``, ``retrace-risk``,
``weak-static-arg``, ``kernel-tracer-closure``, ``module-jnp-const``,
``mesh-axis``) guard hazards of tracing and of Pallas that eager
PyTorch does not have, and are not ported.

All rules support ``# fcheck: ok=<rule>`` suppression pragmas
(diagnostics.parse_pragmas).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                          apply_pragmas)

# utils/prng.py functions that *derive* keys (safe to call repeatedly on
# one key with different data); every other call a key is passed to
# (the draws ``bits``/``uniform``/``bernoulli``/``randint`` among them)
# consumes it, unless its summary says otherwise.
_KEY_DERIVERS = {
    "split", "fold_in", "stream", "partition_keys", "key",
    "wrap_key_data", "key_data",
}
# The stable rule-id universe this linter can emit (CLI --only
# validation; concurrency.CONCURRENCY_RULES and faults.FAULT_RULES are
# the other source families).
ASTLINT_RULES = ("key-reuse", "f64-dtype", "sync-in-loop", "syntax-error")
# Readbacks that wait for the card, by method name on any receiver.
_SYNC_CALLS_ATTR = {"item", "tolist", "cpu", "numpy"}
_F64_NAMES = {"float64", "double"}


def _call_name(node: ast.Call) -> Tuple[Optional[str], str]:
    """(module-ish qualifier, attr/function name) of a call target."""
    f = node.func
    if isinstance(f, ast.Name):
        return None, f.id
    if isinstance(f, ast.Attribute):
        qual = None
        v = f.value
        parts = []
        while isinstance(v, ast.Attribute):
            parts.append(v.attr)
            v = v.value
        if isinstance(v, ast.Name):
            parts.append(v.id)
            qual = ".".join(reversed(parts))
        return qual, f.attr
    return None, ""


def _is_random_qual(qual: Optional[str]) -> bool:
    return qual is not None and (qual.endswith("random") or qual == "prng")


def _is_key_deriver(qual: Optional[str], name: str) -> bool:
    """A call that re-derives keys rather than consuming one.

    The qualifier must look PRNG-ish: ``line.split()`` (str.split) and
    other name collisions must not count as key derivations.
    """
    return name in _KEY_DERIVERS and _is_random_qual(qual)


class _KeyState:
    """Per-path PRNG-key consumption counts, alias-aware.

    ``depth`` records the loop depth a key was derived at: consuming a
    key inside a loop it was derived OUTSIDE of counts double (the
    consumption repeats per iteration with the same key), while a key
    derived fresh each iteration is fine.
    """

    def __init__(self) -> None:
        self.alias: Dict[str, str] = {}   # name -> canonical key name
        self.count: Dict[str, int] = {}   # canonical -> consumptions
        self.depth: Dict[str, int] = {}   # canonical -> derivation depth
        self.site: Dict[str, Tuple[int, int]] = {}  # first consumption

    def canon(self, name: str) -> Optional[str]:
        return self.alias.get(name)

    def fresh(self, name: str, depth: int = 0) -> None:
        self.alias[name] = name
        self.count[name] = 0
        self.depth[name] = depth

    def drop(self, name: str) -> None:
        self.alias.pop(name, None)

    def copy(self) -> "_KeyState":
        s = _KeyState()
        s.alias = dict(self.alias)
        s.count = dict(self.count)
        s.depth = dict(self.depth)
        s.site = dict(self.site)
        return s

    def merge_max(self, *others: "_KeyState") -> None:
        for o in others:
            for k, v in o.count.items():
                if v > self.count.get(k, 0):
                    self.count[k] = v
                    if k in o.site:
                        self.site[k] = o.site[k]
            self.alias.update(o.alias)
            self.depth.update(o.depth)


def _key_param_names(fn: ast.FunctionDef) -> List[str]:
    """The parameters of ``fn`` the key-reuse rule tracks as PRNG keys
    (name-based, same heuristic as the intra-function seeding)."""
    out = []
    for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs):
        n = a.arg
        if n == "key" or n == "rng" or n.endswith("_key") or \
                n == "keys" or n.endswith("_keys"):
            out.append(n)
    return out


class Linter:
    def __init__(self, source: str, filename: str = "<memory>",
                 key_summaries: Optional[Dict[str, Dict[str, dict]]] = None
                 ) -> None:
        self.source = source
        self.filename = filename
        self.diags: List[Diagnostic] = []
        self.n_suppressed = 0
        # cross-function key flow (module docstring, `key-reuse`):
        # {module: {function: summary}} built by lint_paths over the
        # whole scanned set; local defs and import aliases resolve into
        # it at call sites.
        self._key_summaries = key_summaries or {}
        self._local_summaries: Dict[str, dict] = {}
        self._alias_modules: Dict[str, str] = {}
        self._from_imports: Dict[str, Tuple[str, str]] = {}
        self._summary_peaks: Optional[Dict[str, int]] = None

    def run(self) -> List[Diagnostic]:
        try:
            tree = ast.parse(self.source, filename=self.filename)
        except SyntaxError as e:
            self.diags.append(Diagnostic(
                rule="syntax-error", message=str(e.msg),
                file=self.filename, line=e.lineno or 0, col=e.offset or 0))
            return self.diags
        self._collect_imports(tree)
        self._summarize_tree(tree)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_key_reuse(node)
                self._check_sync_in_loop(node)
            if isinstance(node, ast.Call):
                self._check_f64(node)
        self.diags, self.n_suppressed = apply_pragmas(self.diags,
                                                      self.source)
        return self.diags

    # ---------------- cross-function key summaries ----------------

    def _package_parts(self) -> List[str]:
        """Dotted-path components of the package containing this file's
        module (the relative-import anchor): everything from the
        ``fastconsensus_tpu_torch`` root down to the directory, which is
        the level-1 base for regular modules and ``__init__`` alike.
        Empty outside the tree: bare-stem modules (fixtures, scripts)
        cannot anchor relative imports."""
        parts = os.path.normpath(
            os.path.abspath(self.filename)).split(os.sep)
        if "fastconsensus_tpu_torch" not in parts[:-1]:
            return []
        return parts[parts.index("fastconsensus_tpu_torch"):-1]

    def _collect_imports(self, tree: ast.Module) -> None:
        """Alias -> module map for resolving helper calls into the
        cross-module summary table (``import a.b.c as x`` and
        ``from a.b import c [as x]`` both bind x to a module; ``from
        a.b.c import fn`` binds a function — tracked separately).
        Relative imports (``from ..ops import segment as seg``) resolve
        against this file's own package path; outside the package tree
        they stay unresolved (conservative weight 1)."""
        for stmt in tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.asname:
                        self._alias_modules[a.asname] = a.name
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level == 0:
                    module = stmt.module
                else:
                    pkg = self._package_parts()
                    if not pkg or stmt.level - 1 >= len(pkg):
                        continue
                    base = pkg[: len(pkg) - (stmt.level - 1)]
                    module = ".".join(
                        base + ([stmt.module] if stmt.module else []))
                if not module:
                    continue
                for a in stmt.names:
                    alias = a.asname or a.name
                    # could name a submodule OR a function; record both
                    # interpretations and let lookup pick whichever the
                    # summary table actually contains
                    self._alias_modules.setdefault(
                        alias, f"{module}.{a.name}")
                    self._from_imports[alias] = (module, a.name)

    def _summarize_tree(self, tree: ast.Module) -> Dict[str, dict]:
        """Key-consumption summaries of this module's top-level
        functions: for each key-ish parameter, the max number of
        consumptions one call incurs (0 = pure deriver, 1 = one draw,
        2 = internal reuse), computed with the same path-sensitive walk
        the lint itself uses.  Methods are skipped (call-site positional
        mapping would be off by the bound ``self``).  Summaries land in
        ``self._local_summaries`` AS they are built, so a later function
        calling an earlier helper resolves it (definition order covers
        the helper-before-caller layout this codebase uses)."""
        out = self._local_summaries
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            args = node.args
            pos = [a.arg for a in (args.posonlyargs + args.args)]
            if pos and pos[0] in ("self", "cls"):
                continue
            key_params = _key_param_names(node)
            if not key_params:
                continue
            state = _KeyState()
            for n in key_params:
                state.fresh(n)
            self._summary_peaks = {}
            self._walk_keys(list(node.body), state, loop_depth=0,
                            skip_defs=True)
            peaks = self._summary_peaks
            self._summary_peaks = None
            out[node.name] = {
                "name": node.name,
                "params": pos,
                "weights": {p: min(peaks.get(p, 0), 2)
                            for p in key_params},
            }
        return out

    def _lookup_summary(self, qual: Optional[str],
                        name: str) -> Optional[dict]:
        """The callee's key summary, resolved through local defs, import
        aliases, or a fully-dotted qualifier; None = unknown callee."""
        if qual is None:
            local = self._local_summaries.get(name)
            if local is not None:
                return local
            tgt = self._from_imports.get(name)
            if tgt is not None:
                return self._key_summaries.get(tgt[0], {}).get(tgt[1])
            return None
        mod = self._alias_modules.get(qual, qual)
        return self._key_summaries.get(mod, {}).get(name)

    def _diag(self, rule: str, node: ast.AST, message: str) -> None:
        self.diags.append(Diagnostic(
            rule=rule, message=message, file=self.filename,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0)))

    # ---------------- f64-dtype ----------------

    def _check_f64(self, node: ast.Call) -> None:
        """float64 reaching a tensor: a ``dtype=`` keyword, a ``.to()``
        / ``.type()`` target, or ``.double()``."""
        _, name = _call_name(node)
        method = isinstance(node.func, ast.Attribute)
        hit = None
        if any(kw.arg == "dtype" and self._is_f64_expr(kw.value)
               for kw in node.keywords):
            hit = f"dtype=float64 passed to {name}()"
        elif method and name in ("to", "type") and \
                any(self._is_f64_expr(a) for a in node.args):
            hit = f".{name}(float64)"
        elif method and name == "double" and not node.args:
            hit = ".double()"
        if hit:
            self._diag("f64-dtype", node,
                       f"{hit} in tensor code: on the H100 float64 moves "
                       "twice the bytes of float32 and runs at half the "
                       "fp32 rate; use float32, or pragma with the "
                       "exactness float64 buys here")

    @staticmethod
    def _is_f64_expr(expr: ast.AST) -> bool:
        return isinstance(expr, ast.Attribute) and \
            expr.attr in _F64_NAMES and \
            isinstance(expr.value, ast.Name) and expr.value.id == "torch"

    # ---------------- key-reuse ----------------

    def _check_key_reuse(self, fn: ast.FunctionDef) -> None:
        state = _KeyState()
        for n in _key_param_names(fn):
            state.fresh(n)
        self._walk_keys(list(fn.body), state, loop_depth=0,
                        skip_defs=True)

    def _consume(self, state: _KeyState, name: str, node: ast.AST,
                 weight: int, via: Optional[str] = None) -> None:
        canon = state.canon(name)
        if canon is None or weight <= 0:
            return
        state.count[canon] = state.count.get(canon, 0) + weight
        if canon not in state.site:
            state.site[canon] = (getattr(node, "lineno", 0),
                                 getattr(node, "col_offset", 0))
        if self._summary_peaks is not None:
            # summary mode: record the peak, emit nothing (the callers
            # of this function get the weight; its own body gets its
            # own normal lint pass)
            self._summary_peaks[canon] = max(
                self._summary_peaks.get(canon, 0), state.count[canon])
            return
        if state.count[canon] >= 2:
            hint = f" (helper {via!r} draws from its key argument)" \
                if via else ""
            self._diag(
                "key-reuse", node,
                f"PRNG key {name!r} consumed more than once on one "
                "execution path; split/fold_in a fresh subkey per "
                f"consumer (utils/prng.py){hint}")
            # report once per key
            state.drop(name)
            state.count.pop(canon, None)

    def _key_expr_handling(self, state: _KeyState, value: ast.AST,
                           targets: List[ast.expr], node: ast.AST,
                           loop_depth: int) -> bool:
        """Handle an assignment whose RHS may derive or alias keys.
        Returns True if the assignment was key-related."""
        # alias: k2 = k1
        if isinstance(value, ast.Name) and state.canon(value.id):
            for t in targets:
                if isinstance(t, ast.Name):
                    state.alias[t.id] = state.canon(value.id)
            return True
        if isinstance(value, ast.Call):
            qual, name = _call_name(value)
            if _is_key_deriver(qual, name):
                # deriving consumes nothing; targets become fresh keys
                for t in targets:
                    if isinstance(t, ast.Name):
                        state.fresh(t.id, loop_depth)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        for el in t.elts:
                            if isinstance(el, ast.Name):
                                state.fresh(el.id, loop_depth)
                return True
            if self._is_deriver_helper(qual, name, value, state):
                # a derive-only HELPER consumes nothing either, but its
                # return value is whatever the helper returns — not
                # necessarily keys — so targets merely stop being
                # tracked (unlike the prng derivers above)
                for t in targets:
                    if isinstance(t, ast.Name):
                        state.drop(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        for el in t.elts:
                            if isinstance(el, ast.Name):
                                state.drop(el.id)
                return True
        return False

    def _is_deriver_helper(self, qual: Optional[str], name: str,
                           call: ast.Call, state: _KeyState) -> bool:
        """A helper whose summary says every tracked key argument maps
        to a weight-0 (derive-only) parameter — e.g. a local
        ``fan_out(key, n)`` wrapper around ``random.split``.  Such
        helpers may be called repeatedly on one key, exactly like the
        prng derivers themselves."""
        summary = self._lookup_summary(qual, name)
        if summary is None:
            return False
        saw_key = False
        for pos, arg in enumerate(call.args):
            if isinstance(arg, ast.Name) and state.canon(arg.id):
                saw_key = True
                if self._arg_weight(summary, pos=pos, kw=None) != 0:
                    return False
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name) and \
                    state.canon(kw.value.id):
                saw_key = True
                if self._arg_weight(summary, pos=None,
                                    kw=kw.arg) != 0:
                    return False
        return saw_key

    @staticmethod
    def _arg_weight(summary: Optional[dict], pos: Optional[int],
                    kw: Optional[str]) -> int:
        """How many consumptions passing a key as this argument costs,
        per the callee's summary; 1 (the conservative default) when the
        callee or the receiving parameter is unknown."""
        if summary is None:
            return 1
        pname = kw
        if pname is None and pos is not None and \
                pos < len(summary["params"]):
            pname = summary["params"][pos]
        if pname is None:
            return 1
        w = summary["weights"].get(pname)
        return 1 if w is None else w

    def _walk_keys(self, stmts: List[ast.stmt], state: _KeyState,
                   loop_depth: int, skip_defs: bool = False) -> bool:
        """Walk statements tracking key consumption; returns True if this
        block terminates (return/raise) so callers skip merging it."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are linted as their own functions
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    self._scan_expr_keys(stmt.value, state, loop_depth)
                return True
            if isinstance(stmt, ast.Raise):
                return True
            if isinstance(stmt, (ast.Break, ast.Continue)):
                return True
            if isinstance(stmt, ast.Assign):
                if not self._key_expr_handling(state, stmt.value,
                                               stmt.targets, stmt,
                                               loop_depth):
                    self._scan_expr_keys(stmt.value, state, loop_depth)
                    # reassignment from a non-key expr kills key tracking
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            state.drop(t.id)
                continue
            if isinstance(stmt, ast.AugAssign):
                self._scan_expr_keys(stmt.value, state, loop_depth)
                continue
            if isinstance(stmt, ast.If):
                s_body = state.copy()
                s_else = state.copy()
                self._scan_expr_keys(stmt.test, state, loop_depth)
                t_body = self._walk_keys(stmt.body, s_body, loop_depth)
                t_else = self._walk_keys(stmt.orelse, s_else, loop_depth)
                live = [s for s, t in ((s_body, t_body), (s_else, t_else))
                        if not t]
                if live:
                    state.alias.clear()
                    state.count.clear()
                    state.merge_max(*live)
                elif t_body and t_else:
                    return True
                continue
            if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    self._scan_expr_keys(stmt.iter, state, loop_depth)
                else:
                    self._scan_expr_keys(stmt.test, state, loop_depth)
                s_loop = state.copy()
                self._walk_keys(stmt.body, s_loop, loop_depth + 1)
                state.merge_max(s_loop)
                self._walk_keys(stmt.orelse, state, loop_depth)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr_keys(item.context_expr, state,
                                         loop_depth)
                if self._walk_keys(stmt.body, state, loop_depth):
                    return True
                continue
            if isinstance(stmt, ast.Try):
                if self._walk_keys(stmt.body, state, loop_depth):
                    return True
                for h in stmt.handlers:
                    self._walk_keys(h.body, state.copy(), loop_depth)
                self._walk_keys(stmt.orelse, state, loop_depth)
                self._walk_keys(stmt.finalbody, state, loop_depth)
                continue
            if isinstance(stmt, ast.Expr):
                self._scan_expr_keys(stmt.value, state, loop_depth)
                continue
            # anything else: scan expressions conservatively
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr_keys(child, state, loop_depth)
        return False

    def _scan_expr_keys(self, expr: ast.AST, state: _KeyState,
                        loop_depth: int) -> None:
        """Count key consumptions inside an expression.

        A bare key name passed as an argument to a call counts by what
        the callee does with it: nothing for pure derivers
        (split/fold_in/... and weight-0 summarized helpers), the
        callee's summarized consumption count for known helpers
        (cross-function pass — module docstring), and the conservative
        1 for unknown callees.  Inside a Python loop a consumption of a
        key derived *outside* the loop counts double (it repeats every
        iteration).
        """
        if expr is None:
            return
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            qual, name = _call_name(node)
            derives = _is_key_deriver(qual, name)
            summary = None if derives else self._lookup_summary(qual,
                                                                name)
            via = summary["name"] if summary else None
            args = [(pos, None, a) for pos, a in enumerate(node.args)] \
                + [(None, kw.arg, kw.value) for kw in node.keywords]
            for pos, kwname, arg in args:
                if isinstance(arg, ast.Name) and state.canon(arg.id):
                    if derives:
                        continue
                    weight = self._arg_weight(summary, pos=pos,
                                              kw=kwname)
                    if weight <= 0:
                        continue
                    canon = state.canon(arg.id)
                    if loop_depth > state.depth.get(canon, 0):
                        weight = max(weight, 2)
                    self._consume(state, arg.id, node, weight, via=via)

    # ---------------- sync-in-loop ----------------

    def _sync_call_name(self, node: ast.Call) -> Optional[str]:
        qual, name = _call_name(node)
        if name in _SYNC_CALLS_ATTR and isinstance(node.func,
                                                   ast.Attribute):
            return f".{name}()"
        if qual == "torch.cuda" and name == "synchronize":
            return "torch.cuda.synchronize()"
        if qual == "torch" and name == "nonzero":
            return "torch.nonzero"
        if qual in ("np", "numpy") and name in ("asarray", "array"):
            return f"np.{name}"
        return None

    def _check_sync_in_loop(self, fn: ast.FunctionDef) -> None:
        def check_stmt_exprs(stmt: ast.stmt) -> None:
            """Flag sync calls in one simple statement, skipping nested
            function/lambda bodies."""
            stack = [stmt]
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    continue
                if isinstance(node, ast.Call):
                    sync = self._sync_call_name(node)
                    if sync:
                        self._diag(
                            "sync-in-loop", node,
                            f"{sync} inside a Python loop: a host-device "
                            "sync per iteration; batch the readback "
                            "outside the loop (or pragma with the reason "
                            "if this loop IS the host driver)")
                stack.extend(ast.iter_child_nodes(node))

        def scan(stmts: List[ast.stmt], in_loop: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                    scan(stmt.body, True)
                    scan(stmt.orelse, in_loop)
                    continue
                if isinstance(stmt, ast.If):
                    if in_loop:
                        check_stmt_exprs(stmt.test)
                    scan(stmt.body, in_loop)
                    scan(stmt.orelse, in_loop)
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    if in_loop:
                        for item in stmt.items:
                            check_stmt_exprs(item.context_expr)
                    scan(stmt.body, in_loop)
                    continue
                if isinstance(stmt, ast.Try):
                    scan(stmt.body, in_loop)
                    for h in stmt.handlers:
                        scan(h.body, in_loop)
                    scan(stmt.orelse, in_loop)
                    scan(stmt.finalbody, in_loop)
                    continue
                if in_loop:
                    check_stmt_exprs(stmt)

        scan(fn.body, False)


def summarize_key_params(source: str, filename: str = "<memory>"
                         ) -> Dict[str, dict]:
    """Per-function key-consumption summaries of one module (the
    cross-function ``key-reuse`` table; see Linter._summarize_tree).
    Unparseable sources summarize to nothing — the lint pass will
    report the syntax error itself."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError:
        return {}
    linter = Linter(source, filename)
    linter._collect_imports(tree)
    return linter._summarize_tree(tree)


def lint_source(source: str, filename: str = "<memory>",
                key_summaries: Optional[Dict[str, Dict[str, dict]]] = None
                ) -> Tuple[List[Diagnostic], int]:
    """Lint one source string; returns (diagnostics, n_suppressed).
    ``key_summaries`` ({module: {function: summary}}) enables the
    cross-module half of the key-reuse rule (lint_paths builds it over
    the whole scanned set; module-local helpers resolve either way)."""
    linter = Linter(source, filename, key_summaries=key_summaries)
    diags = linter.run()
    return diags, linter.n_suppressed

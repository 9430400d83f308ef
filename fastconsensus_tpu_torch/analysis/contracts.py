"""fcheck-contract: whole-program name-contract & wire-schema pass.

The reference's pass (``fastconsensus_tpu/analysis/contracts.py``) over
the port's package, with the same engine: the serve modules' counter,
gauge and series write sites, the typed torch-free client dataclasses
(serve/client.py) parsing ``/metricsz``/``/healthz``/``/status`` JSON,
and the gates (obs/history.py's check_* rules, obs/bench_report.py and
``chip_smoke.py``'s checks) that read metric names as literals.  A
misspelled counter, a gate reading a key nobody writes, or a client
field the server stopped emitting all fail *silently*: the gate goes
vacuously green, the field quietly reads ``None``.

**Writer inventory** — AST constant propagation over every
``.inc(``/``.gauge(``/``.observe(``/``.mark(``/``.hist(`` tag, every
``CompileGuard(..., counter=...)`` kwarg, and every
``flight.record(<kind>)`` event name in the package.  f-strings,
``+``-joins, loop variables over literal tuples, module/param string
constants and string ``IfExp``\\ s resolve into bounded *templates*
(``serve.device.{i}.jobs`` -> ``serve.device.*.jobs``); an
unresolvable fragment becomes a wildcard segment.  Dict-literal keys,
``dict(k=...)`` kwargs and ``out["k"] = ...`` subscript stores across
the package, plus the repo-root ``bench.py`` (read as text, never
imported: until the port writes bench artifacts of its own, it is the
writer of the schema obs/history.py reads), form the *wire-key
universe* — every JSON field any endpoint can emit.

**Reader inventory** — the names consumed by obs/history.py gates and
tables, obs/bench_report.py, the dotted metric names ``chip_smoke.py``
reads out of ``/metricsz`` snapshots and counter deltas, the
typed-client ``.get(``/``["k"]`` lookups in serve/client.py, the
port's README section (``## PyTorch/CUDA port`` to the next ``## ``:
its rule table and prose) and the counters reference
``fastconsensus_tpu_torch/COUNTERS.md``.

**Rules** (all in the ``--only``/pragma vocabulary; suppress a
deliberate violation with ``# fcheck: ok=<rule> -- reason``, or
``<!-- # fcheck: ok=doc-drift -- reason -->`` in markdown):

- ``phantom-reader`` — a gate/probe read names a metric no writer
  produces, or a payload key nothing emits (the gate can never fire).
- ``schema-drift`` — a typed-client key with no matching server
  emitter, or server keys a matched client parser silently drops.
- ``dead-counter`` — a metric written but never read by any gate,
  client, probe or package consumer, nor documented in COUNTERS.md.
- ``event-vocab`` — a ``flight.record(...)`` kind missing from
  obs/flight.py ``EVENT_KINDS``, or a vocabulary entry no site records.
- ``doc-drift`` — the README rule table missing a rule id, or
  COUNTERS.md out of sync with the writer inventory.

**Modes** — *repo mode* when the scanned source set contains the port's
serving + obs surface (the sentinel modules below), *fixture mode* over
any scanned file declaring a module-level ``CONTRACT_SPEC`` literal.
Partial scans skip repo mode: a lone module would make every
cross-module name look phantom.

**Runtime cross-check** — :func:`assert_covered` takes a live
``/metricsz`` snapshot and the committed inventory
(``analysis/contract_inventory.json``, written by ``--emit-inventory``)
and asserts every observed name unions cleanly with the static writer
templates; ``chip_smoke.py``'s phases ``serve`` and ``fleet`` run it on
every snapshot they take on the card.

Everything here is stdlib only (no ``torch``): ``bench_report --check``
loads it where torch is absent.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from fastconsensus_tpu_torch.analysis.diagnostics import Diagnostic, apply_pragmas

CONTRACT_RULES = {
    "phantom-reader": "gate/CI reads a name no writer produces",
    "schema-drift": "typed client vs server wire schema mismatch",
    "dead-counter": "metric written but never read nor documented",
    "event-vocab": "flight event kinds vs EVENT_KINDS vocabulary",
    "doc-drift": "README rule table / COUNTERS.md vs the inventory",
}

INVENTORY_TOOL = "fcheck-contract"
INVENTORY_VERSION = 1

# the scanned set must contain this serving + obs surface of the port's
# package for the whole-program rules to be meaningful (repo mode)
PACKAGE = "fastconsensus_tpu_torch"
_SENTINELS = ("serve/server.py", "serve/client.py", "obs/counters.py",
              "obs/history.py", "obs/flight.py")

# markers around the auto-generated counters appendix: the reference's,
# in a file of the port's own (COUNTERS.md), so one reader serves both
# and the reference's README scan never sees the port's rows
COUNTERS_DOC = "COUNTERS.md"
APPENDIX_BEGIN = "<!-- fcheck-contract: counters begin -->"
APPENDIX_END = "<!-- fcheck-contract: counters end -->"

# wildcard placeholder while resolving; rendered as "*" in templates
_WILD = "\x00"
_MAX_EXPAND = 16

_METHOD_KINDS = {"inc": "counter", "gauge": "gauge", "observe": "series",
                 "hist": "hist", "mark": "rate"}

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_*.]*$")
_PLAIN_KEY_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_DOTTED_RE = re.compile(r"\b[a-z][a-z0-9_]*(?:\.[a-z0-9_*]+)+\b")
# file-ish suffixes the shell/README scanners must not mistake for
# metric names
_FILE_SUFFIXES = (".py", ".sh", ".json", ".jsonl", ".md", ".txt",
                  ".yaml", ".yml", ".log", ".toml", ".cfg", ".ini",
                  ".npz", ".out", ".pid", ".csv", ".tmp")
# README backtick tokens whose first segment names a module/tool, not
# a metric
_MODULE_PREFIXES = {"fastconsensus_tpu", "np", "jax", "os", "sys",
                    "ast", "json", "scripts", "tests", "analysis",
                    "jnp", "self", "args", "pytest", "torch",
                    PACKAGE}
# the README section the port's doc rules read
README_SECTION = "## PyTorch/CUDA port"
# how a stale counters reference is regenerated
_REGEN_HINT = (f"python -m {PACKAGE}.analysis --emit-appendix > "
               f"{PACKAGE}/{COUNTERS_DOC}")


# ---------------------------------------------------------------------------
# constant propagation: resolve a string expression to a bounded set of
# template strings (wildcard placeholder for unresolvable fragments)
# ---------------------------------------------------------------------------

def _module_env(tree: ast.AST) -> Dict[str, Set[str]]:
    """Module-level ``NAME = "str"`` / ``NAME = ("a", "b")`` constants.
    Nested literal collections flatten (``PHASE_STAMPS``-style
    vocabulary tuples): every string inside counts as a candidate."""
    env: Dict[str, Set[str]] = {}
    for node in ast.iter_child_nodes(tree):
        targets: List[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        vals = _literal_strings(value) or _flatten_strings(value)
        if not vals:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                env.setdefault(t.id, set()).update(vals)
    return env


def _flatten_strings(node: ast.expr) -> Set[str]:
    """Every string constant inside a (possibly nested) tuple/list
    literal — the shape of the package's name-vocabulary declarations
    (``PHASE_STAMPS``: tuples of (phase, stamp) pairs)."""
    out: Set[str] = set()
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and \
                    isinstance(elt.value, str):
                out.add(elt.value)
            else:
                out |= _flatten_strings(elt)
    return out


def _literal_strings(node: ast.expr) -> Optional[Set[str]]:
    """A string constant or tuple/list of string constants, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.add(elt.value)
        return out if out else None
    return None


def _function_env(fn: ast.AST, module_env: Dict[str, Set[str]]
                  ) -> Dict[str, Set[str]]:
    """Flow-insensitive string bindings visible inside ``fn``: module
    constants, string parameter defaults, ``for x in ("a", "b")`` loop
    variables (including tuples named by a module constant), and simple
    local string assignments — enough to resolve every metric-name
    f-string the serve stack actually writes."""
    env = dict(module_env)
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = fn.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults):
            vals = _literal_strings(default)
            if vals:
                env.setdefault(arg.arg, set()).update(vals)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None:
                vals = _literal_strings(default)
                if vals:
                    env.setdefault(arg.arg, set()).update(vals)
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.comprehension)):
            target = node.target
            it = node.iter
            vals = _literal_strings(it)
            if vals is None and isinstance(it, ast.Name):
                vals = module_env.get(it.id)
            if vals and isinstance(target, ast.Name):
                env.setdefault(target.id, set()).update(vals)
        elif isinstance(node, ast.Assign):
            vals = _resolve(node.value, env)
            if vals:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        env.setdefault(t.id, set()).update(vals)
    return env


def _resolve(node: ast.expr, env: Dict[str, Set[str]]
             ) -> Optional[Set[str]]:
    """Resolve a string expression to a bounded set of candidate
    strings (``_WILD`` marks unresolvable fragments); None when the
    node is not string-like at all (e.g. a float passed to
    ``LatencyHistogram.record``)."""
    if isinstance(node, ast.Constant):
        return {node.value} if isinstance(node.value, str) else None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.IfExp):
        body = _resolve(node.body, env) or {_WILD}
        orelse = _resolve(node.orelse, env) or {_WILD}
        return _cap(body | orelse)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _resolve(node.left, env)
        right = _resolve(node.right, env)
        if left is None and right is None:
            return None
        return _cap({a + b for a in (left or {_WILD})
                     for b in (right or {_WILD})})
    if isinstance(node, ast.JoinedStr):
        combos: Set[str] = {""}
        for part in node.values:
            if isinstance(part, ast.Constant):
                vals = {str(part.value)}
            elif isinstance(part, ast.FormattedValue):
                vals = _resolve(part.value, env) or {_WILD}
            else:
                vals = {_WILD}
            combos = _cap({c + v for c in combos for v in vals})
        return combos
    return None


def _cap(vals: Set[str]) -> Set[str]:
    """Bound template expansion: past the cap, collapse to one
    all-wildcard candidate rather than enumerate."""
    return vals if len(vals) <= _MAX_EXPAND else {_WILD}


def _to_templates(vals: Iterable[str]) -> Set[str]:
    """Candidate strings -> dotted templates with ``*`` wildcard
    (sub)segments.  Candidates whose *first* segment is not literal are
    dropped: a leading wildcard would match everything and silently
    satisfy any reader."""
    out: Set[str] = set()
    for v in vals:
        segs = []
        for seg in v.split("."):
            seg = re.sub(r"\x00+", "*", seg)
            segs.append(seg)
        if not segs or "*" in segs[0] or not segs[0]:
            continue
        tpl = ".".join(segs)
        if _NAME_RE.match(tpl.replace("*", "x")):
            out.add(tpl)
    return out


def _seg_match(a: str, b: str) -> bool:
    from fnmatch import fnmatchcase

    if "*" in a and "*" not in b:
        return fnmatchcase(b, a)
    if "*" in b and "*" not in a:
        return fnmatchcase(a, b)
    if "*" in a and "*" in b:
        return True
    return a == b


def template_matches(template: str, name: str) -> bool:
    """Does a writer template cover a (possibly templated) read name?
    Segment-wise; ``*`` matches within its own segment only."""
    ta, tb = template.split("."), name.split(".")
    if len(ta) != len(tb):
        return False
    return all(_seg_match(a, b) for a, b in zip(ta, tb))


def _covered(name: str, templates: Iterable[str]) -> bool:
    return any(template_matches(t, name) for t in templates)


# ---------------------------------------------------------------------------
# extraction: writers (metrics / events / wire keys) and readers
# ---------------------------------------------------------------------------

class ModuleFacts:
    """Everything one Python module contributes to the contract."""

    def __init__(self, path: str):
        self.path = path
        # template -> {"kind": str, "lines": [int]}
        self.metrics: Dict[str, Dict[str, Any]] = {}
        self.events: List[Tuple[str, int]] = []        # (kind, line)
        self.wire_keys: Dict[str, int] = {}            # key -> first line
        # dict-literal emit groups for the reverse schema check
        self.emit_groups: List[Tuple[int, Set[str]]] = []
        self.reads: List[Tuple[str, int]] = []         # resolved names
        # classname -> (line, read keys) for ``from_payload`` parsers
        self.parsers: Dict[str, Tuple[int, Set[str]]] = {}
        self.event_kinds: Optional[Tuple[Sequence[str], int]] = None
        self.spec: Optional[Tuple[dict, int]] = None

    def add_metric(self, tpl: str, kind: str, line: int) -> None:
        slot = self.metrics.setdefault(tpl, {"kind": kind, "lines": []})
        slot["lines"].append(line)


def _scan_module(path: str, src: str) -> Optional[ModuleFacts]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return None  # astlint owns the syntax-error diagnostic
    facts = ModuleFacts(path)
    module_env = _module_env(tree)

    for node in ast.iter_child_nodes(tree):
        # a module-level vocabulary tuple (PHASE_STAMPS, SLO_CLASSES,
        # _SL_PHASES...) *declares* the plain keys its consumers build
        # dicts from — that declaration is the wire contract
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                getattr(node, "value", None) is not None:
            for s in _flatten_strings(node.value):
                if _PLAIN_KEY_RE.match(s):
                    facts.wire_keys.setdefault(s, node.lineno)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "CONTRACT_SPEC":
                try:
                    spec = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    raise ValueError(
                        f"{path}:{node.lineno}: CONTRACT_SPEC must be a "
                        f"literal dict")
                if not isinstance(spec, dict):
                    raise ValueError(
                        f"{path}:{node.lineno}: CONTRACT_SPEC must be a "
                        f"dict, got {type(spec).__name__}")
                facts.spec = (spec, node.lineno)
            elif name == "EVENT_KINDS":
                vals = _literal_strings(node.value)
                if vals:
                    facts.event_kinds = (sorted(vals), node.lineno)

    # function-scoped envs: map every node to its enclosing function so
    # call-site resolution sees loop vars / param defaults / locals
    envs: Dict[int, Dict[str, Set[str]]] = {}
    owner: Dict[int, int] = {}

    def assign_owner(fn: ast.AST, fid: int) -> None:
        for sub in ast.walk(fn):
            owner.setdefault(id(sub), fid)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            envs[id(node)] = _function_env(node, module_env)
            assign_owner(node, id(node))

    def env_for(node: ast.AST) -> Dict[str, Set[str]]:
        return envs.get(owner.get(id(node), -1), module_env)

    current_class: List[Tuple[ast.ClassDef, bool]] = []

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.ClassDef):
            has_parser = any(
                isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                and b.name == "from_payload" for b in node.body)
            if has_parser:
                keys: Set[str] = set()
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and \
                            b.name == "from_payload":
                        keys |= _parser_keys(b, env_for(b) or module_env)
                facts.parsers[node.name] = (node.lineno, keys)
        if isinstance(node, ast.Dict):
            keys = set()
            for k in node.keys:
                if k is None:
                    continue  # **spread
                if isinstance(k, ast.Constant):
                    kvals = {k.value} if isinstance(k.value, str) \
                        else set()
                else:
                    kvals = _resolve(k, env_for(node)) or set()
                for kv in kvals:
                    if _PLAIN_KEY_RE.match(kv):
                        keys.add(kv)
                        facts.wire_keys.setdefault(kv, node.lineno)
            if len(keys) >= 3:
                facts.emit_groups.append((node.lineno, keys))
        if isinstance(node, ast.DictComp):
            kvals = _resolve(node.key, env_for(node)) or set()
            for kv in kvals:
                if _PLAIN_KEY_RE.match(kv):
                    facts.wire_keys.setdefault(kv, node.lineno)
        if isinstance(node, ast.Call):
            env = env_for(node)
            func = node.func
            if isinstance(func, ast.Name) and func.id == "dict" and \
                    node.keywords:
                keys = {kw.arg for kw in node.keywords if kw.arg}
                for k in keys:
                    facts.wire_keys.setdefault(k, node.lineno)
                if len(keys) >= 3:
                    facts.emit_groups.append((node.lineno, keys))
            if isinstance(func, ast.Attribute):
                attr = func.attr
                if attr in _METHOD_KINDS and node.args:
                    vals = _resolve(node.args[0], env)
                    if vals:
                        for tpl in _to_templates(vals):
                            facts.add_metric(tpl, _METHOD_KINDS[attr],
                                             node.lineno)
                elif attr == "record" and node.args:
                    vals = _resolve(node.args[0], env)
                    if vals and all(
                            re.match(r"^[a-z][a-z0-9_]*$", v)
                            for v in vals):
                        for v in sorted(vals):
                            facts.events.append((v, node.lineno))
                elif attr in ("get", "pop") and node.args:
                    vals = _resolve(node.args[0], env)
                    if vals:
                        for tpl in _to_templates(vals):
                            facts.reads.append((tpl, node.lineno))
                elif attr == "setdefault" and node.args:
                    vals = _resolve(node.args[0], env)
                    if vals:
                        for v in vals:
                            if _PLAIN_KEY_RE.match(v):
                                facts.wire_keys.setdefault(v,
                                                           node.lineno)
            for kw in node.keywords:
                if kw.arg == "counter":
                    vals = _resolve(kw.value, env)
                    if vals:
                        for tpl in _to_templates(vals):
                            facts.add_metric(tpl, "counter", node.lineno)
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                key = node.slice.value
                if isinstance(node.ctx, ast.Load):
                    if _NAME_RE.match(key):
                        facts.reads.append((key, node.lineno))
                elif _PLAIN_KEY_RE.match(key):
                    # Store / Del: a wire field the module emits
                    facts.wire_keys.setdefault(key, node.lineno)
            elif isinstance(node.ctx, ast.Store):
                # out[name] = ... with a resolvable loop/local name
                for kv in _resolve(node.slice, env_for(node)) or ():
                    if _PLAIN_KEY_RE.match(kv):
                        facts.wire_keys.setdefault(kv, node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(tree)
    return facts


def _parser_keys(fn: ast.AST, env: Dict[str, Set[str]]) -> Set[str]:
    """Keys a ``from_payload`` classmethod consumes: subscript loads,
    ``.get(``/``.pop(`` first args, and string args handed to local
    helper closures (the ``_opt("field")`` idiom)."""
    local_helpers = {b.name for b in ast.walk(fn)
                     if isinstance(b, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and b is not fn}
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                isinstance(node.ctx, ast.Load):
            keys.add(node.slice.value)
        elif isinstance(node, ast.Call):
            func = node.func
            is_get = isinstance(func, ast.Attribute) and \
                func.attr in ("get", "pop")
            is_helper = isinstance(func, ast.Name) and \
                func.id in local_helpers
            if (is_get or is_helper) and node.args:
                arg0 = node.args[0]
                if isinstance(arg0, ast.Constant) and \
                        isinstance(arg0.value, str):
                    keys.add(arg0.value)
    return {k for k in keys if _NAME_RE.match(k)}


# ---------------------------------------------------------------------------
# external readers: shell (the reference's CI script shape) and markdown
# ---------------------------------------------------------------------------

def _scan_shell(src: str) -> List[Tuple[str, int]]:
    """A small shell lexer for CI scripts: ``<<'TAG'``
    heredoc bodies are re-parsed as Python (so ``counters.get("x.y")``
    resolves exactly like package code); everything else contributes
    the dotted literals inside its quoted strings (grep/jq patterns).
    Returns (name, line) reads."""
    reads: List[Tuple[str, int]] = []
    lines = src.splitlines()
    heredoc = re.compile(r"<<-?\s*'?([A-Za-z_][A-Za-z0-9_]*)'?")
    i = 0
    while i < len(lines):
        line = lines[i]
        m = heredoc.search(line)
        if m:
            tag = m.group(1)
            body: List[str] = []
            j = i + 1
            while j < len(lines) and lines[j].strip() != tag:
                body.append(lines[j])
                j += 1
            text = "\n".join(body)
            parsed = None
            try:
                parsed = ast.parse(text)
            except SyntaxError:
                parsed = None
            if parsed is not None:
                for name, ln in _python_reads(parsed,
                                              _module_env(parsed)):
                    reads.append((name, i + 1 + ln))
            else:
                for k, body_line in enumerate(body):
                    for name in _shell_line_names(body_line):
                        reads.append((name, i + 2 + k))
            i = j + 1
            continue
        for name in _shell_line_names(line):
            reads.append((name, i + 1))
        i += 1
    return reads


def _shell_line_names(line: str) -> List[str]:
    # strip an unquoted trailing comment so pragma reasons and prose
    # never read as probes
    depth = {"'": False, '"': False}
    for pos, ch in enumerate(line):
        if ch in depth and not depth["'" if ch == '"' else '"']:
            depth[ch] = not depth[ch]
        elif ch == "#" and not depth["'"] and not depth['"']:
            line = line[:pos]
            break
    out: List[str] = []
    for quoted in re.findall(r"'([^']*)'|\"([^\"]*)\"", line):
        for frag in quoted:
            if not frag:
                continue
            for tok in _DOTTED_RE.findall(frag.replace("\\", "")):
                if tok.endswith(_FILE_SUFFIXES):
                    continue
                if tok.split(".", 1)[0] in _MODULE_PREFIXES:
                    continue
                out.append(tok)
    return out


def _python_reads(tree: ast.AST, module_env: Dict[str, Set[str]]
                  ) -> List[Tuple[str, int]]:
    """Dotted/plain key reads from parsed Python (heredocs and the
    gate scripts): ``.get(``/``.pop(`` first args and subscript loads,
    resolved through the same constant propagation as package code."""
    envs: Dict[int, Dict[str, Set[str]]] = {}
    owner: Dict[int, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            envs[id(node)] = _function_env(node, module_env)
            for sub in ast.walk(node):
                owner.setdefault(id(sub), id(node))
    reads: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        env = envs.get(owner.get(id(node), -1), module_env)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "pop") and node.args:
            vals = _resolve(node.args[0], env)
            if vals:
                for tpl in _to_templates(vals):
                    reads.append((tpl, node.lineno))
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                isinstance(node.ctx, ast.Load) and \
                _NAME_RE.match(node.slice.value):
            reads.append((node.slice.value, node.lineno))
    return reads


def _scan_readme(src: str) -> Dict[str, Any]:
    """README facts: backticked rule ids, dotted counter references in
    prose (``<i>``/``{name}`` placeholders normalize to wildcards), and
    the auto-generated counters appendix rows between the markers."""
    refs: List[Tuple[str, int]] = []
    appendix: Dict[str, Tuple[str, int]] = {}
    rule_ids: Set[str] = set()
    lines = src.splitlines()
    begin = end = None
    for idx, line in enumerate(lines):
        if APPENDIX_BEGIN in line:
            begin = idx
        elif APPENDIX_END in line:
            end = idx
    row_re = re.compile(r"^\|\s*`([^`]+)`\s*\|\s*([a-z]+)\s*\|")
    for idx, line in enumerate(lines):
        in_appendix = begin is not None and end is not None and \
            begin < idx < end
        if in_appendix:
            m = row_re.match(line.strip())
            if m:
                appendix[m.group(1)] = (m.group(2), idx + 1)
            continue
        for tok in re.findall(r"`([^`]+)`", line):
            if re.match(r"^[a-z][a-z0-9]*(-[a-z0-9]+)+$", tok):
                rule_ids.add(tok)
                continue
            norm = re.sub(r"<[^<>]*>|\{[^{}]*\}", "*", tok)
            if " " in norm or "/" in norm or "(" in norm or \
                    "=" in norm or norm.endswith(_FILE_SUFFIXES):
                continue
            if "." not in norm or not re.match(r"^[a-z]", norm):
                continue
            if not _NAME_RE.match(norm):
                continue
            if norm.split(".", 1)[0] in _MODULE_PREFIXES:
                continue
            refs.append((norm, idx + 1))
    return {"refs": refs, "appendix": appendix, "rule_ids": rule_ids,
            "has_appendix": begin is not None and end is not None,
            "appendix_line": (begin + 1) if begin is not None else 1}


# ---------------------------------------------------------------------------
# the contract universe and the five rules
# ---------------------------------------------------------------------------

class Universe:
    """One resolved contract universe (repo-wide or one fixture)."""

    def __init__(self) -> None:
        self.metrics: Dict[str, Dict[str, Any]] = {}
        self.wire_keys: Dict[str, str] = {}      # key -> "file:line"
        self.events: List[Tuple[str, str, int]] = []
        self.emit_groups: List[Tuple[str, int, Set[str]]] = []
        self.pkg_reads: List[Tuple[str, str, int]] = []
        self.gate_reads: List[Tuple[str, str, int]] = []
        self.client_reads: List[Tuple[str, str, int]] = []
        self.parsers: Dict[str, Tuple[str, int, Set[str]]] = {}
        self.event_kinds: Optional[Tuple[Sequence[str], str, int]] = None
        self.readme: Optional[Dict[str, Any]] = None
        self.readme_path: str = "README.md"
        # where the counters appendix lives (COUNTERS.md in repo mode;
        # the fixture itself in fixture mode)
        self.appendix_path: Optional[str] = None
        # the README line the rule-table findings point at
        self.rule_table_line: int = 1
        self.rule_universe: Optional[Set[str]] = None
        # fixture mode: emitter dicts and parsers share one file, so
        # the reverse schema check must not skip same-file groups (in
        # repo mode it must, or client.py's own payload dicts would
        # anchor against its parsers)
        self.same_file_groups_ok = False

    # -- assembly -----------------------------------------------------

    def add_metric_writers(self, facts: ModuleFacts) -> None:
        for tpl, info in facts.metrics.items():
            slot = self.metrics.setdefault(
                tpl, {"kind": info["kind"], "writers": []})
            for ln in info["lines"]:
                slot["writers"].append(f"{facts.path}:{ln}")

    def add_writer_facts(self, facts: ModuleFacts) -> None:
        self.add_metric_writers(facts)
        for key, ln in facts.wire_keys.items():
            self.wire_keys.setdefault(key, f"{facts.path}:{ln}")
        for kind, ln in facts.events:
            self.events.append((kind, facts.path, ln))
        for ln, keys in facts.emit_groups:
            self.emit_groups.append((facts.path, ln, keys))
        if facts.event_kinds and self.event_kinds is None:
            kinds, ln = facts.event_kinds
            self.event_kinds = (kinds, facts.path, ln)

    def add_reads(self, facts: ModuleFacts, role: str) -> None:
        dest = {"pkg": self.pkg_reads, "gate": self.gate_reads,
                "client": self.client_reads}[role]
        for name, ln in facts.reads:
            dest.append((name, facts.path, ln))
        if role == "client":
            for cls, (ln, keys) in facts.parsers.items():
                self.parsers[cls] = (facts.path, ln, keys)
                for k in keys:
                    dest.append((k, facts.path, ln))

    # -- rule helpers -------------------------------------------------

    def metric_templates(self) -> List[str]:
        return sorted(self.metrics)

    def name_known(self, name: str) -> bool:
        """Is a read name satisfied by any writer?  Dotted names match
        the metric templates; plain names match the wire-key universe
        (or a dotless metric, e.g. the rate-tracker tags)."""
        if "." in name:
            return _covered(name, self.metrics)
        return name in self.wire_keys or _covered(name, self.metrics)


def _check_universe(uni: Universe, rules: Set[str]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    def add(rule: str, msg: str, file: str, line: int) -> None:
        diags.append(Diagnostic(rule=rule, message=msg, file=file,
                                line=line, col=0, severity="error"))

    # ---- phantom-reader: gate/CI reads with no producer -------------
    if "phantom-reader" in rules:
        for name, path, line in uni.gate_reads:
            if not uni.name_known(name):
                kind = "metric" if "." in name else "key"
                add("phantom-reader",
                    f"reads {kind} '{name}' that no writer produces — "
                    f"this gate/probe can never fire; fix the name or "
                    f"add the writer", path, line)

    # ---- schema-drift: typed client vs server wire schema -----------
    if "schema-drift" in rules:
        for name, path, line in uni.client_reads:
            if not uni.name_known(name):
                add("schema-drift",
                    f"typed client reads '{name}' but no server/emitter "
                    f"writes that key — the field silently parses as "
                    f"missing", path, line)
        for cls, (cpath, cline, reads) in sorted(uni.parsers.items()):
            best: Optional[Tuple[float, int, str, int, Set[str]]] = None
            for gpath, gline, keys in uni.emit_groups:
                if gpath == cpath and not uni.same_file_groups_ok:
                    continue  # the parser's own module
                inter = len(reads & keys)
                if inter < 3 or not reads:
                    continue
                frac = inter / len(reads)
                if frac < 0.6:
                    continue
                if best is None or (frac, inter) > best[:2]:
                    best = (frac, inter, gpath, gline, keys)
            if best is not None:
                dropped = sorted(best[4] - reads)
                if dropped:
                    add("schema-drift",
                        f"emitter dict matches client parser {cls} "
                        f"({cpath.rsplit(os.sep, 1)[-1]}:{cline}) but "
                        f"also emits {', '.join(dropped)} which the "
                        f"client silently drops — consume or remove",
                        best[2], best[3])

    # ---- dead-counter: written, never read nor documented -----------
    if "dead-counter" in rules:
        consumed: List[str] = [n for n, _, _ in uni.pkg_reads]
        consumed += [n for n, _, _ in uni.gate_reads]
        consumed += [n for n, _, _ in uni.client_reads]
        if uni.readme:
            consumed += [n for n, _ in uni.readme["refs"]]
            consumed += list(uni.readme["appendix"])
        dotted_reads = [n for n in consumed if "." in n]
        plain_reads = {n for n in consumed if "." not in n}
        for tpl in sorted(uni.metrics):
            if "." in tpl:
                live = any(template_matches(tpl, r)
                           for r in dotted_reads)
            else:
                live = tpl in plain_reads
            if not live:
                where = uni.metrics[tpl]["writers"][0]
                path, _, line = where.rpartition(":")
                add("dead-counter",
                    f"metric '{tpl}' ({uni.metrics[tpl]['kind']}) is "
                    f"written but never read by any gate, client, CI "
                    f"probe or package consumer, and is not documented "
                    f"— delete it or document it in the counters "
                    f"reference", path, int(line))

    # ---- event-vocab: record() kinds vs EVENT_KINDS -----------------
    if "event-vocab" in rules:
        if uni.event_kinds is None:
            if uni.events:
                kind, path, line = uni.events[0]
                add("event-vocab",
                    "flight events are recorded but no EVENT_KINDS "
                    "vocabulary is declared (obs/flight.py)", path, line)
        else:
            vocab, vpath, vline = uni.event_kinds
            vocab_set = set(vocab)
            recorded = {k for k, _, _ in uni.events}
            for kind, path, line in uni.events:
                if kind not in vocab_set:
                    add("event-vocab",
                        f"flight event '{kind}' is recorded but missing "
                        f"from EVENT_KINDS — postmortem readers and "
                        f"kind filters won't know it", path, line)
            for kind in sorted(vocab_set - recorded):
                add("event-vocab",
                    f"EVENT_KINDS declares '{kind}' but no site records "
                    f"it — stale vocabulary entry", vpath, vline)

    # ---- doc-drift: README tables vs the inventory ------------------
    if "doc-drift" in rules and uni.readme is not None:
        rm = uni.readme
        if uni.rule_universe:
            for rule in sorted(uni.rule_universe - rm["rule_ids"]):
                add("doc-drift",
                    f"rule id '{rule}' is not documented in the README "
                    f"static-analysis rule table", uni.readme_path,
                    uni.rule_table_line)
        rpath = uni.appendix_path or uni.readme_path
        if not rm["has_appendix"]:
            add("doc-drift",
                "README has no auto-generated counters reference "
                f"(markers '{APPENDIX_BEGIN}' .. '{APPENDIX_END}')",
                rpath, 1)
        else:
            inv_names = set(uni.metrics)
            doc_names = set(rm["appendix"])
            for name in sorted(inv_names - doc_names):
                add("doc-drift",
                    f"counters reference is missing '{name}' — "
                    f"regenerate the appendix ({_REGEN_HINT})",
                    rpath, rm["appendix_line"])
            for name in sorted(doc_names - inv_names):
                _, line = rm["appendix"][name]
                add("doc-drift",
                    f"counters reference documents '{name}' but no "
                    f"writer produces it — stale row", rpath, line)
            for name, (kind, line) in sorted(rm["appendix"].items()):
                if name in uni.metrics and \
                        uni.metrics[name]["kind"] != kind:
                    add("doc-drift",
                        f"counters reference lists '{name}' as {kind} "
                        f"but the writer registers a "
                        f"{uni.metrics[name]['kind']}", rpath, line)
        # prose references feed dead-counter liveness only: dotted
        # tokens in running text are as often Python API paths
        # (`obs.latency.render_text`) as counters, so only the
        # *tables* are held to the inventory

    return diags


# ---------------------------------------------------------------------------
# entry points: lint_paths pass, fixture mode, repo mode
# ---------------------------------------------------------------------------

def _find_pkg_root(sources: Dict[str, str]) -> Optional[str]:
    """The port's package root, iff the scanned set covers the full
    serving/obs surface (all sentinels present)."""
    norm = {os.path.normpath(os.path.abspath(p)): p for p in sources}
    roots: Set[str] = set()
    for sentinel in _SENTINELS:
        tail = os.path.normpath(os.path.join(PACKAGE, sentinel))
        hits = [p for p in norm if p.endswith(os.sep + tail)]
        if not hits:
            return None
        roots.add(hits[0][: -len(os.sep + tail)])
    if len(roots) != 1:
        return None
    return os.path.join(roots.pop(), PACKAGE)


def _rule_universe() -> Set[str]:
    """Every rule id the port's CLI runs (the reference's jit-only and
    jaxpr ids are not among them: its CLI rejects those)."""
    from fastconsensus_tpu_torch.analysis.astlint import ASTLINT_RULES
    from fastconsensus_tpu_torch.analysis.concurrency import \
        CONCURRENCY_RULES
    from fastconsensus_tpu_torch.analysis.cost import COST_RULES
    from fastconsensus_tpu_torch.analysis.faults import FAULT_RULES
    from fastconsensus_tpu_torch.analysis.footprint import FOOTPRINT_RULES

    return set(ASTLINT_RULES) | set(CONCURRENCY_RULES) | \
        set(FOOTPRINT_RULES) | set(CONTRACT_RULES) | \
        set(FAULT_RULES) | set(COST_RULES)


def _readme_section(src: str) -> Tuple[str, int]:
    """The port's README section (its heading to the next ``## ``) and
    the 1-based line its heading is on; ("", 1) when it is missing."""
    lines = src.splitlines()
    for i, line in enumerate(lines):
        if line.startswith(README_SECTION):
            j = i + 1
            while j < len(lines) and not lines[j].startswith("## "):
                j += 1
            return "\n".join(lines[i:j]), i + 1
    return "", 1


def _read(path: str) -> Optional[str]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def build_universe(sources: Dict[str, str],
                   pkg_root: str) -> Universe:
    """Assemble the repo-wide contract universe from the scanned
    package sources plus the surfaces outside the package (bench.py,
    chip_smoke.py, README.md) and COUNTERS.md, read from disk."""
    repo_root = os.path.dirname(pkg_root)
    uni = Universe()
    uni.rule_universe = _rule_universe()

    client_tail = os.path.normpath(os.path.join("serve", "client.py"))
    history_tail = os.path.normpath(os.path.join("obs", "history.py"))
    report_tail = os.path.normpath(os.path.join("obs", "bench_report.py"))
    pkg_prefix = os.path.normpath(pkg_root) + os.sep
    for path, src in sorted(sources.items()):
        ap = os.path.normpath(os.path.abspath(path))
        if not ap.startswith(pkg_prefix):
            continue  # fixtures or stray files riding the same scan
        facts = _scan_module(path, src)
        if facts is None:
            continue
        if ap.endswith(os.sep + client_tail):
            uni.add_reads(facts, "client")
            # the client also *writes* the request payload the server
            # parses (submit bodies), so its dict keys stay in the
            # wire universe — but its emit groups must not anchor the
            # reverse check against its own parsers
            for key, ln in facts.wire_keys.items():
                uni.wire_keys.setdefault(key, f"{facts.path}:{ln}")
            # ...and its own client-side counters (retry hygiene) are
            # real metrics the appendix must document, without letting
            # client payload dicts into the writer wire universe
            uni.add_metric_writers(facts)
        elif ap.endswith(os.sep + history_tail):
            uni.add_writer_facts(facts)
            uni.add_reads(facts, "gate")
        elif ap.endswith(os.sep + report_tail):
            uni.add_reads(facts, "gate")   # the CLI only reads
        else:
            uni.add_writer_facts(facts)
            uni.add_reads(facts, "pkg")

    bench = os.path.join(repo_root, "bench.py")
    src = _read(bench)
    if src is not None:
        facts = _scan_module(bench, src)
        if facts is not None:
            uni.add_writer_facts(facts)
            uni.add_reads(facts, "pkg")
            sources.setdefault(bench, src)

    # the port's probe on the card: the dotted metric names it reads out
    # of /metricsz snapshots and counter deltas (its plain-key reads are
    # of its own structures and the typed payloads the client covers)
    smoke = os.path.join(repo_root, "chip_smoke.py")
    src = _read(smoke)
    if src is not None:
        try:
            tree = ast.parse(src, filename=smoke)
        except SyntaxError:
            tree = None
        if tree is not None:
            seen: Set[Tuple[str, int]] = set()
            for name, line in _python_reads(tree, _module_env(tree)):
                if "." in name and (name, line) not in seen:
                    seen.add((name, line))
                    uni.gate_reads.append((name, smoke, line))
            sources.setdefault(smoke, src)

    readme = os.path.join(repo_root, "README.md")
    src = _read(readme) or ""
    section, first = _readme_section(src)
    facts = _scan_readme(section)
    facts["refs"] = [(n, ln + first - 1) for n, ln in facts["refs"]]
    counters = os.path.join(pkg_root, COUNTERS_DOC)
    csrc = _read(counters) or ""
    cfacts = _scan_readme(csrc)
    uni.readme = dict(cfacts, refs=facts["refs"] + cfacts["refs"],
                      rule_ids=facts["rule_ids"])
    uni.readme_path = readme
    uni.rule_table_line = first
    uni.appendix_path = counters
    sources.setdefault(readme, src)
    sources.setdefault(counters, csrc)
    return uni


def _fixture_universe(path: str, src: str, facts: ModuleFacts
                      ) -> Tuple[Universe, Set[str]]:
    """One fixture file = one self-contained mini-universe.  The
    CONTRACT_SPEC literal supplies what the repo supplies globally:
    which rules to evaluate, README text, the event vocabulary."""
    assert facts.spec is not None
    spec, spec_line = facts.spec
    unknown = set(spec) - {"rules", "readme", "event_kinds"}
    if unknown:
        raise ValueError(
            f"{path}:{spec_line}: unknown CONTRACT_SPEC key(s): "
            f"{', '.join(sorted(unknown))}")
    rules = set(spec.get("rules", CONTRACT_RULES))
    bad = rules - set(CONTRACT_RULES)
    if bad:
        raise ValueError(
            f"{path}:{spec_line}: CONTRACT_SPEC rules {sorted(bad)} "
            f"are not contract rules ({', '.join(sorted(CONTRACT_RULES))})")
    uni = Universe()
    uni.same_file_groups_ok = True
    uni.add_writer_facts(facts)
    uni.add_reads(facts, "gate")
    for cls, (ln, keys) in facts.parsers.items():
        uni.parsers[cls] = (path, ln, keys)
        for k in keys:
            uni.client_reads.append((k, path, ln))
    # a parser's keys are gate reads too in the single-file world;
    # drop the duplicates so each miss fires once, as schema-drift
    parser_keys = {k for _, (_, ks) in facts.parsers.items() for k in ks}
    uni.gate_reads = [(n, p, ln) for n, p, ln in uni.gate_reads
                      if n not in parser_keys]
    if "event_kinds" in spec:
        kinds = spec["event_kinds"]
        if not (isinstance(kinds, (list, tuple))
                and all(isinstance(k, str) for k in kinds)):
            raise ValueError(f"{path}:{spec_line}: CONTRACT_SPEC "
                             f"event_kinds must be a list of strings")
        uni.event_kinds = (list(kinds), path, spec_line)
    if "readme" in spec:
        uni.readme = _scan_readme(str(spec["readme"]))
        uni.readme_path = path
        # fixture doc-drift exercises the counter tables, not the
        # repo's rule-id table
        uni.rule_universe = None
    return uni, rules


def check_contracts(sources: Dict[str, str]
                    ) -> Tuple[List[Diagnostic], int]:
    """The lint_paths pass: fixture mode for every scanned file with a
    ``CONTRACT_SPEC``, repo mode when the scan covers the package's
    serving/obs surface.  Returns (diagnostics, n_suppressed)."""
    diags: List[Diagnostic] = []
    suppressed = 0

    for path, src in sorted(sources.items()):
        if "CONTRACT_SPEC" not in src:
            continue
        facts = _scan_module(path, src)
        if facts is None or facts.spec is None:
            continue
        uni, rules = _fixture_universe(path, src, facts)
        kept, n_sup = apply_pragmas(_check_universe(uni, rules), src)
        diags.extend(kept)
        suppressed += n_sup

    pkg_root = _find_pkg_root(sources)
    if pkg_root is not None:
        # build_universe setdefaults the out-of-package surfaces
        # (bench.py, chip_smoke.py, README, COUNTERS.md) into this copy,
        # so pragma application below sees their text too
        all_sources = dict(sources)
        uni = build_universe(all_sources, pkg_root)
        raw = _check_universe(uni, set(CONTRACT_RULES))
        by_file: Dict[str, List[Diagnostic]] = {}
        for d in raw:
            by_file.setdefault(d.file, []).append(d)
        for fpath, fdiags in sorted(by_file.items()):
            src = all_sources.get(fpath)
            if src is None:
                try:
                    with open(fpath, encoding="utf-8") as fh:
                        src = fh.read()
                except OSError:
                    src = ""
            kept, n_sup = apply_pragmas(fdiags, src)
            diags.extend(kept)
            suppressed += n_sup
    return diags, suppressed


# ---------------------------------------------------------------------------
# inventory artifact, runtime cross-check, README appendix
# ---------------------------------------------------------------------------

def build_inventory(sources: Dict[str, str], pkg_root: str) -> dict:
    """The committed artifact (analysis/contract_inventory.json):
    writer templates, wire keys, event vocabulary and reader sites — the
    static half of the runtime cross-check, and what
    ``bench_report --check`` and COUNTERS.md validate against.  Paths
    are repo-relative so the artifact diffs cleanly."""
    repo_root = os.path.dirname(pkg_root)
    uni = build_universe(dict(sources), pkg_root)

    def rel(path: str) -> str:
        ap = os.path.abspath(path)
        root = os.path.abspath(repo_root) + os.sep
        return ap[len(root):].replace(os.sep, "/") \
            if ap.startswith(root) else path

    metrics = []
    for tpl in sorted(uni.metrics):
        info = uni.metrics[tpl]
        writers = sorted({rel(w.rpartition(":")[0]) + ":" +
                          w.rpartition(":")[2] for w in info["writers"]})
        metrics.append({"name": tpl, "kind": info["kind"],
                        "writers": writers})
    readers = {"gate": sorted({f"{rel(p)}:{ln}:{n}"
                               for n, p, ln in uni.gate_reads}),
               "client": sorted({f"{rel(p)}:{ln}:{n}"
                                 for n, p, ln in uni.client_reads})}
    events = sorted({k for k, _, _ in uni.events})
    vocab = sorted(uni.event_kinds[0]) if uni.event_kinds else []
    return {"tool": INVENTORY_TOOL, "version": INVENTORY_VERSION,
            "rules": sorted(CONTRACT_RULES),
            "metrics": metrics,
            "wire_keys": sorted(uni.wire_keys),
            "events": events,
            "event_vocab": vocab,
            "readers": readers}


def inventory_from_paths(paths: Sequence[str]) -> dict:
    """Walk ``paths`` like lint_paths and build the repo inventory —
    the ``--emit-inventory`` / ``--emit-appendix`` CLI entry."""
    sources: Dict[str, str] = {}
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", "build"))
                for f in sorted(names):
                    if f.endswith(".py"):
                        fp = os.path.join(root, f)
                        with open(fp, encoding="utf-8") as fh:
                            sources[fp] = fh.read()
        elif p.endswith(".py") and os.path.isfile(p):
            with open(p, encoding="utf-8") as fh:
                sources[p] = fh.read()
    pkg_root = _find_pkg_root(sources)
    if pkg_root is None:
        raise ValueError(
            "--emit-inventory needs a scan covering the package's "
            f"serving/obs surface (scan {PACKAGE}/)")
    return build_inventory(sources, pkg_root)


def load_inventory(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        inv = json.load(fh)
    if inv.get("tool") != INVENTORY_TOOL:
        raise ValueError(f"{path} is not a {INVENTORY_TOOL} inventory "
                         f"(tool={inv.get('tool')!r})")
    return inv


def _observed_names(snapshot: Any) -> List[str]:
    """Metric names out of a live ``/metricsz`` payload (or any fcobs
    registry snapshot), or pass a plain iterable of names through."""
    if isinstance(snapshot, dict):
        fcobs = snapshot.get("fcobs", snapshot)
        names: List[str] = []
        for block in ("counters", "gauges", "series"):
            sub = fcobs.get(block)
            if isinstance(sub, dict):
                names.extend(sub)
        lat = snapshot.get("latency")
        if isinstance(lat, dict):
            for h in lat.get("histograms", ()):
                if isinstance(h, dict) and isinstance(h.get("name"), str):
                    names.append(h["name"])
            # arrivals/dispatches are keyed by *bucket* (n64_e96), a
            # dynamic shape vocabulary, not metric names — skipped
        return names
    return [str(n) for n in snapshot]


def uncovered(snapshot: Any, inventory: Any) -> List[str]:
    """Observed metric names the static writer inventory does not
    cover (inventory = dict or artifact path)."""
    if isinstance(inventory, str):
        inventory = load_inventory(inventory)
    templates = [m["name"] for m in inventory.get("metrics", ())]
    wire = set(inventory.get("wire_keys", ()))
    missing = []
    for name in _observed_names(snapshot):
        if "." in name:
            if not _covered(name, templates):
                missing.append(name)
        elif name not in wire and not _covered(name, templates):
            missing.append(name)
    return sorted(set(missing))


def assert_covered(snapshot: Any, inventory: Any) -> int:
    """Runtime cross-check: every live metric name must union cleanly
    with the static writer inventory.  Returns the number of names
    checked; raises AssertionError naming every stray."""
    names = _observed_names(snapshot)
    missing = uncovered(names, inventory)
    if missing:
        raise AssertionError(
            "live metrics not covered by the static writer inventory "
            f"({len(missing)}): {', '.join(missing)} — a writer the "
            "analyzer cannot see, or a stale analysis/"
            "contract_inventory.json (regenerate with --emit-inventory)")
    return len(names)


def phantom_reads_for(path: str, inventory: Any
                      ) -> List[Tuple[str, int]]:
    """The ``bench_report --check`` fast-fail: every ``.get(``/``[``
    key the given gate module reads that the inventory knows no writer
    for.  Loads torch-free (pure ast over the file), and honors the same
    ``# fcheck: ok=phantom-reader`` pragmas as the lint pass."""
    if isinstance(inventory, str):
        inventory = load_inventory(inventory)
    templates = [m["name"] for m in inventory.get("metrics", ())]
    wire = set(inventory.get("wire_keys", ()))
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    tree = ast.parse(src, filename=path)
    raw: List[Diagnostic] = []
    for name, line in _python_reads(tree, _module_env(tree)):
        if "." in name:
            ok = _covered(name, templates)
        else:
            ok = name in wire or _covered(name, templates)
        if not ok:
            raw.append(Diagnostic(rule="phantom-reader", message=name,
                                  file=path, line=line, col=0,
                                  severity="error"))
    kept, _ = apply_pragmas(raw, src)
    return sorted({(d.message, d.line) for d in kept})


def render_counters_appendix(inventory: dict) -> str:
    """The "Counters & series reference" body (between the appendix
    markers), generated from the inventory so doc-drift can hold it to
    the writers."""
    kind_label = {"counter": "counter", "gauge": "gauge",
                  "series": "series", "hist": "histogram",
                  "rate": "rate"}
    lines = ["| name | kind | writers |",
             "|---|---|---|"]
    for m in inventory["metrics"]:
        bases: List[str] = []
        for w in m["writers"]:
            base = w.rsplit(":", 1)[0].rsplit("/", 1)[-1]
            if base not in bases:
                bases.append(base)
        writers = ", ".join(bases[:3])
        if len(bases) > 3:
            writers += f" (+{len(bases) - 3})"
        lines.append(f"| `{m['name']}` | {m['kind']} | {writers} |")
    lines.append("")
    lines.append("Flight-recorder event vocabulary "
                 "(obs/flight.py `EVENT_KINDS`): "
                 + ", ".join(f"`{k}`"
                             for k in inventory.get("event_vocab", ())))
    return "\n".join(lines)


def render_counters_doc(inventory: dict) -> str:
    """The whole of the port's COUNTERS.md: a heading, the appendix
    between its markers, and nothing else to keep in step by hand."""
    return "\n".join([
        "# Counters & series reference",
        "",
        "Every metric the port writes, with its kind and write sites, "
        "generated from",
        "the fcheck-contract writer inventory "
        "(`analysis/contract_inventory.json`).",
        "`doc-drift` holds this file to the writers; regenerate it with",
        f"`{_REGEN_HINT}`.",
        "",
        APPENDIX_BEGIN,
        render_counters_appendix(inventory),
        APPENDIX_END,
        ""])

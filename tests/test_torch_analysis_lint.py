"""The port's AST lint (``fastconsensus_tpu_torch/analysis/astlint.py``):
the four rules of the reference's lint that apply to eager PyTorch,
``key-reuse`` over ``utils/prng.py``'s keys, ``sync-in-loop``,
``f64-dtype`` and ``syntax-error``, on the port's fixtures
(``tests/torch_analysis_fixtures/``), and the port's whole package,
which scans clean under every pass."""

import os

import pytest
import torch

from fastconsensus_tpu_torch.analysis import lint_paths
from fastconsensus_tpu_torch.analysis.astlint import (ASTLINT_RULES,
                                                      lint_source,
                                                      summarize_key_params)

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
PKG = os.path.join(REPO, "fastconsensus_tpu_torch")
HELPERS = os.path.join(FIXTURES, "key_helpers.py")

LINT_CASES = [
    ("bad_key_reuse.py", "ok_key_reuse.py", "key-reuse", [9, 16]),
    ("bad_key_helper.py", "ok_key_helper.py", "key-reuse", [9]),
    ("bad_sync_loop.py", "ok_sync_loop.py", "sync-in-loop", [10, 18, 19]),
    ("bad_f64.py", "ok_f64.py", "f64-dtype", [7, 8, 12]),
]


def _fixture(name):
    # the cross-module helper is scanned beside every key fixture
    paths = [os.path.join(FIXTURES, name)]
    return paths + [HELPERS] if "key" in name else paths


@pytest.mark.parametrize("bad,ok,rule,lines", LINT_CASES,
                         ids=[c[0][4:-3] for c in LINT_CASES])
def test_rule_fires_on_bad_and_not_on_ok(bad, ok, rule, lines):
    diags = lint_paths(_fixture(bad)).diagnostics
    assert [(d.rule, d.line) for d in diags] == [(rule, n) for n in lines], \
        [d.format() for d in diags]
    assert not lint_paths(_fixture(ok)).diagnostics


def test_key_reuse_needs_the_other_module_summary():
    """Without key_helpers.py in the scan, ``noise`` is an unknown callee
    of weight 1 and the two calls still count; with it, the derive-only
    ``fan`` is recognised, so the clean twin stays clean only with the
    helper module scanned."""
    ok = os.path.join(FIXTURES, "ok_key_helper.py")
    alone = lint_paths([ok]).diagnostics
    assert [d.rule for d in alone] == ["key-reuse"], \
        [d.format() for d in alone]
    assert not lint_paths([ok, HELPERS]).diagnostics


def test_key_summaries_of_the_prng_api():
    table = summarize_key_params(
        "from fastconsensus_tpu_torch.utils import prng\n\n\n"
        "def derive(key):\n"
        "    return prng.fold_in(prng.split(key, 2)[0], 3)\n\n\n"
        "def one(key):\n"
        "    return prng.randint(key, (2,), 0, 9)\n\n\n"
        "def two(key):\n"
        "    a = prng.uniform(key, (2,))\n"
        "    return a + prng.bernoulli(key, 0.5, (2,))\n\n\n"
        "def streams(key):\n"
        "    return prng.stream(key, 1, 2), prng.partition_keys(key, 4)\n")
    assert {k: v["weights"]["key"] for k, v in table.items()} == \
        {"derive": 0, "one": 1, "two": 2, "streams": 0}


def test_key_reuse_ignores_non_prng_split():
    diags, _ = lint_source(
        "def parse(key, line):\n"
        "    a = line.split()\n"
        "    b = line.split(',')\n"
        "    return key, a, b\n")
    assert not diags


def test_sync_in_loop_covers_the_torch_readbacks():
    diags, _ = lint_source(
        "import numpy as np\n"
        "import torch\n\n\n"
        "def f(xs):\n"
        "    out = []\n"
        "    for x in xs:\n"
        "        out.append(x.cpu())\n"
        "        out.append(x.numpy())\n"
        "        out.append(np.asarray(x))\n"
        "        out.append(torch.nonzero(x))\n"
        "    return out\n")
    assert [d.line for d in diags] == [8, 9, 10, 11]
    assert all(d.rule == "sync-in-loop" for d in diags)


def test_f64_message_gives_the_card_reason_and_pragma_counts():
    diags, suppressed = lint_source(
        "import torch\n\n\n"
        "def f(w):\n"
        "    # fcheck: ok=f64-dtype (exact integer sums)\n"
        "    a = w.double().sum()\n"
        "    return a, w.to(torch.float64)\n")
    assert suppressed == 1 and [d.line for d in diags] == [7]
    assert "H100" in diags[0].message and "twice the bytes" in \
        diags[0].message


def test_numpy_float64_is_host_side_and_not_flagged():
    diags, _ = lint_source(
        "import numpy as np\n\n\n"
        "def f(x):\n"
        "    return np.zeros(3, dtype=np.float64) + x.astype(np.float64)\n")
    assert not diags


def test_syntax_error_is_reported():
    diags = lint_paths([os.path.join(FIXTURES, "bad_syntax.py")]).diagnostics
    assert [(d.rule, d.line) for d in diags] == [("syntax-error", 4)]


def test_fixture_directory_names_every_source_rule():
    """The whole fixture directory fires each of the 4 lint, 5
    concurrency and 4 fault rules."""
    from fastconsensus_tpu_torch.analysis.concurrency import \
        CONCURRENCY_RULES
    from fastconsensus_tpu_torch.analysis.faults import FAULT_RULES

    rules = {d.rule for d in lint_paths([FIXTURES]).diagnostics}
    assert rules == set(ASTLINT_RULES) | set(CONCURRENCY_RULES) | \
        set(FAULT_RULES)


def test_the_package_scans_clean():
    report = lint_paths([PKG])
    assert not report.diagnostics, [d.format() for d in report.diagnostics]
    assert report.n_files > 50 and report.n_suppressed > 0


def test_the_deliberate_syncs_carry_their_pragmas():
    """The Louvain and LPM exit tests sync once a sweep on purpose; the
    pragma sits on the line above each."""
    for rel, text in (("models/louvain.py", "act = torch.nonzero(n_want >= "
                                            "stop_at)"),
                      ("models/lpm.py", "act = torch.nonzero(n_want > 0)")):
        with open(os.path.join(PKG, rel), encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        at = next(i for i, ln in enumerate(lines) if text in ln)
        above = "\n".join(lines[max(0, at - 3):at])
        assert "fcheck: ok=sync-in-loop" in above, rel

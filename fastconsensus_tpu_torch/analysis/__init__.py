"""The port's fcheck, the share of the reference's
``fastconsensus_tpu/analysis`` that applies to it
(``python -m fastconsensus_tpu_torch.analysis``):

* **analysis/astlint.py** — the AST lint rules that apply to eager
  PyTorch: ``key-reuse`` over ``utils/prng.py``'s keys (cross-module,
  through :func:`astlint.summarize_key_params`), ``sync-in-loop``,
  ``f64-dtype`` and ``syntax-error``;
* **analysis/concurrency.py** — the whole-program race and
  lock-discipline pass over the serving stack's threads
  (``guarded-field``, ``lock-order``, ``blocking-under-lock``,
  ``notify-outside-lock``, ``unguarded-root-write``), with the static
  lock graph;
* **analysis/lockorder.py** — its runtime half: ``recording()`` wraps
  the locks the port's tree creates and records the observed
  acquisition digraph, which must stay acyclic in union with the static
  graph;
* **analysis/faults.py** — exception flow and resource lifecycle
  (``escape-thread-root``, ``swallowed-error``,
  ``unmapped-http-error``, ``resource-leak``) and the injection-site
  inventory of ``serve/`` (``analysis/fault_inventory.json``, which
  ``serve/faultinject.py`` arms);
* **analysis/footprint.py** — the bucket ladder's geometry (``grid_up``,
  the class floors, the batch rungs: the one definition ``sizing``, the
  bucketer and the fleet router's route keys import, torch-free), the
  ``surface-count`` and ``padding-waste`` rules, and the ``peak-bytes``
  rule with ``derive_chip_ceiling``, behind ``serve --chip-max-edges
  auto`` / ``--hbm-bytes``;
* **analysis/entrypoints.py** — the device-memory model of each serving
  kind, the counterpart of the reference's serving-executable tracer;
* **analysis/cost.py** — the torch-free cost mirror, the priors the
  shaper and the scheduler read, and the cost rules;
* **analysis/contracts.py** — the name-contract pass
  (``phantom-reader``, ``schema-drift``, ``dead-counter``,
  ``event-vocab``, ``doc-drift``) over the metric names and wire keys
  the package writes and its gates, typed client, ``chip_smoke.py`` and
  docs read; its inventory (``analysis/contract_inventory.json``) backs
  the live ``/metricsz`` cross-check (``contracts.assert_covered``) and
  ``COUNTERS.md``;
* **analysis/diagnostics.py** — the reference's ``Diagnostic`` and
  report, unchanged;
* **analysis/recompile_guard.py** — :class:`CompileGuard`, counting the
  builds the port really runs (an ``nvcc`` build of a CUDA kernel, the
  ``g++`` build of the host C++ library) on the thread that runs them.

The reference's jit-only lint rules and its jaxpr audit have no
counterpart in eager PyTorch.
"""

__all__ = ["CompileGuard", "RecompileError", "assert_max_compiles",
           "Diagnostic", "Report", "lint_paths"]


def __getattr__(name):
    # lazy: the kernel builders import recompile_guard at their top, and
    # this package must cost them nothing more
    if name in ("CompileGuard", "RecompileError", "assert_max_compiles"):
        from fastconsensus_tpu_torch.analysis import recompile_guard

        return getattr(recompile_guard, name)
    if name in ("Diagnostic", "Report"):
        from fastconsensus_tpu_torch.analysis import diagnostics

        return getattr(diagnostics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _module_name(path):
    """Dotted module name of a scanned file, for the cross-module tables
    (key summaries, lock keys, raise sets): everything from the
    ``fastconsensus_tpu_torch`` package root down when the file lives
    inside it, the bare stem otherwise (fixtures and scripts import each
    other by stem, if at all)."""
    import os

    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    name = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if "fastconsensus_tpu_torch" in parts[:-1]:
        i = parts.index("fastconsensus_tpu_torch")
        mods = parts[i:-1] + ([] if name == "__init__" else [name])
        return ".".join(mods)
    return name


def read_sources(paths):
    """``{file: source}`` of every ``.py`` under ``paths`` (files or
    directories), in walk order."""
    from fastconsensus_tpu_torch.analysis.footprint import source_files

    sources = {}
    for f in source_files(paths):
        with open(f, encoding="utf-8") as fh:
            sources[f] = fh.read()
    return sources


def lint_paths(paths, report=None):
    """Lint every ``.py`` under ``paths`` (files or directories) into a
    Report (created if not given).

    Five passes, as the reference's: the first summarizes every
    function's PRNG-key consumption (astlint.summarize_key_params), the
    second lints with that table in hand (so ``key-reuse`` tracks keys
    through helper calls across module boundaries), then the
    whole-program concurrency, fault and name-contract passes run over
    the same source set (the contract pass in repo mode when the set
    covers the package's serving/obs surface, in fixture mode on every
    file with a ``CONTRACT_SPEC``)."""
    from fastconsensus_tpu_torch.analysis.astlint import (
        lint_source, summarize_key_params)
    from fastconsensus_tpu_torch.analysis.concurrency import \
        check_concurrency
    from fastconsensus_tpu_torch.analysis.contracts import check_contracts
    from fastconsensus_tpu_torch.analysis.diagnostics import Report
    from fastconsensus_tpu_torch.analysis.faults import check_faults

    if report is None:
        report = Report()
    sources = read_sources(paths)
    summaries = {}
    for f, src in sources.items():
        table = summarize_key_params(src, filename=f)
        if table:
            # first writer wins on a (pathological) duplicate module
            # name; identical files produce identical tables anyway
            summaries.setdefault(_module_name(f), table)
    for f, src in sources.items():
        diags, suppressed = lint_source(src, filename=f,
                                        key_summaries=summaries)
        report.extend(diags)
        report.n_suppressed += suppressed
        report.n_files += 1
    for check in (check_concurrency, check_faults, check_contracts):
        diags, suppressed = check(sources)
        report.extend(diags)
        report.n_suppressed += suppressed
    return report

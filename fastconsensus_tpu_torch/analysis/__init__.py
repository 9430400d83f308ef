"""The port's fcheck, the share of the reference's
``fastconsensus_tpu/analysis`` that applies to it
(``python -m fastconsensus_tpu_torch.analysis``):

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
* **analysis/diagnostics.py** — the reference's ``Diagnostic`` and
  report, unchanged;
* **analysis/recompile_guard.py** — :class:`CompileGuard`, counting the
  builds the port really runs (an ``nvcc`` build of a CUDA kernel, the
  ``g++`` build of the host C++ library) on the thread that runs them.

Not ported yet (ROADMAP.md, Queue 1 item 4): the AST lint, the
concurrency and lock-order passes, fault flow and name contracts.  The
jaxpr audit has no counterpart in eager PyTorch.
"""

__all__ = ["CompileGuard", "RecompileError", "assert_max_compiles"]


def __getattr__(name):
    # lazy: the kernel builders import recompile_guard at their top, and
    # this package must cost them nothing more
    if name in __all__:
        from fastconsensus_tpu_torch.analysis import recompile_guard

        return getattr(recompile_guard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Runtime analysis helpers of the port, the serving tier's share of the
reference's ``fastconsensus_tpu/analysis``:

* **analysis/recompile_guard.py** — :class:`CompileGuard`, counting the
  builds the port really runs (an ``nvcc`` build of a CUDA kernel, the
  ``g++`` build of the host C++ library) on the thread that runs them;
* **analysis/cost.py** — the torch-free cost mirror the serving tier's
  shaper and scheduler take their cold-start priors from;
* **analysis/footprint.py** — the torch-free definition of the bucket
  ladder's geometry (``grid_up``, the class floors, the batch rungs),
  which ``sizing``, the bucketer and the fleet router's route keys all
  import.  The rest of the reference's footprint pass, the device-memory
  model behind ``--hbm-bytes``, is not ported yet.

The static passes of the reference (AST lint, the jaxpr audit, the
concurrency models, fault flow, name contracts) are not ported.
"""

__all__ = ["CompileGuard", "RecompileError", "assert_max_compiles"]


def __getattr__(name):
    # lazy: the kernel builders import recompile_guard at their top, and
    # this package must cost them nothing more
    if name in __all__:
        from fastconsensus_tpu_torch.analysis import recompile_guard

        return getattr(recompile_guard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

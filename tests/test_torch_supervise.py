"""The reference's supervisor cases (``tests/test_supervise.py``) run
against the port's copy, ``fastconsensus_tpu_torch/utils/supervise.py``:
restart on failure, the stall kill, and the rotated telemetry chain."""

import types
from pathlib import Path

import pytest
import torch

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parent / "test_supervise.py"


def port_cases() -> types.ModuleType:
    """``tests/test_supervise.py`` with the package renamed to the port's."""
    mod = types.ModuleType("port_test_supervise")
    mod.__file__ = str(REFERENCE)
    src = REFERENCE.read_text().replace("fastconsensus_tpu",
                                        "fastconsensus_tpu_torch")
    exec(compile(src, str(REFERENCE), "exec"), mod.__dict__)
    return mod


CASES = ("test_success_passes_through", "test_retry_until_success",
         "test_rotation_chains_telemetry_across_restarts",
         "test_rotation_cli_flag_parses", "test_stall_kill_and_give_up")


def test_cases_are_the_references():
    assert sorted(CASES) == sorted(
        n for n in vars(port_cases()) if n.startswith("test_"))


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, tmp_path):
    mod = port_cases()
    assert mod.run_supervised.__module__ == \
        "fastconsensus_tpu_torch.utils.supervise"
    getattr(mod, case)(tmp_path)

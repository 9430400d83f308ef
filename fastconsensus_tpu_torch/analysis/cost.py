"""The serving tier's cost priors: the torch-free part of the reference's
``fastconsensus_tpu/analysis/cost.py`` that the shaper and the scheduler
call (``MachineModel``, ``mirror_cost``, ``mirror_est_s``,
``parse_bucket_key``, ``static_service_prior``, ``spill_weight``), with
the reference's coefficients and constants unchanged.

**These priors are not the H100's.**  The mirror is a closed-form fit of
the reference's traced jaxpr cost visitor over the bucket ladder, and
the default :class:`MachineModel` is the reference's envelope of a CPU
CI host (4e11 FLOP/s, 4e11 B/s, 0.5 ms dispatch).  They are kept as they
are so that routing (``serve/scheduler.py``) and shaping
(``serve/shaping.py``) decide exactly as the reference's: a cold bucket's
first Retry-After and shed decisions, and the spill weight of a queued
bucket, come out the same in both packages.  A prior calibrated for the
card, with the jaxpr visitor's counterpart over the port's own sweeps,
is future work; ``chip_smoke.py`` phase ``serve`` prints each bucket's
prior beside the device seconds the card measured.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

# MATMUL_MAX_N: the matmul/hash detection-path flip the mirror's regimes
# split at
from fastconsensus_tpu_torch.analysis.footprint import MATMUL_MAX_N

# The reference's effective envelope of its CPU CI host (sustained
# FLOP/s, bytes/s, per-executable dispatch cost).
PEAK_FLOPS_DEFAULT = 4.0e11
HBM_BW_DEFAULT = 4.0e11
DISPATCH_OVERHEAD_S_DEFAULT = 5.0e-4


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Roofline envelope: time = max(compute, traffic) + dispatch."""

    peak_flops: float = PEAK_FLOPS_DEFAULT
    hbm_bytes_per_s: float = HBM_BW_DEFAULT
    dispatch_overhead_s: float = DISPATCH_OVERHEAD_S_DEFAULT

    def est_device_s(self, flops: float, hbm_bytes: float) -> float:
        return max(flops / self.peak_flops,
                   hbm_bytes / self.hbm_bytes_per_s) \
            + self.dispatch_overhead_s


# The reference's least-squares fits of its traced visitor over the
# ladder, per kind and detection-path regime (matmul: n <= MATMUL_MAX_N;
# hash above), each linear in ensemble width n_p and batch rung b.
# rounds block, matmul regime: per-n_p flops ~ c3*n^3 + c2*n^2 + ce*e
_ROUNDS_MM_F = (2046.0, 19500.0, 1600.0)
# ...bytes ~ d2*n^2 + dn*n + de*e
_ROUNDS_MM_B = (2.37e5, 6.0e5, 2.55e5)
# rounds block, hash regime: per-n_p flops ~ fn*n + fe*e
_ROUNDS_HASH_F = (9.1e4, 3.48e5)
_ROUNDS_HASH_B = (1.32e6, 6.54e6)
# final detect, matmul regime: per-n_p flops ~ c3*n^3 + c2*n^2
_DETECT_MM_F = (64.0, 610.0)
_DETECT_MM_B = (7400.0, 2.5e4)
_DETECT_HASH_F = (2.4e3, 1.1e4)
_DETECT_HASH_B = (4.5e4, 2.0e5)
# tail merge: ~ (n + e) with a weak ensemble-width term
_TAIL_F = 300.0
_TAIL_B = 6000.0


def _mirror_rounds(n: int, e: int) -> Tuple[float, float]:
    if n <= MATMUL_MAX_N:
        c3, c2, ce = _ROUNDS_MM_F
        d2, dn, de = _ROUNDS_MM_B
        return (c3 * n ** 3 + c2 * n ** 2 + ce * e,
                d2 * n ** 2 + dn * n + de * e)
    fn, fe = _ROUNDS_HASH_F
    bn, be = _ROUNDS_HASH_B
    return (fn * n + fe * e, bn * n + be * e)


def _mirror_detect(n: int, e: int) -> Tuple[float, float]:
    if n <= MATMUL_MAX_N:
        c3, c2 = _DETECT_MM_F
        d2, dn = _DETECT_MM_B
        return (c3 * n ** 3 + c2 * n ** 2, d2 * n ** 2 + dn * n)
    fn, fe = _DETECT_HASH_F
    bn, be = _DETECT_HASH_B
    return (fn * n + fe * e, bn * n + be * e)


def mirror_cost(kind: str, n_class: int, e_class: int, b: int = 1,
                n_p: int = 20) -> Dict[str, float]:
    """{flops, hbm_bytes} of one surface kind (``rounds``/``batch``,
    ``detect``/``detect-batch``, ``tail``; a ``[mode]`` suffix is
    ignored) at one bucket, as the reference's mirror prices it."""
    base = kind.split("[", 1)[0]
    n, e = int(n_class), int(e_class)
    npp, bb = max(int(n_p), 1), max(int(b), 1)
    if base in ("rounds", "batch"):
        f, by = _mirror_rounds(n, e)
        return {"flops": f * npp * bb, "hbm_bytes": by * npp * bb}
    if base in ("detect", "detect-batch"):
        f, by = _mirror_detect(n, e)
        return {"flops": f * npp * bb, "hbm_bytes": by * npp * bb}
    if base == "tail":
        scale = (n + e) * (1.0 + npp / 16.0)
        return {"flops": _TAIL_F * scale, "hbm_bytes": _TAIL_B * scale}
    raise ValueError(f"unknown surface kind {kind!r}")


def mirror_est_s(kind: str, n_class: int, e_class: int, b: int = 1,
                 n_p: int = 20,
                 machine: Optional[MachineModel] = None) -> float:
    """Roofline seconds of one surface kind at one bucket."""
    m = machine or MachineModel()
    c = mirror_cost(kind, n_class, e_class, b=b, n_p=n_p)
    return m.est_device_s(c["flops"], c["hbm_bytes"])


_BUCKET_KEY_RE = re.compile(r"^n(\d+)_e(\d+)$")

# One backlog unit of the spill weighting = a job this long; weights are
# clamped to [1, SPILL_WEIGHT_MAX].
SPILL_COST_UNIT_S = 1.0
SPILL_WEIGHT_MAX = 16.0


def parse_bucket_key(bucket_key: str) -> Optional[Tuple[int, int]]:
    """``"n64_e96" -> (64, 96)``; None for anything unparseable."""
    m = _BUCKET_KEY_RE.match(str(bucket_key or ""))
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


def static_service_prior(bucket_key: str, n_p: int = 20,
                         algorithm: str = "louvain",
                         machine: Optional[MachineModel] = None
                         ) -> Optional[float]:
    """Cold-start device-seconds prior of one bucket: the mirrored
    roofline estimate of its solo rounds (None when the key is not a
    ladder bucket).  ``algorithm`` is accepted for signature parity; the
    mirror prices the Louvain family either way."""
    parsed = parse_bucket_key(bucket_key)
    if parsed is None:
        return None
    n, e = parsed
    return mirror_est_s("rounds", n, e, b=1, n_p=n_p, machine=machine)


def spill_weight(bucket_key: str, n_p: int = 20) -> float:
    """StickyScheduler backlog weight: a queued job of this bucket counts
    as ``prior / SPILL_COST_UNIT_S`` backlog units, clamped to
    [1, SPILL_WEIGHT_MAX]."""
    prior = static_service_prior(bucket_key, n_p=n_p)
    if prior is None:
        return 1.0
    return min(max(prior / SPILL_COST_UNIT_S, 1.0), SPILL_WEIGHT_MAX)

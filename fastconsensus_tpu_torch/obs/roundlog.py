"""fcobs round log: the reference's ``obs/roundlog.py`` without its
``phase_span``, which nothing in the port calls.

:class:`RoundLog` is an ``on_round`` hook keeping per-round records,
logging, and an optional JSONL sidecar, and marks each round as an
instant on the ambient span tracer (visible in ``--trace`` Perfetto
output).
"""

from __future__ import annotations

import json
import logging
# fcheck: ok=sync-in-loop (host wall-clock reads for round timing; no
# device values involved)
import time
from typing import Dict, List, Optional

from fastconsensus_tpu_torch.obs.tracer import get_tracer

logger = logging.getLogger("fastconsensus_tpu_torch")


class RoundLog:
    """Per-round stats collector; pass ``log.on_round`` to run_consensus.

    Keeps machine-readable ``records`` (the round entry + round/elapsed
    seconds), logs one line per round, optionally appends each record to
    ``jsonl_path`` (the progress file long-run supervision watches), and
    drops an instant marker on the ambient fcobs tracer so a ``--trace``
    timeline shows the host-observed round boundaries.
    """

    def __init__(self, log_level: int = logging.INFO,
                 jsonl_path: Optional[str] = None):
        self.records: List[dict] = []
        self._level = log_level
        self._jsonl_path = jsonl_path
        self._t0 = time.perf_counter()
        self._last = self._t0

    def on_round(self, entry: Dict) -> None:
        now = time.perf_counter()
        rec = dict(entry)
        rec["round_seconds"] = round(now - self._last, 4)
        rec["elapsed_seconds"] = round(now - self._t0, 4)
        self._last = now
        self.records.append(rec)
        frac = (rec["n_unconverged"] / rec["n_alive"]
                if rec["n_alive"] else 0.0)
        logger.log(self._level,
                   "round %d: %d edges alive, %d unconverged (%.1f%%), "
                   "+%d closure, +%d repaired, %d dropped [%.2fs]",
                   rec["round"], rec["n_alive"], rec["n_unconverged"],
                   100.0 * frac, rec["n_closure_added"], rec["n_repaired"],
                   rec["n_dropped"], rec["round_seconds"])
        get_tracer().instant("round_stats", round=rec["round"],
                             n_alive=rec["n_alive"],
                             n_unconverged=rec["n_unconverged"])
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")


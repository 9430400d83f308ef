"""Checkpoint / resume for the consensus loop.

Counterpart of ``fastconsensus_tpu/utils/checkpoint.py``, in the same file
format, so a checkpoint written by either package resumes in the other.
The whole mutable state of a run is the slab, the round counter, the root
PRNG key and (warm runs) the last round's labels.  One ``.npz``, written
atomically (temporary file, then rename):

* ``src``, ``dst`` int32, ``weight`` float32, ``alive`` bool — the slab
  (the port holds indices as int64 and casts on save and on load);
* ``key_data`` uint32[2] — the run key's words;
* ``labels`` int32[n_p, N] — optional, the last round's labels;
* ``meta`` — JSON as uint8 bytes: format version, node count, the slab's
  static sizing, rounds done, the round history and ``extra`` (the run
  configuration that `run_consensus` checks on resume).

Version 2 carries ``d_hyb``/``hub_cap``; version 1 files still load and
are marked ``extra["_legacy_v1"]`` so `run_consensus` restores that sizing
from the caller's fresh pack.  An optional ``telemetry`` block holds the
run's fcobs counter totals (``obs/counters.py``), written by either
package and surfaced as ``extra["_telemetry"]``; a resumed run restores
them, so its counters stay cumulative across restarts.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.utils.env import resolve_device

_FORMAT_VERSION = 2


def save_checkpoint(path: str, slab: GraphSlab, rounds_done: int,
                    key_data: np.ndarray, history: List[dict],
                    extra: Optional[Dict[str, Any]] = None,
                    labels: Optional[torch.Tensor] = None,
                    telemetry: Optional[Dict[str, int]] = None) -> None:
    """Atomically persist the consensus state after a round.
    ``telemetry``: the run's fcobs counter totals (counters only: series
    percentiles cannot be merged across processes)."""
    meta = {
        "version": _FORMAT_VERSION,
        "n_nodes": int(slab.n_nodes),
        "d_cap": int(slab.d_cap),
        "cap_hint": int(slab.cap_hint),
        "d_hyb": int(slab.d_hyb),
        "hub_cap": int(slab.hub_cap),
        "agg_cap": int(slab.agg_cap),
        "rounds_done": int(rounds_done),
        "history": history,
        "extra": extra or {},
    }
    if telemetry:
        meta["telemetry"] = {k: int(v) for k, v in telemetry.items()}
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")

    def host(t: torch.Tensor, dtype) -> np.ndarray:
        return t.detach().cpu().numpy().astype(dtype)

    arrays = dict(src=host(slab.src, np.int32),
                  dst=host(slab.dst, np.int32),
                  weight=host(slab.weight, np.float32),
                  alive=host(slab.alive, bool),
                  key_data=np.asarray(key_data, dtype=np.uint32),
                  meta=np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8))
    if labels is not None:
        arrays["labels"] = host(labels, np.int32)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, device=None
                    ) -> Tuple[GraphSlab, int, np.ndarray, List[dict],
                               Dict[str, Any]]:
    """Load ``(slab, rounds_done, key_data, history, extra)``; the slab
    lands on ``device`` (default CUDA, see ``utils.env.resolve_device``)
    and saved labels come back as ``extra["_labels"]`` (int64 tensor on
    the same device)."""
    dev = resolve_device(device)

    def put(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(a.astype(dtype), device=dev)

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") not in (1, _FORMAT_VERSION):
            raise ValueError(f"{path}: unsupported checkpoint version "
                             f"{meta.get('version')}")
        slab = GraphSlab(src=put(z["src"], np.int64),
                         dst=put(z["dst"], np.int64),
                         weight=put(z["weight"], np.float32),
                         alive=put(z["alive"], bool),
                         n_nodes=int(meta["n_nodes"]),
                         d_cap=int(meta.get("d_cap", 0)),
                         cap_hint=int(meta.get("cap_hint", 0)),
                         d_hyb=int(meta.get("d_hyb", 0)),
                         hub_cap=int(meta.get("hub_cap", 0)),
                         # absent before the aggregate compaction existed:
                         # 0 keeps the lowering the run started with
                         agg_cap=int(meta.get("agg_cap", 0)))
        extra = dict(meta["extra"])
        if meta.get("version") == 1:
            extra["_legacy_v1"] = True
        if meta.get("telemetry"):
            extra["_telemetry"] = dict(meta["telemetry"])
        if "labels" in z.files:
            extra["_labels"] = put(z["labels"], np.int64)
        return (slab, int(meta["rounds_done"]), z["key_data"].copy(),
                list(meta["history"]), extra)

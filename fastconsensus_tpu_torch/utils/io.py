"""Host-side I/O boundary: edgelist parsing and partition writers.

A copy of the reference's ``utils/io.py``: the host C++ parser
(``native.parse_edgelist``) reads the file when the library is already
loaded (a CNM or Infomap run loads it before reading its input), the
pure-Python parser otherwise and on any line the fast parser rejects (its
errors name the line).  Both accept the same files.  Reading builds
nothing: a device-only run needs no host compiler.

Mirrors the reference's file formats while fixing its ingest bugs:

* the reference crashes on the 3-column weighted format its own README
  documents (``nx.read_edgelist(..., nodetype=int)`` literal-evals column 3,
  reference ``fast_consensus.py:434``) — here both 2- and 3-column files
  parse; input weights are accepted but, like the reference, overwritten with
  1.0 at the start of the consensus loop (``fast_consensus.py:135-136``);
* the reference requires 0-indexed contiguous ids (relabeling commented out at
  ``fast_consensus.py:435-436``) — here arbitrary integer ids are compacted
  and original ids restored on output.

Output formats (reference ``fast_consensus.py:440-466``):

* ``out_partitions_t{t}_d{d}_np{np}/{i}`` — one community per line,
  space-separated original node ids;
* ``memberships_t{t}_d{d}_np{np}/{i}`` — ``node\tcommunity`` lines in
  1-indexed *compact* ids (the reference requires 0-indexed input and writes
  ``id + 1``, fc:450-455; with compact ids this reproduces it exactly on
  every input the reference accepts, and stays well-defined for arbitrary
  ids).  The reference only writes memberships for louvain; we write them for
  every algorithm, as merged_consensus.py:319-328 does.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_edgelist(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Parse an edgelist file.

    Accepts lines ``u v`` or ``u v w``; ``#`` comments and blank lines are
    skipped.  Node ids may be arbitrary (possibly sparse) integers.

    Returns ``(edges, weights, original_ids)`` where ``edges`` is int64[E, 2]
    in compact 0-based ids, ``weights`` is float32[E] or None if the file had
    no weight column, and ``original_ids[i]`` is the input id of compact
    node ``i`` (sorted ascending).
    """
    from fastconsensus_tpu_torch import native

    if native.loaded():
        try:
            u64, v64, w64 = native.parse_edgelist(path)
        except ValueError:
            u64 = None   # re-read below: the Python errors name the line
        if u64 is not None and u64.shape[0] > 0:
            return _compact(u64, v64,
                            None if w64 is None else w64.astype(np.float32))
    return read_edgelist_python(path)


def read_edgelist_python(path: str
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    np.ndarray]:
    """:func:`read_edgelist` in pure Python; its errors name the line."""
    us: List[int] = []
    vs: List[int] = []
    ws: List[float] = []
    saw_weight = False
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"{path}:{ln}: expected 'u v [w]', got {line!r}")
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
            if len(parts) >= 3:
                saw_weight = True
                ws.append(float(parts[2]))
            else:
                ws.append(1.0)
    if not us:
        raise ValueError(f"{path}: empty edgelist")
    return _compact(np.asarray(us, dtype=np.int64),
                    np.asarray(vs, dtype=np.int64),
                    np.asarray(ws, dtype=np.float32) if saw_weight else None)


def _compact(u: np.ndarray, v: np.ndarray, weights: Optional[np.ndarray]
             ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Compact arbitrary integer ids to 0..N-1 (sorted ascending)."""
    original_ids, inverse = np.unique(np.concatenate([u, v]),
                                      return_inverse=True)
    edges = np.stack([inverse[:u.shape[0]], inverse[u.shape[0]:]], axis=1)
    return edges.astype(np.int64), weights, original_ids


def labels_to_communities(labels: np.ndarray) -> List[List[int]]:
    """Group a membership vector into a list of communities.

    Communities are ordered by their smallest member; members ascending.
    (Reference ``group_to_partition``, fast_consensus.py:55-71, keyed by
    first-seen order — ordering is cosmetic, contents identical.)
    """
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
    groups = np.split(order, boundaries)
    groups.sort(key=lambda g: int(g.min()))
    return [sorted(int(x) for x in g) for g in groups]


def write_partition_dirs(out_dir: str,
                         memberships_dir: str,
                         partitions: Sequence[np.ndarray],
                         original_ids: np.ndarray,
                         one_indexed_memberships: bool = True) -> None:
    """Write the reference's two output trees for a list of label vectors."""
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(memberships_dir, exist_ok=True)
    original_ids = np.asarray(original_ids)
    for i, labels in enumerate(partitions, start=1):
        # fcheck: ok=sync-in-loop (each partition is a distinct array; the
        # per-file host write IS the loop body)
        labels = np.asarray(labels)
        with open(os.path.join(out_dir, str(i)), "w") as fh:
            for comm in labels_to_communities(labels):
                fh.write(" ".join(str(int(original_ids[n])) for n in comm))
                fh.write("\n")
        off = 1 if one_indexed_memberships else 0
        # memberships use compact node ids (+1) — see module docstring
        _, compact = np.unique(labels, return_inverse=True)
        with open(os.path.join(memberships_dir, str(i - 1)), "w") as fh:
            for n in range(labels.shape[0]):
                fh.write(f"{n + off}\t{int(compact[n]) + off}\n")


def read_partition_file(path: str) -> List[List[int]]:
    """Read one out_partitions file back (one community per line)."""
    comms: List[List[int]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                comms.append([int(x) for x in line.split()])
    return comms

"""Whether a run's consensus jobs came out right: the numbers compared.

Inputs, all made by the benchmark or read from the program's outputs:

* the configuration's settings (``n_p``, ``tau``, ``delta``,
  ``closure_tau``, ``gamma``, ``max_rounds``): the program is held to
  these, never to the arguments it passed itself;
* each job's input graph as the benchmark made it, the node count and
  wedge-sample count ``L`` its size class gives (worked out by the
  benchmark), and what the program returned: ``rounds``, the final
  ``partitions`` and the consensus graph;
* every tail the program ran while the jobs ran (:class:`Tail`): the
  round's graph and member partitions in, the next graph out.

The reference cannot replay the program's random draws, so it follows
the program round by round from the program's own state and checks each
stage by itself:

* ``tail_faults``: edges of any tail that break fastconsensus's rules
  (``tail.check``), and tails that close more than ``L`` wedges;
* ``chain_faults``: jobs whose returned graph is not reached from their
  own input graph (every weight 1) through their tails in exactly
  ``rounds`` steps, whose tails converge before the last or neither
  converge nor reach ``max_rounds`` at the last, or whose partitions
  have the wrong shape;
* ``cold_round_unsettled`` and ``warm_round_unsettled``: the largest,
  over the cold rounds (detected from singletons) and over the warm ones
  (started from the last round's members), of the mean over the round's
  members of the share of nodes that would gain by a single Louvain move
  on the round's graph (``louvain.unstable_share``): a detection that
  stops short (fewer sweeps than the configuration's Louvain) leaves
  more.  A round is warm where the program's history says so (a job's
  first round is always held as cold; a stagnation refresh re-detects
  cold); a tail on no job's chain (a round replayed after the slab grew)
  is held as cold;
* ``unsettled_answers``: final partitions (the jobs' answers) in which
  more than ``unsettled_share`` of the nodes would gain by a single
  Louvain move: not a Louvain partition of the consensus graph.

Beside them (not compared): ``unstable_share_max``, the largest share of
any answer, and ``round_shares``: the largest share of any one member of
any round, and how many rounds were read as cold and as warm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import louvain, tail

# the numbers compared, each held to the limit of the same name
COMPARED = ("tail_faults", "chain_faults", "cold_round_unsettled",
            "warm_round_unsettled", "unsettled_answers")


@dataclasses.dataclass
class Tail:
    """One tail the program ran, copied to the host."""

    n: int                # the slab's node count
    slab_in: tuple        # (src, dst, weight, alive)
    labels: torch.Tensor  # [members, n]
    slab_out: tuple
    n_dropped: int


@dataclasses.dataclass
class Job:
    """One finished job: its input and what the program returned."""

    edges: np.ndarray
    n_class: int             # the node count its size class gives
    n_closure: int           # the wedge samples L a round may close
    rounds: int
    partitions: np.ndarray   # [n_p, n_class]
    graph: tuple             # (src, dst, weight, alive)
    graph_n: int
    truth: Optional[np.ndarray] = None   # planted labels of the n nodes
    # the program's history: whether each round was detected cold
    cold: Optional[List[bool]] = None


def _edges(slab: tuple, n: int, dev) -> tail.Edges:
    return tail.edges_of(*slab, n, device=dev)


def check(jobs: List[Job], tails: List[Tail], cfg: dict,
          limits: Dict[str, float], device="cpu") -> Dict[str, object]:
    """The numbers compared over every job and tail of a run, with
    ``failed_jobs`` (the jobs whose own chain, tails or answers break a
    rule) and ``notes`` saying what broke."""
    dev = torch.device(device)
    n_p, gamma = int(cfg["n_p"]), float(cfg.get("gamma", 1.0))
    tail_faults = chain_faults = unsettled = failed = 0
    share = member_max = 0.0
    warm_at = set()
    notes: List[str] = []
    by_out: Dict[str, List[int]] = {}
    info = []
    for i, t in enumerate(tails):
        e_in = _edges(t.slab_in, t.n, dev)
        e_out = _edges(t.slab_out, t.n, dev)
        got = tail.check(e_in, t.labels, e_out, n_p, cfg["tau"],
                         cfg["delta"], cfg.get("closure_tau"), t.n_dropped)
        tail_faults += got["faults"]
        if got["faults"]:
            notes.append(f"tail {i}: {got['faults']} faults")
        per = louvain.unstable_share(e_in.u, e_in.v, e_in.w, t.n,
                                     t.labels.to(dev), gamma)
        mean = float(per.mean())
        member_max = max(member_max, float(per.max()))
        info.append((e_in.digest(), got["converged"], got["faults"],
                     got["closed"], mean))
        by_out.setdefault(e_out.digest(), []).append(i)
    for j, job in enumerate(jobs):
        n = job.n_class
        parts = torch.as_tensor(np.asarray(job.partitions, np.int64))
        if parts.shape != (n_p, n) or job.graph_n != n:
            chain_faults += 1
            failed += 1
            notes.append(f"job {j}: partitions {tuple(parts.shape)}, graph "
                         f"of {job.graph_n} nodes, expected {(n_p, n)}")
            continue
        g = _edges(job.graph, n, dev)
        per = louvain.unstable_share(g.u, g.v, g.w, n, parts.to(dev), gamma)
        s = float(per.max())
        share = max(share, s)
        bad = int((per > limits["unsettled_share"]).sum())
        unsettled += bad
        start = tail.edges_from_list(job.edges, n, device=dev).digest()
        # walk back from the returned graph to the job's own input, each
        # step to the latest earlier tail that gave the graph in hand (a
        # tail may give back its own input)
        at, steps, last = g.digest(), [], len(tails)
        while at != start and len(steps) <= job.rounds:
            earlier = [k for k in by_out.get(at, []) if k < last]
            if not earlier:
                break
            last = earlier[-1]
            steps.append(last)
            at = info[last][0]
        ok = at == start and len(steps) == job.rounds
        conv = [info[k][1] for k in reversed(steps)]
        if ok and steps:
            # the stop rule: no converged round before the last, and the
            # last converged or the round budget spent
            ok = not any(conv[:-1]) and (conv[-1] or
                                         job.rounds == int(cfg["max_rounds"]))
        over = sum(1 for k in steps if info[k][3] > job.n_closure)
        tail_faults += over
        chain_faults += 0 if ok else 1
        forward = list(reversed(steps))
        flags = job.cold if job.cold is not None and \
            len(job.cold) == len(forward) else [True] * len(forward)
        warm_at.update(k for r, k in enumerate(forward)
                       if r > 0 and not flags[r])
        means = [info[k][4] for k in forward]
        loose = any(info[k][4] > limits["warm_round_unsettled" if (
            r > 0 and not flags[r]) else "cold_round_unsettled"]
            for r, k in enumerate(forward))
        if not ok or bad or over or loose or \
                any(info[k][2] for k in steps):
            failed += 1
            notes.append(
                f"job {j}: {job.rounds} rounds, {len(steps)} tails back to "
                f"{'its input' if at == start else 'no input of its own'}, "
                f"converged {conv[-3:]} at the last, {over} tails over L, "
                f"rounds' mean unstable shares {means}, "
                f"{bad} unsettled answers, largest unstable share {s!r}")
    return {"tail_faults": float(tail_faults),
            "chain_faults": float(chain_faults),
            "cold_round_unsettled": max(
                (x[4] for k, x in enumerate(info) if k not in warm_at),
                default=0.0),
            "warm_round_unsettled": max(
                (info[k][4] for k in warm_at), default=0.0),
            "unsettled_answers": float(unsettled),
            "unstable_share_max": share,
            "round_shares": {"member_max": member_max,
                             "cold_rounds": len(info) - len(warm_at),
                             "warm_rounds": len(warm_at)},
            "failed_jobs": failed, "notes": notes}

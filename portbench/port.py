"""What the benchmark takes from the program: its public entry points.

Only the PyTorch port (``fastconsensus_tpu_torch``) is imported, and only
at call time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.check import Job


def consensus_config(cfg: dict):
    from fastconsensus_tpu_torch.consensus import ConsensusConfig

    return ConsensusConfig(
        algorithm=cfg["algorithm"], n_p=int(cfg["n_p"]), tau=cfg["tau"],
        delta=cfg["delta"], max_rounds=int(cfg["max_rounds"]),
        gamma=cfg.get("gamma", 1.0), closure_tau=cfg.get("closure_tau"))


def detector(cfg: dict):
    from fastconsensus_tpu_torch.models.registry import get_detector

    return get_detector(cfg["algorithm"], gamma=cfg.get("gamma", 1.0))


def key(seed: int, device):
    from fastconsensus_tpu_torch.utils import prng

    return prng.key(seed, device)


def fresh_copy(slab):
    """The slab with its own device tensors (a job's input)."""
    return dataclasses.replace(slab, src=slab.src.clone(),
                               dst=slab.dst.clone(),
                               weight=slab.weight.clone(),
                               alive=slab.alive.clone())


def finished_job(graph, n_class: int, n_closure: int, res) -> Job:
    """A job's input, with the node count and wedge samples the benchmark
    works out for it, and the program's return value, on the host."""
    g = res.graph
    return Job(edges=graph.edges, n_class=n_class, n_closure=n_closure,
               rounds=int(res.rounds),
               partitions=np.stack([np.asarray(p) for p in res.partitions]),
               graph=tuple(t.detach().cpu() for t in (g.src, g.dst, g.weight,
                                                      g.alive)),
               graph_n=int(g.n_nodes), truth=graph.truth,
               cold=[bool(h["cold"]) for h in res.history])

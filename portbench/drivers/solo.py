"""Closed loop, one consensus job at a time through ``run_consensus``.

Job ``j`` runs on a fresh device copy of the slab packed in set-up, with
its run key from ``(seed, j)``.  A unit is a whole job, ending when
``run_consensus`` returns its host labels, with ``n_p`` partitions for
each round and ``n_p`` for the final re-detection: a job's rounds cost
unlike amounts (a cold round 0, then warm ones), so a window of whole
jobs reads the same rate whatever the host's pace.  The final
re-detection's time runs from the last round's ``on_round`` hook (after
its stats readback) to the return.  Set-up packs the graph and runs one
cold round on a key outside the window's.
"""

from __future__ import annotations

import time

from portbench import jobs as traffic
from portbench import port


class Driver:
    def __init__(self, cell, seed: int, device: str,
                 clock=time.perf_counter):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.clock = clock
        self.cfg = cell.config
        self.traffic = traffic.Traffic(self.cfg, cell.mix, seed)

    def setup(self) -> None:
        import torch

        from fastconsensus_tpu_torch.engine import consensus_round
        from fastconsensus_tpu_torch.graph import pack_edges

        self.graph = self.traffic.graph(0, 0)
        # L: the input's distinct edges, run_consensus's default
        self.n_closure = traffic.canonical_count(self.graph.edges)
        self.slab = pack_edges(self.graph.edges, self.graph.n,
                               device=self.device)
        self.det = port.detector(self.cfg)
        self.config = port.consensus_config(self.cfg)
        s = self.slab.with_weights(torch.where(self.slab.alive, 1.0, 0.0))
        consensus_round(s, port.key(self.traffic.warmup_key_seed(),
                                    self.device),
                        self.det, self.config.n_p, self.config.tau,
                        self.config.delta, self.n_closure,
                        closure_tau=self.config.closure_tau)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def run(self, window) -> list:
        from fastconsensus_tpu_torch.consensus import run_consensus

        n_p = self.config.n_p
        done = []
        j = 0
        while not window.closed:
            last = [None]

            def on_round(entry):
                last[0] = self.clock()

            key = port.key(traffic.key_seed(self.seed, j), self.device)
            t0 = self.clock()
            res = run_consensus(port.fresh_copy(self.slab), self.det,
                                self.config, key=key, on_round=on_round)
            t1 = self.clock()
            window.unit(n_p * (res.rounds + 1),
                        final_detect_s=t1 - (last[0] or t0))
            done.append(port.finished_job(self.graph, self.graph.n,
                                          self.n_closure, res))
            j += 1
        return done

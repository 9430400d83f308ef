"""Closed loop of batches of same-bucket jobs, the serving tier's
coalescing path: ``serve.bucketer.pad_to_bucket`` for each graph, then
``run_consensus_batch``.

Batch ``b`` takes the mix's ``batch`` graphs of pool batch
``b % pool_batches`` (all drawn in set-up) and run keys from
``(seed, b, slot)``.  A unit is a whole batch.  Set-up draws the pool and
runs one batch on keys outside the window's.
"""

from __future__ import annotations

from portbench import jobs as traffic
from portbench import port


class Driver:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell.config
        self.traffic = traffic.Traffic(self.cfg, cell.mix, seed)
        self.bucket = cell.mix["bucket"]

    def _batch(self, b: int, seeds) -> list:
        from fastconsensus_tpu_torch.consensus import run_consensus_batch
        from fastconsensus_tpu_torch.serve.bucketer import pad_to_bucket

        graphs = self.traffic.graphs(b)
        padded = [pad_to_bucket(g.edges, g.n, device=self.device)
                  for g in graphs]
        for _, bucket in padded:
            if bucket.key() != self.bucket:
                raise ValueError(f"a graph of batch {b} fell in bucket "
                                 f"{bucket.key()}, not {self.bucket}")
        res = run_consensus_batch([s for s, _ in padded], self.det,
                                  self.config,
                                  n_closure=padded[0][1].n_closure,
                                  seeds=seeds)
        return list(zip(graphs, res))

    def setup(self) -> None:
        import torch

        self.det = port.detector(self.cfg)
        self.config = port.consensus_config(self.cfg)
        self.traffic.draw_pool()
        # the size class's nodes, and L: its edge class
        self.n_class, self.n_closure = traffic.parse_bucket(self.bucket)
        seed = self.traffic.warmup_key_seed()
        self._batch(0, [(seed + s) & 0x7FFFFFFF
                        for s in range(self.traffic.batch)])
        if self.device == "cuda":
            torch.cuda.synchronize()

    def run(self, window) -> list:
        n_p = self.config.n_p
        done = []
        b = 0
        while not window.closed:
            out = self._batch(b, self.traffic.key_seeds(b))
            window.unit(sum(n_p * (r.rounds + 1) for _, r in out))
            done += [port.finished_job(g, self.n_class, self.n_closure, r)
                     for g, r in out]
            b += 1
        return done

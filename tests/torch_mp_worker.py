"""One rank of a multi-process run of the PyTorch port, for
``tests/test_torch_multiprocess.py``.

    python tests/torch_mp_worker.py SPEC.json RANK

``SPEC.json``: ``{"world": W, "init": "file://...", "env_init": bool,
"out": DIR, "graphs": NPZ, "tasks": [...]}``.  The rank joins the
``gloo`` group (``parallel.initialize_multihost``: from its arguments,
or with ``env_init`` from COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID, which the launcher sets), runs each task and writes
``DIR/{task name}_r{RANK}.npz``.  It imports the port only (never JAX or
the reference), on one thread.
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path

os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fastconsensus_tpu_torch import parallel  # noqa: E402
from fastconsensus_tpu_torch.consensus import (ConsensusConfig,  # noqa: E402
                                               run_consensus)
from fastconsensus_tpu_torch.graph import pack_edges  # noqa: E402
from fastconsensus_tpu_torch.models.registry import get_detector  # noqa: E402
from fastconsensus_tpu_torch.ops import row_kernels as rk  # noqa: E402
from fastconsensus_tpu_torch.parallel import collectives as coll  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def result_arrays(res) -> dict:
    """A run's result as arrays (history as JSON bytes)."""
    g = res.graph
    return dict(partitions=np.stack(res.partitions), rounds=res.rounds,
                converged=res.converged,
                history=np.frombuffer(json.dumps(res.history).encode(),
                                      np.uint8),
                src=g.src.numpy(), dst=g.dst.numpy(),
                weight=g.weight.numpy(), alive=g.alive.numpy())


def run_task(task, graphs, mesh):
    edges = graphs[task["graph"]]
    n = int(graphs[task["graph"] + "_n"])
    slab = pack_edges(edges, n, device="cpu")
    cfg = ConsensusConfig(**task["cfg"])
    det = get_detector(task["cfg"].get("algorithm", "louvain"))
    calls = []
    plain = rk.row_totals_plain
    rk.row_totals_plain = lambda *a: calls.append(1) or plain(*a)
    old_env = {k: os.environ.get(k) for k in task.get("env", {})}
    os.environ.update(task.get("env", {}))
    try:
        res = run_consensus(slab, det, cfg, mesh=mesh)
    finally:
        rk.row_totals_plain = plain
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(result_arrays(res), row_totals_calls=len(calls),
                local_blocks=np.asarray(mesh.local_blocks(), np.int64),
                local_chunks=np.asarray(mesh.local_chunks(), np.int64))


def collectives_task(task, rank):
    """Seeded shards per axis layout through the cross-process
    collectives: every process's results, for the parent to hold against
    the one-process functions over every shard."""
    out = {}
    for li, owners in enumerate(task["layouts"]):
        rng = np.random.default_rng(100 + li)
        k = len(owners)
        shards = dict(
            f32=[torch.as_tensor(rng.standard_normal((3, 5)),
                                 dtype=torch.float32) for _ in range(k)],
            i64=[torch.as_tensor(rng.integers(-50, 50, (7,)))
                 for _ in range(k)],
            b=[torch.as_tensor(rng.random(6) < 0.5) for _ in range(k)])
        ax = coll.Axis(tuple(owners), rank, CPU)
        for name, xs in shards.items():
            mine = [xs[s] for s in ax.local]
            if name != "b":
                for op in ("psum", "pmax"):
                    r = getattr(coll, op)(mine, ax)
                    assert len(r) == max(1, len(mine))
                    out[f"{li}_{name}_{op}"] = r[0].numpy()
            for tiled in (False, True):
                r = coll.all_gather(mine, tiled=tiled, axis=ax)
                out[f"{li}_{name}_gather{int(tiled)}"] = r[0].numpy()
        out[f"{li}_axis_index"] = np.asarray(
            coll.axis_index([None] * len(ax.local), ax), np.int64)
    return out


def refusals_task(task, graphs, mesh):
    """The refusals a multi-process mesh makes: a detect cache, and
    another process's cell device."""
    out = {}
    slab = pack_edges(graphs["karate"], int(graphs["karate_n"]),
                      device="cpu")
    try:
        run_consensus(slab, get_detector("louvain"),
                      ConsensusConfig(n_p=4), mesh=mesh,
                      detect_cache_dir=task["cache_dir"])
        out["cache"] = "no error"
    except ValueError as e:
        out["cache"] = str(e)
    p, e = mesh.shape.values()
    other = next((i, j) for i in range(p) for j in range(e)
                 if mesh.owner(i, j) != mesh.rank)
    try:
        mesh.device(*other)
        out["device"] = "no error"
    except RuntimeError as err:
        out["device"] = str(err)
    return {k: np.frombuffer(v.encode(), np.uint8) for k, v in out.items()}


def checkpoint_task(task, graphs, mesh, rank, out_dir):
    """Checkpoint at round 2, resume to round 4, beside the uninterrupted
    4-round run; process 0 keeps the round-2 file for the parent."""
    edges = graphs[task["graph"]]
    n = int(graphs[task["graph"] + "_n"])
    slab = pack_edges(edges, n, device="cpu")
    det = get_detector("louvain")
    kw = task["cfg"]
    full = run_consensus(slab, det, ConsensusConfig(max_rounds=4, **kw),
                         mesh=mesh)
    ck = os.path.join(out_dir, f"{task['name']}.npz")
    run_consensus(slab, det, ConsensusConfig(max_rounds=2, **kw), mesh=mesh,
                  checkpoint_path=ck)
    if rank == 0:
        shutil.copy(ck, os.path.join(out_dir, f"{task['name']}_round2.npz"))
    torch.distributed.barrier()
    res = run_consensus(slab, det, ConsensusConfig(max_rounds=4, **kw),
                        mesh=mesh, checkpoint_path=ck, resume=True)
    out = {f"full_{k}": v for k, v in result_arrays(full).items()}
    out.update({f"resumed_{k}": v for k, v in result_arrays(res).items()})
    return out


def main(spec_path: str, rank: int) -> int:
    t0 = time.monotonic()
    spec = json.loads(Path(spec_path).read_text())
    if spec.get("env_init"):
        got = parallel.initialize_multihost(backend="gloo")
    else:
        got = parallel.initialize_multihost(spec["init"], spec["world"], rank,
                                            backend="gloo")
    assert got == rank == parallel.process_index()
    assert parallel.process_count() == spec["world"]
    graphs = dict(np.load(spec["graphs"]))
    out_dir = spec["out"]
    try:
        for task in spec["tasks"]:
            mesh = None
            if "layout" in task:
                p, e = task["layout"]
                mesh = parallel.make_mesh(p, e, devices=[CPU] *
                                          task.get("per_rank", 1))
            kind = task["kind"]
            if kind == "run":
                arrays = run_task(task, graphs, mesh)
            elif kind == "collectives":
                arrays = collectives_task(task, rank)
            elif kind == "refusals":
                arrays = refusals_task(task, graphs, mesh)
            else:
                arrays = checkpoint_task(task, graphs, mesh, rank, out_dir)
            np.savez(os.path.join(out_dir, f"{task['name']}_r{rank}.npz"),
                     **arrays)
            print(f"rank {rank}: {task['name']} done at "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
    finally:
        parallel.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""The multi-process mesh of the PyTorch port on the CPU:
``parallel.initialize_multihost`` over ``torch.distributed`` (``gloo``),
the collectives across processes, and ``run_consensus(mesh=)`` run SPMD
on every rank.

The ranks are separate processes (``tests/torch_mp_worker.py``, which
imports the port only), joined through a file rendezvous in the test's
temporary directory (no TCP port), one thread each.  Two launches start
together when the first test needs them, one of 2 ranks and one of 4,
each running every case it serves; the parent computes its references
meanwhile.  A rank that has not finished after 120 s is killed and the
test fails naming it.

On every rank, partitions, rounds, the integer round stats and the
gathered slab equal, bit for bit, (a) the port's unsharded run, (b) the
port's one-process mesh of the same shape and (c) the reference's
``run_consensus(mesh=)`` on its 8 forced CPU devices
(``tests/conftest.py``).  Against (b) the whole history is equal, floats
included: the collectives gather every shard and fold in shard order, so
the float sums run as in one process.  The collectives alone: exact
against the one-process functions, floats included (tolerance 0).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fastconsensus_tpu import parallel as jpar
from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
from fastconsensus_tpu.consensus import run_consensus as jrun
from fastconsensus_tpu.graph import pack_edges as jpack
from fastconsensus_tpu.models.registry import get_detector as jdetector
from fastconsensus_tpu.utils.synth import planted_partition
from fastconsensus_tpu_torch import parallel
from fastconsensus_tpu_torch.consensus import ConsensusConfig, run_consensus
from fastconsensus_tpu_torch.graph import pack_edges
from fastconsensus_tpu_torch.models.registry import get_detector
from fastconsensus_tpu_torch.parallel import collectives as coll

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_mp_worker.py"
RANK_TIMEOUT_S = 120.0
CPU8 = [torch.device("cpu")] * 8
HISTORY_INTS = ("round", "n_alive", "n_unconverged", "n_closure_added",
                "n_repaired", "n_dropped", "n_overflow", "n_hub_overflow",
                "n_agg_overflow", "cold", "capacity", "n_w_zero", "n_w_full",
                "n_frontier", "labels_changed", "labels_changed_by_member")
# (p, e) -> the launch (rank count) that runs it
LAYOUTS = {(2, 1): 2, (1, 2): 2, (2, 2): 4, (1, 4): 4}
CFG = {"karate": dict(n_p=4, tau=0.5, delta=0.1, seed=7, max_rounds=4,
                      closure_sampler="scatter"),
       "hybrid": dict(n_p=4, tau=0.2, delta=0.02, seed=1, max_rounds=2,
                      closure_tau=0.2, closure_sampler="scatter")}
# forced hybrid rows: the plain row_totals runs in each detecting rank
ENV = {"karate": {}, "hybrid": {"FCTPU_MOVE_PATH": "hybrid"}}
CK_CFG = dict(n_p=4, seed=3, delta=0.0, closure_sampler="scatter")
# counters of the work a process runs for its own shards (one-process
# mesh: every shard's), not of the driver's steps every rank takes
SHARD_WORK = ("detect.sweeps", "detect.member_sweeps", "detect.member_chunks",
              "host_sync.sweep_exit", "host_sync.member_take",
              "host_sync.total")
# axis layouts of the collectives: shard owners, some with an idle rank
COLL_LAYOUTS = {2: [[0, 1], [0, 0, 1], [0, 0], [1, 0, 1]],
                4: [[0, 1, 2, 3], [0, 1], [0, 0, 1, 2], [3, 2, 1, 0, 0]]}


def hybrid_graph(n=300):
    """Planted communities plus grafted hubs (carries hybrid sizing)."""
    rng = np.random.default_rng(11)
    edges, _ = planted_partition(n, 4, 0.1, 0.0008, seed=4)
    hubs = rng.choice(n, 4, replace=False)
    extra = np.array([[h, int(o)] for h in hubs
                      for o in rng.choice(n, 60, replace=False)
                      if int(o) != h])
    return np.vstack([edges, extra])


class Launch:
    """The rank processes of one launch (``envs[r]`` is rank r's
    environment) and their outputs."""

    def __init__(self, out: Path, envs):
        self.world, self.out = len(envs), out
        self.logs = [open(out / f"rank{r}.log", "w")
                     for r in range(self.world)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "spec.json"), str(r)],
            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, (env, log) in enumerate(zip(envs, self.logs))]
        self.t0 = time.monotonic()
        self.failed = None

    def wait(self):
        """Every rank's exit, each within RANK_TIMEOUT_S of the start;
        fails naming each rank that timed out or exited non-zero."""
        if self.failed is None:
            failed = []
            for r, p in enumerate(self.procs):
                left = RANK_TIMEOUT_S - (time.monotonic() - self.t0)
                try:
                    rc = p.wait(timeout=max(0.1, left))
                except subprocess.TimeoutExpired:
                    self.kill()
                    failed.append(f"rank {r} of {self.world} timed out "
                                  f"after {RANK_TIMEOUT_S:.0f} s")
                    continue
                if rc != 0:
                    failed.append(f"rank {r} of {self.world} exited {rc}")
            self.kill()
            self.failed = "; ".join(failed)
            if failed:
                self.failed += "\n" + "\n".join(
                    f"--- rank {r}:\n" +
                    (self.out / f"rank{r}.log").read_text()[-3000:]
                    for r in range(self.world))
        if self.failed:
            pytest.fail(self.failed)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def load(self, name, rank):
        self.wait()
        with np.load(self.out / f"{name}_r{rank}.npz") as z:
            return dict(z)


@pytest.fixture(scope="module")
def launches(tmp_path_factory, karate_edges):
    """Start the 2-rank and the 4-rank launch together: ``{world:
    Launch}``.  The 2-rank launch joins from COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID, the 4-rank one from arguments."""
    root = tmp_path_factory.mktemp("multiprocess")
    graphs = root / "graphs.npz"
    edges, _, ids = karate_edges
    np.savez(graphs, karate=np.asarray(edges), karate_n=len(ids),
             hybrid=hybrid_graph(), hybrid_n=300)
    base = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    started = {}
    for world in (2, 4):
        d = root / f"w{world}"
        d.mkdir()
        tasks = [dict(kind="run", name=f"run_{g}_p{p}e{e}", graph=g,
                      layout=[p, e], cfg=CFG[g], env=ENV[g])
                 for (p, e), w in LAYOUTS.items() if w == world
                 for g in ("karate", "hybrid")]
        tasks.append(dict(kind="collectives", name="collectives",
                          layouts=COLL_LAYOUTS[world]))
        if world == 2:
            tasks += [dict(kind="checkpoint", name="checkpoint",
                           graph="hybrid", layout=[2, 1], cfg=CK_CFG),
                      dict(kind="refusals", name="refusals", layout=[1, 2],
                           cache_dir=str(d / "cache"))]
        init = f"file://{d / 'rendezvous'}"
        (d / "spec.json").write_text(json.dumps(dict(
            world=world, init=init, env_init=world == 2, out=str(d),
            graphs=str(graphs), tasks=tasks)))
        envs = [dict(base, COORDINATOR_ADDRESS=init, NUM_PROCESSES="2",
                     PROCESS_ID=str(r)) if world == 2 else base
                for r in range(world)]
        started[world] = Launch(d, envs)
    yield started
    for launch in started.values():
        launch.kill()


_UNSHARDED = {}


def graph_edges(karate_edges, graph):
    if graph == "karate":
        edges, _, ids = karate_edges
        return np.asarray(edges), len(ids)
    return hybrid_graph(), 300


def port_arrays(res) -> dict:
    g = res.graph
    return dict(partitions=np.stack(res.partitions), rounds=res.rounds,
                converged=res.converged, history=res.history,
                src=np.asarray(g.src), dst=np.asarray(g.dst),
                weight=np.asarray(g.weight), alive=np.asarray(g.alive))


def rank_arrays(z: dict, prefix: str = "") -> dict:
    out = {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    out["history"] = json.loads(bytes(out["history"]).decode())
    return out


def assert_same_run(got: dict, want: dict, what: str,
                    whole_history: bool = False):
    """Partitions, rounds, the integer round stats and the slab over the
    shorter capacity (the rest dead) bitwise; ``whole_history`` also
    every float stat."""
    assert int(got["rounds"]) == int(want["rounds"]), what
    assert bool(got["converged"]) == bool(want["converged"]), what
    np.testing.assert_array_equal(got["partitions"], want["partitions"],
                                  err_msg=what)
    assert len(got["history"]) == len(want["history"]), what
    for x, y in zip(got["history"], want["history"]):
        for k in HISTORY_INTS:
            if k != "capacity" and k in y:
                assert x[k] == y[k], (what, k)
    if whole_history:
        assert got["history"] == want["history"], what
    c = min(got["src"].shape[0], want["src"].shape[0])
    for name in ("src", "dst", "weight", "alive"):
        np.testing.assert_array_equal(got[name][:c], want[name][:c],
                                      err_msg=f"{what}: {name}")
    for arrays in (got, want):
        assert not arrays["alive"][c:].any(), what


@pytest.mark.parametrize("graph", ["karate", "hybrid"])
@pytest.mark.parametrize("p,e", list(LAYOUTS))
def test_multiprocess_run_equals_unsharded_one_process_mesh_and_reference(
        monkeypatch, launches, karate_edges, graph, p, e):
    """Every rank of the (p, e) launch against (a) the unsharded run,
    (b) the one-process mesh, (c) the reference's mesh run.  On the
    hybrid graph each rank that detects runs row_totals."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    for k, v in ENV[graph].items():
        monkeypatch.setenv(k, v)
    edges, n = graph_edges(karate_edges, graph)
    det = get_detector("louvain")
    if graph not in _UNSHARDED:
        _UNSHARDED[graph] = port_arrays(run_consensus(
            pack_edges(edges, n, device="cpu"), det,
            ConsensusConfig(**CFG[graph])))
    one = port_arrays(run_consensus(
        pack_edges(edges, n, device="cpu"), det,
        ConsensusConfig(**CFG[graph]),
        mesh=parallel.make_mesh(p, e, devices=CPU8)))
    jres = jrun(jpack(edges, n), jdetector("louvain"),
                JConfig(**CFG[graph]),
                mesh=jpar.make_mesh(ensemble=p, edge=e))
    ref = dict(partitions=np.stack(jres.partitions), rounds=jres.rounds,
               converged=jres.converged, history=jres.history,
               **{f: np.asarray(getattr(jres.graph, f))
                  for f in ("src", "dst", "weight", "alive")})
    launch = launches[LAYOUTS[(p, e)]]
    for rank in range(launch.world):
        z = launch.load(f"run_{graph}_p{p}e{e}", rank)
        got = rank_arrays(z)
        assert_same_run(got, _UNSHARDED[graph], f"rank {rank} vs unsharded")
        assert_same_run(got, one, f"rank {rank} vs one-process mesh",
                        whole_history=True)
        assert_same_run(got, ref, f"rank {rank} vs the reference's mesh")
        detects = rank % e == 0   # rank r owns cell (r // e, r % e)
        assert list(z["local_blocks"]) == ([rank // e] if detects else [])
        if graph == "hybrid":
            assert (int(z["row_totals_calls"]) > 0) == detects, rank


def test_a_rank_that_owns_no_cell_returns_the_full_result(launches):
    """(p=2, e=2) on 4 ranks: rank 3's cell (1, 1) holds no chunk and no
    block, yet it runs every collective and returns rank 0's result,
    floats included; (p=2, e=1) on 2 ranks: rank 1 holds no chunk."""
    for graph in ("karate", "hybrid"):
        for world, name, idle, no_chunk in (
                (4, f"run_{graph}_p2e2", 3, [2, 3]),
                (2, f"run_{graph}_p2e1", None, [1])):
            launch = launches[world]
            first = rank_arrays(launch.load(name, 0))
            for rank in no_chunk:
                z = launch.load(name, rank)
                assert list(z["local_chunks"]) == []
                if rank == idle:
                    assert list(z["local_blocks"]) == []
                assert_same_run(rank_arrays(z), first, f"{name} rank {rank}",
                                whole_history=True)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_processes_equal_the_one_process_fold(launches,
                                                                 world):
    """Seeded shards under each owner layout (some leave a rank idle):
    psum, pmax and all_gather (stacked and tiled) in every process equal
    the one-process functions over every shard, bit for bit, the float32
    sums included (tolerance 0: the fold runs in shard order); axis_index
    gives each process its global shard indices."""
    for li, owners in enumerate(COLL_LAYOUTS[world]):
        rng = np.random.default_rng(100 + li)
        k = len(owners)
        shards = dict(
            f32=[torch.as_tensor(rng.standard_normal((3, 5)),
                                 dtype=torch.float32) for _ in range(k)],
            i64=[torch.as_tensor(rng.integers(-50, 50, (7,)))
                 for _ in range(k)],
            b=[torch.as_tensor(rng.random(6) < 0.5) for _ in range(k)])
        for rank in range(world):
            z = launches[world].load("collectives", rank)
            for name, xs in shards.items():
                ops = [] if name == "b" else ["psum", "pmax"]
                for op in ops:
                    want = getattr(coll, op)(xs)[0].numpy()
                    np.testing.assert_array_equal(
                        z[f"{li}_{name}_{op}"], want, err_msg=f"{li} {op}")
                for tiled in (0, 1):
                    want = coll.all_gather(xs, tiled=bool(tiled))[0].numpy()
                    np.testing.assert_array_equal(
                        z[f"{li}_{name}_gather{tiled}"], want)
            assert list(z[f"{li}_axis_index"]) == \
                [s for s, o in enumerate(owners) if o == rank]


def test_checkpoint_and_resume_across_two_ranks(tmp_path, launches,
                                                monkeypatch):
    """(p=2, e=1) on 2 ranks: a run checkpointed at round 2 by process 0
    resumes to round 4 equal to the uninterrupted run (and to the
    unsharded one) on both ranks, and the round-2 file holds what the
    one-process mesh's does, member for member (the slab, key, labels
    and the JSON meta with history and counters; the counters of the
    work a process runs for its own shards, fewer on process 0)."""
    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    edges, n = hybrid_graph(), 300
    det = get_detector("louvain")
    slab = pack_edges(edges, n, device="cpu")
    unsharded = port_arrays(run_consensus(
        slab, det, ConsensusConfig(max_rounds=4, **CK_CFG)))
    ck = tmp_path / "one_process.npz"
    run_consensus(slab, det, ConsensusConfig(max_rounds=2, **CK_CFG),
                  mesh=parallel.make_mesh(2, 1, devices=CPU8),
                  checkpoint_path=str(ck))
    launch = launches[2]
    for rank in range(2):
        z = launch.load("checkpoint", rank)
        full = rank_arrays(z, "full_")
        resumed = rank_arrays(z, "resumed_")
        assert int(resumed["rounds"]) == 4 and len(resumed["history"]) == 4
        assert_same_run(resumed, full, f"rank {rank}", whole_history=True)
        assert_same_run(resumed, unsharded, f"rank {rank} vs unsharded")
    with np.load(launch.out / "checkpoint_round2.npz") as got, \
            np.load(ck) as want:
        assert sorted(got.files) == sorted(want.files)
        assert "labels" in got.files
        for name in want.files:
            if name != "meta":
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=name)
        got_meta, want_meta = (json.loads(bytes(z["meta"]).decode())
                               for z in (got, want))
    # a process counts the sweeps and member chunks it runs itself: the
    # one-process mesh runs both shards', process 0 its own shard's
    got_tel, want_tel = got_meta.pop("telemetry"), want_meta.pop("telemetry")
    assert got_meta == want_meta
    own = [k for k in want_tel if k in SHARD_WORK]
    assert {k: v for k, v in got_tel.items() if k not in SHARD_WORK} == \
        {k: v for k, v in want_tel.items() if k not in SHARD_WORK}
    assert "detect.sweeps" in own
    for k in own:
        assert 0 < got_tel[k] < want_tel[k], k
    # the driver's deliberate reads are the same in both
    reads = [k for k in own
             if k.startswith("host_sync.") and k != "host_sync.total"]
    assert got_tel["host_sync.total"] - sum(got_tel[k] for k in reads) == \
        want_tel["host_sync.total"] - sum(want_tel[k] for k in reads)


def test_multiprocess_mesh_refusals(launches):
    """A detect cache on a mesh that spans processes raises a ValueError
    naming the combination, in every process; a process asked for the
    device of another's cell gets an error, not a copy."""
    for rank in range(2):
        z = launches[2].load("refusals", rank)
        cache = bytes(z["cache"]).decode()
        device = bytes(z["device"]).decode()
        assert "detect_cache_dir is not supported with a mesh that spans " \
            "processes" in cache
        assert f"belongs to process {1 - rank}; process {rank} cannot use" \
            in device


@pytest.mark.parametrize("spelling", ["coordinator", "torchrun", "args"])
def test_initialize_multihost_defaults(monkeypatch, spelling):
    """The address, process count and index come from the arguments,
    else COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, else
    torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK; a host:port
    address is a TCP store URL.  (The rendezvous is intercepted: no
    group is joined, no port opened.)"""
    import torch.distributed as dist

    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    seen = []

    class Stop(Exception):
        pass

    def rendezvous(url, rank, world):
        seen.append((url, rank, world))
        raise Stop

    monkeypatch.setattr(dist, "rendezvous", rendezvous)
    args = ()
    if spelling == "coordinator":
        monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("NUM_PROCESSES", "4")
        monkeypatch.setenv("PROCESS_ID", "2")
        monkeypatch.setenv("WORLD_SIZE", "9")   # the first spelling wins
    elif spelling == "torchrun":
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "2")
    else:
        monkeypatch.setenv("RANK", "3")
        args = ("tcp://10.0.0.1:1234", 4, 2)
    with pytest.raises(Stop):
        parallel.initialize_multihost(*args, backend="gloo")
    assert seen == [("tcp://10.0.0.1:1234", 2, 4)]
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="process_id"):
        parallel.initialize_multihost("file:///nowhere", 4, backend="gloo")
    assert parallel.process_index() == 0 and parallel.process_count() == 1


def test_initialize_multihost_names_a_backend_that_cannot_serve():
    """Without CUDA, neither the default backend nor an explicit "nccl"
    can serve the process: each raises naming nccl, before joining
    anything, and nothing switches to gloo unasked."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA (the refusal is for it)")
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="backend 'nccl' cannot serve"):
            parallel.initialize_multihost("file:///nowhere", 2, 0,
                                          backend=backend)
    assert parallel.process_count() == 1

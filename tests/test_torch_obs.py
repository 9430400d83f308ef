"""The port's fcobs (``fastconsensus_tpu_torch/obs``) on the CPU: the
modules copied from the reference, the reference's own cases run against
the port's copies, the spans and counters of a consensus run against the
reference's, the CLI's trace flags and the post-mortem signal."""

import ast
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KARATE = str(REPO / "examples" / "karate_club.txt")

COPIED = ("obs/flight.py", "obs/latency.py", "obs/roundlog.py",
          "obs/export.py", "obs/postmortem.py", "utils/supervise.py")

# Copies that leave out top-level definitions the port does not use.
DROPPED = {"obs/roundlog.py": ("phase_span",)}

# Counters the reference takes from XLA executables, with no counterpart
# in eager PyTorch: the port records none of them.
NOT_PORTED = {
    "engine.setup_executables": "jitted executables (re)built per setup",
    "xla.compiles": "the compile guard's XLA compile count",
    "rounds_block.seconds": "the fused round block's device call",
    "host_sync.block_stats": "the fused block's stats readback; the port "
                             "reads each round's stats (round_stats)",
}


def port_cases(name: str) -> types.ModuleType:
    """The reference's ``tests/{name}.py`` with the package renamed to the
    port's: its test functions then exercise the port's modules."""
    path = REPO / "tests" / f"{name}.py"
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = str(path)
    src = path.read_text().replace("fastconsensus_tpu",
                                   "fastconsensus_tpu_torch")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@pytest.fixture()
def registry():
    from fastconsensus_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.reset()
    yield reg
    reg.reset()


def _top_level_defs(src: str) -> dict:
    return {n.name: ast.get_source_segment(src, n)
            for n in ast.parse(src).body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))}


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    """The port's copy is the reference's text with the package renamed;
    a copy in DROPPED keeps every other top-level class and function of
    the reference's, each with the reference's text."""
    ref = (REPO / "fastconsensus_tpu" / rel).read_text().replace(
        "fastconsensus_tpu", "fastconsensus_tpu_torch")
    port = (REPO / "fastconsensus_tpu_torch" / rel).read_text()
    if rel not in DROPPED:
        assert port == ref
        return
    theirs, mine = _top_level_defs(ref), _top_level_defs(port)
    assert set(DROPPED[rel]) <= set(theirs)
    assert set(mine) == set(theirs) - set(DROPPED[rel])
    assert all(mine[name] == theirs[name] for name in mine)


REFERENCE_CASES = [
    ("test_flight", "test_ring_bound_and_drop_accounting"),
    ("test_flight", "test_concurrent_writers_keep_ring_integrity"),
    ("test_flight", "test_merge_events_filters_and_limit"),
    ("test_flight", "test_bundle_write_schema_and_listing"),
    ("test_flight", "test_bundle_render_and_diff"),
    ("test_latency", "test_bucket_index_boundaries"),
    ("test_latency", "test_histogram_counts_sums_and_quantiles"),
    ("test_latency", "test_exact_merge_across_four_concurrent_writers"),
    ("test_latency", "test_diff_snapshots_attributes_a_window"),
    ("test_obs", "test_span_nesting_ordering_and_args"),
    ("test_obs", "test_disabled_tracer_allocates_and_records_nothing"),
    ("test_obs", "test_traced_decorator_uses_the_ambient_tracer"),
    ("test_obs", "test_tracer_is_thread_safe"),
    ("test_obs", "test_annotated_tracer_still_records_host_spans"),
    ("test_obs", "test_registry_counters_gauges_series"),
    ("test_obs", "test_perfetto_export_roundtrips_with_ordered_ts"),
    ("test_obs", "test_jsonl_export_roundtrips"),
    ("test_obs", "test_jsonl_chain_reader_rebases_ts_across_segments"),
    ("test_obs", "test_jsonl_chain_reader_picks_up_profiler_sidecars"),
    ("test_obs", "test_jsonl_streamer_survives_abrupt_death"),
    ("test_obs", "test_restore_counters_is_a_delta_restore"),
    ("test_obs", "test_summary_table_formats"),
]


@pytest.mark.parametrize("module,case", REFERENCE_CASES)
def test_reference_case_on_the_port(module, case, tmp_path, registry):
    """The reference's flight-recorder, latency and export cases, run
    against the port's modules."""
    fn = getattr(port_cases(module), case)
    args = {"tmp_path": tmp_path, "registry": registry}
    fn(**{k: args[k] for k in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


def _karate_slab():
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    edges, _, ids = read_edgelist(KARATE)
    return pack_edges(edges, len(ids), device="cpu")


def test_disabled_tracer_records_nothing_in_a_run(registry):
    """With the ambient tracer disabled (the default) a run records no
    span, while the always-on counters still count its rounds."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import get_tracer

    tracer = get_tracer()
    assert not tracer.enabled
    res = run_consensus(_karate_slab(), get_detector("louvain"),
                        ConsensusConfig(n_p=6, max_rounds=2, seed=0))
    assert tracer.events() == []
    assert registry.counters()["rounds.total"] == res.rounds


def test_run_counters_equal_the_reference(registry, monkeypatch):
    """A karate run's history-derived counters and series equal the
    reference's for the same config; its spans are the reference's
    names; the compile and executable counters of the reference have no
    counterpart here (NOT_PORTED)."""
    from fastconsensus_tpu.consensus import ConsensusConfig as JConfig
    from fastconsensus_tpu.consensus import run_consensus as jrun
    from fastconsensus_tpu.graph import pack_edges as jpack
    from fastconsensus_tpu.models.registry import get_detector as jdetector
    from fastconsensus_tpu.obs import get_registry as jregistry
    from fastconsensus_tpu.utils.io import read_edgelist
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import Tracer, use_tracer

    monkeypatch.setenv("FCTPU_ROUNDS_BLOCK", "1")
    kw = dict(algorithm="louvain", n_p=6, tau=0.2, delta=0.02,
              max_rounds=3, seed=0)
    edges, _, ids = read_edgelist(KARATE)
    jreg = jregistry()
    jreg.reset()
    jrun(jpack(edges, len(ids)), jdetector("louvain"), JConfig(**kw))
    tr = Tracer()
    with use_tracer(tr):
        res = run_consensus(_karate_slab(), get_detector("louvain"),
                            ConsensusConfig(**kw))
    mine, theirs = registry.counters(), jreg.counters()
    derived = [k for k in theirs if k.startswith(
        ("rounds.", "closure.", "repair.", "capacity.", "quality."))]
    assert {"rounds.total", "rounds.cold", "closure.edges_added",
            "quality.labels_changed_total"} <= set(derived)
    assert {k: mine.get(k) for k in derived} == \
        {k: theirs[k] for k in derived}
    for name in ("round.seconds", "round.converged_frac",
                 "consensus.quality.agreement",
                 "consensus.quality.churn_frac"):
        assert len(registry.series(name)) == len(jreg.series(name)) == \
            res.rounds
    np.testing.assert_allclose(registry.series("round.converged_frac"),
                               jreg.series("round.converged_frac"))
    assert mine["host_sync.round_stats"] == res.rounds
    assert mine["host_sync.final_labels"] == 1
    for name in NOT_PORTED:
        assert not any(k.startswith(name) for k in mine), name
        assert name not in registry.snapshot()["series"]
    spans = [e for e in tr.events()]
    rounds = [e for e in spans if e["name"] == "round"]
    assert [e["args"]["step"] for e in rounds] == list(range(res.rounds))
    assert {e["args"]["mode"] for e in rounds} <= {"cold", "warm",
                                                   "refresh"}
    assert {e["name"] for e in spans} >= {"round", "detect", "tail",
                                          "final_detect"}
    assert {e["parent"] for e in spans if e["name"] in
            ("detect", "tail")} == {"round"}
    jreg.reset()


def test_checkpoint_telemetry_survives_a_resume(tmp_path, registry):
    """Checkpoints carry the run's counters and a resumed process restores
    them: its rounds.total counts the whole run; a checkpoint without
    telemetry (the port's before this field) still loads."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.utils import checkpoint as ckpt

    ck = str(tmp_path / "ck.npz")
    det = get_detector("louvain")
    run_consensus(_karate_slab(), det,
                  ConsensusConfig(n_p=4, max_rounds=2, delta=0.0),
                  checkpoint_path=ck)
    extra = ckpt.load_checkpoint(ck, device="cpu")[4]
    assert extra["_telemetry"]["rounds.total"] == 2
    assert extra["_telemetry"]["host_sync.checkpoint"] == 2 * 2
    registry.reset()                      # a fresh process
    res = run_consensus(_karate_slab(), det,
                        ConsensusConfig(n_p=4, max_rounds=3, delta=0.0),
                        checkpoint_path=ck, resume=True)
    assert res.rounds == 3
    assert registry.counters()["rounds.total"] == 3
    assert ckpt.load_checkpoint(ck, device="cpu")[4]["_telemetry"][
        "rounds.total"] == 3


def _cli(tmp_path, *extra):
    from fastconsensus_tpu_torch.cli import main

    return main(["-f", KARATE, "--alg", "lpm", "-np", "4", "-d", "0.1",
                 "--max-rounds", "2", "--seed", "1", "--device", "cpu",
                 "--out-dir", str(tmp_path), "--quiet", *extra])


def test_cli_trace_writes_perfetto_and_jsonl(tmp_path, registry):
    from fastconsensus_tpu_torch.obs import get_tracer

    trace = tmp_path / "run_trace.json"
    assert _cli(tmp_path, "--trace", str(trace)) == 0
    blob = json.loads(trace.read_text())
    xs = [e for e in blob["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} >= {"round", "detect", "tail",
                                       "final_detect"}
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    lines = [json.loads(x) for x in open(f"{trace}.jsonl")]
    assert lines[-1]["kind"] == "counters"
    assert lines[-1]["counters"]["rounds.total"] == \
        len([e for e in xs if e["name"] == "round"]) >= 1
    # no allocator stats on the CPU, so no device-memory gauge
    assert not any(k.startswith("device_mem.")
                   for k in blob["otherData"]["counters"]["gauges"])
    assert not get_tracer().enabled


def test_cli_trace_with_profile_dir_merges_one_timeline(tmp_path,
                                                        registry):
    """--trace + --profile-dir on the CPU: one Perfetto file, host-only
    (no device track), whose profiler ranges line up with the fcobs spans
    of the same names on one clock."""
    trace = tmp_path / "merged.json"
    assert _cli(tmp_path, "--trace", str(trace), "--profile-dir",
                str(tmp_path / "prof")) == 0
    blob = json.loads(trace.read_text())
    attrib = blob["otherData"]["device_attribution"]
    assert attrib["merged"] and not attrib["device_track"]
    fc = {e["name"] + (f"#{e['args']['step']}" if e["name"] == "round"
                       else ""): e for e in blob["traceEvents"]
          if e.get("cat") == "fcobs" and e.get("ph") == "X"}
    ann = {e["name"]: e for e in blob["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {"round#0", "final_detect"} <= set(fc) <= set(ann)
    for name, span in fc.items():
        # the range encloses its span (entered first, left last), to
        # within the clock anchor's error, and starts just before it
        a = ann[name]
        assert a["ts"] <= span["ts"] + 2e3, name
        assert a["ts"] + a["dur"] >= span["ts"] + span["dur"] - 2e3, name
        assert span["ts"] - a["ts"] < 5e4, name


def test_device_memory_is_none_on_the_cpu(registry):
    from fastconsensus_tpu_torch.obs import counters

    assert counters.device_memory("cpu") is None
    assert counters.record_device_memory(device="cpu") is None
    assert registry.gauges() == {}


def test_dump_on_signal_writes_a_bundle_naming_the_cache(tmp_path):
    """--dump-on-signal in a process of its own (a signal handler must not
    be installed in a test worker): SIGQUIT during round 1 writes a
    fcflight bundle naming the run's detect cache and last round, and the
    run goes on to its output trees."""
    code = (
        "import os, signal, sys\n"
        "from fastconsensus_tpu_torch import cli, consensus\n"
        "run = consensus.run_consensus\n"
        "def quit_in_round_1(*a, on_round=None, **k):\n"
        "    def hook(entry):\n"
        "        on_round(entry)\n"
        "        if entry['round'] == 1:\n"
        "            os.kill(os.getpid(), signal.SIGQUIT)\n"
        "    return run(*a, on_round=hook, **k)\n"
        "consensus.run_consensus = quit_in_round_1\n"
        f"sys.exit(cli.main(['-f', {KARATE!r}, '--alg', 'lpm', '-np', "
        f"'4', '--max-rounds', '2', '--device', 'cpu', '--quiet', "
        f"'--out-dir', {str(tmp_path)!r}, '--detect-cache', "
        f"{str(tmp_path / 'cache')!r}, '--dump-on-signal']))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               FCTPU_FLIGHT_DIR=str(tmp_path / "fcflight"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "fcflight bundle written to" in out.stderr
    (bundle,) = (tmp_path / "fcflight").iterdir()
    run = json.loads((bundle / "run.json").read_text())
    assert run["detect_cache"] == str(tmp_path / "cache")
    assert run["device"] == "cpu"
    rounds = json.loads((bundle / "rounds.json").read_text())
    assert rounds["last"]["round"] == 1
    assert any(p.name.startswith("out_partitions_")
               for p in tmp_path.iterdir())


# ---------------------------------------------- spans on the Unix clock

@pytest.mark.parametrize("sleep_s", [0.0, 0.005, 0.02])
def test_span_unix_interval_lies_within_the_clock_reads(sleep_s):
    """A span's host interval, on the Unix clock, lies within 1 ms of
    ``time.time_ns()`` read just before and just after it."""
    from fastconsensus_tpu_torch.obs import Tracer

    tr = Tracer()
    before = time.time_ns()
    with tr.span("a"):
        time.sleep(sleep_s)
    after = time.time_ns()
    (span,) = tr.spans()
    start, end = span["host"]
    assert abs(start - before) <= 1e6 and abs(end - after) <= 1e6
    assert end - start >= sleep_s * 1e9 - 1e6
    assert span["device"] is None           # a host-only tracer


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: its clock is the host's, run
    ``rate`` times as fast from another zero."""

    made = 0
    rate = 1.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.ns = None

    def record(self):
        self.ns = 12_345 + self.rate * time.time_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


@pytest.fixture()
def fake_card(monkeypatch):
    """A card that is not there: ``torch.cuda`` reports one, its events
    read the host's clock and its synchronize does nothing."""
    _FakeEvent.made, _FakeEvent.rate = 0, 1.0
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return syncs


def test_disabled_tracer_records_nothing_and_creates_no_event(fake_card):
    """A disabled tracer, device-timed or not, hands out the shared no-op
    span: no event, no synchronize, nothing recorded."""
    from fastconsensus_tpu_torch.obs import Tracer
    from fastconsensus_tpu_torch.obs.tracer import _NULL_SPAN

    tr = Tracer(enabled=False, device_timed=True)
    assert not tr.device_timed
    for name in ("consensus", "detect", "sweep"):
        span = tr.span(name, k=1)
        assert span is _NULL_SPAN
        with span:
            pass
    assert tr.events() == [] and tr.spans() == []
    assert _FakeEvent.made == 0 and fake_card == []


@pytest.mark.parametrize("card", [None, 1.0, 1.25])
def test_device_timed_spans(card, request):
    """Device ranges go to the layer boundaries only: on the CPU each is
    its span's host interval, on a card a pair of events resolved onto
    the Unix clock, whatever the rate of the card's clock (``card``);
    inside a capture no event is recorded and the span keeps its host
    interval only."""
    from fastconsensus_tpu_torch.obs import Tracer
    from fastconsensus_tpu_torch.obs.tracer import ANCHOR_TRIES, DEVICE_TIMED
    from fastconsensus_tpu_torch.ops import capture

    if card:
        request.getfixturevalue("fake_card")
        _FakeEvent.rate = card
    tr = Tracer(device_timed=True)
    made = _FakeEvent.made
    assert made == (ANCHOR_TRIES if card else 0)    # the first anchor
    with tr.span("round"):
        with tr.span("detect"):
            with tr.span("sweep"):
                time.sleep(0.02)
        with capture.capture_safe():
            with tr.span("tail"):
                pass
    assert _FakeEvent.made - made == (4 if card else 0)
    by = {s["name"]: s for s in tr.spans()}
    assert {"round", "detect", "tail"} <= DEVICE_TIMED
    assert "sweep" not in DEVICE_TIMED
    assert by["sweep"]["device"] is None and by["tail"]["device"] is None
    for name in ("round", "detect"):
        host, dev = by[name]["host"], by[name]["device"]
        if card:
            assert dev[0] <= dev[1]
            assert abs(dev[0] - host[0]) <= 1e6
            assert abs(dev[1] - host[1]) <= 1e6
        else:
            assert dev == host


def _karate_batch(b):
    from fastconsensus_tpu_torch.serve.bucketer import pad_to_bucket
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    edges, _, ids = read_edgelist(KARATE)
    return [pad_to_bucket(edges, len(ids), device="cpu") for _ in range(b)]


@pytest.mark.parametrize("algorithm", ["louvain", "lpm"])
def test_run_counts_every_sweep_read_and_member_chunk(algorithm, registry):
    """A traced CPU run: every eager sweep's exit read is counted
    (``host_sync.sweep_exit``, one a sweep and one a loop that stops
    early), as is every eager tail's convergence test, and both are in
    ``host_sync.total``; the counters agree with the spans; every
    detection runs at least one member chunk."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import Tracer, use_tracer

    tr = Tracer()
    with use_tracer(tr):
        run_consensus(_karate_slab(), get_detector(algorithm),
                      ConsensusConfig(algorithm=algorithm, n_p=6,
                                      max_rounds=3, seed=0))
    c = registry.counters()
    spans = tr.spans()
    named = lambda n: [s for s in spans if s["name"] == n]  # noqa: E731
    exits, sweeps = c.get("host_sync.sweep_exit", 0), c.get(
        "detect.sweeps", 0)
    assert exits == len(named("sweep_exit"))
    assert sweeps == len(named("sweep"))
    assert c.get("detect.member_sweeps", 0) == sum(
        s["args"]["active"] for s in named("sweep"))
    assert sweeps <= exits
    if algorithm == "louvain":
        assert sweeps > 0
    assert c["host_sync.tail_converged"] == len(named("tail")) > 0
    assert c["host_sync.total"] == sum(
        v for k, v in c.items()
        if k.startswith("host_sync.") and k != "host_sync.total")
    detections = len(named("detect")) + len(named("final_detect"))
    assert c["detect.member_chunks"] == len(named("member_chunk")) >= \
        detections >= 2
    assert all(s["parent"] in ("detect", "final_detect")
               for s in named("member_chunk"))
    assert named("consensus")[0]["parent"] is None
    assert {s["parent"] for s in named("round")} == {"consensus"}


@pytest.mark.parametrize("max_sweeps", [1, 3, 32])
def test_sweep_loop_reads_once_a_sweep(max_sweeps, registry):
    """One eager ``local_move``: one exit read a sweep, and one more where
    it stops before ``max_sweeps``."""
    from fastconsensus_tpu_torch.models import louvain
    from fastconsensus_tpu_torch.utils import prng

    keys = prng.partition_keys(prng.key(3, "cpu"), 4)
    louvain.local_move(_karate_slab(), keys, max_sweeps=max_sweeps)
    c = registry.counters()
    sweeps = c["detect.sweeps"]
    assert 1 <= sweeps <= max_sweeps
    assert c["host_sync.sweep_exit"] == min(sweeps + 1, max_sweeps)
    assert c["host_sync.total"] == c["host_sync.sweep_exit"]
    assert sweeps <= c["detect.member_sweeps"] <= 4 * sweeps


@pytest.mark.parametrize("b", [2, 3])
def test_batch_round_spans_split_detect_and_tails(b, registry):
    """A traced CPU batch: each eager batched round is one
    ``batch_round`` span (args ``mode``, ``active``, ``rounds``) with one
    ``detect`` and one ``tail`` per job it runs under it, and the batch
    counters count the rounds and the jobs' rounds."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import Tracer, use_tracer

    padded = _karate_batch(b)
    tr = Tracer()
    with use_tracer(tr):
        res = run_consensus_batch(
            [s for s, _ in padded], get_detector("louvain"),
            ConsensusConfig(n_p=4, max_rounds=3),
            n_closure=padded[0][1].n_closure, seeds=list(range(1, b + 1)))
    children, rounds = [], []
    for span in tr.spans():             # ordered by end: children first
        if span["parent"] == "batch_round":
            children.append(span)
        elif span["name"] == "batch_round":
            rounds.append((span, children))
            children = []
    assert rounds and not any(s["name"] == "batch_block"
                              for s in tr.spans())
    for span, kids in rounds:
        args = span["args"]
        assert span["parent"] == "consensus_batch"
        assert args["mode"] in ("cold", "warm", "refresh", "scratch")
        assert args["rounds"][0] <= args["rounds"][1]
        assert [k["name"] for k in kids if k["name"] == "detect"] == \
            ["detect"]
        tails = [k for k in kids if k["name"] == "tail"]
        assert [t["args"]["job"] for t in tails] == \
            list(range(args["active"]))
    c = registry.counters()
    assert c["batch.rounds"] == len(rounds)
    assert c["batch.job_rounds"] == sum(s["args"]["active"]
                                        for s, _ in rounds) == \
        sum(r.rounds for r in res)


@pytest.mark.parametrize("name", ["phase_span", "detect_dispatch"])
def test_unread_tracing_is_gone(name):
    """Neither ``phase_span`` nor the ``detect_dispatch`` span is left in
    the port: nothing read them."""
    from fastconsensus_tpu_torch import obs
    from fastconsensus_tpu_torch.obs import roundlog

    assert not hasattr(obs, name) and not hasattr(roundlog, name)
    assert name not in obs.__all__
    for path in (REPO / "fastconsensus_tpu_torch").rglob("*.py"):
        src = path.read_text()
        assert f'span("{name}"' not in src and f"def {name}(" not in src, \
            path


def test_flight_mirrors_round_level_spans_only():
    """An enabled tracer mirrors the round-level spans into the flight
    ring, never a sweep's or a chunk's, which would push the serving
    events out of the bounded ring."""
    from fastconsensus_tpu_torch.obs import Tracer, get_flight_recorder
    from fastconsensus_tpu_torch.obs.tracer import FLIGHT_MIRRORED

    rec = get_flight_recorder()
    rec.reset()
    tr = Tracer()
    with tr.span("consensus"):
        with tr.step_span("round", 0):
            with tr.span("detect"):
                with tr.span("member_chunk", chunk=0):
                    for it in range(3):
                        with tr.span("sweep_exit", it=it):
                            pass
                        with tr.span("sweep", it=it):
                            pass
    mirrored = [(e["kind"], e["name"]) for e in rec.events(
        kinds=("span_open", "span_close"))]
    rec.reset()
    assert mirrored == [("span_open", "consensus"), ("span_open", "round"),
                        ("span_close", "round"),
                        ("span_close", "consensus")]
    assert {"consensus", "consensus_batch", "round", "rounds_block",
            "batch_round", "batch_block", "final_detect",
            "batch_final_detect"} == FLIGHT_MIRRORED

"""``attribution.attribute``: the idle card split by layer and by the
innermost open span, on synthetic records and on a CPU run's own; and
the result line of an untraced run, which the program's spans leave as
it was."""

import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import attribution, devtrace, harness


def span(name, parent, depth, host, device=None):
    return {"name": name, "parent": parent, "depth": depth, "args": None,
            "host": list(host), "device": None if device is None
            else list(device)}


def brute(records, spans, window, exclude):
    """The same split, one ns at a time."""
    w0, w1 = window
    busy = np.zeros(w1 - w0, bool)
    for _, s, e, stream in records:
        if stream != exclude:
            busy[max(s, w0) - w0:max(min(e, w1) - w0, 0)] = True
    det = np.zeros_like(busy)
    tail = np.zeros_like(busy)
    for s in spans:
        if s["device"] is None:
            continue
        lo, hi = s["device"][0] - w0, s["device"][1] - w0
        if s["name"] in attribution.DETECT:
            det[max(lo, 0):max(hi, 0)] = True
        elif s["name"] in attribution.TAIL:
            tail[max(lo, 0):max(hi, 0)] = True
    tail &= ~det
    rest = ~det & ~tail
    return {k: {"busy_s": (m & busy).sum() / 1e9,
                "idle_s": (m & ~busy).sum() / 1e9}
            for k, m in (("detect", det), ("tail", tail), ("driver", rest))}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_sums_to_the_idle_and_matches_a_brute_count(seed):
    """Idle inside detection, inside the tails and outside both sums to
    what ``summarize`` leaves idle; each part equals a count made one ns
    at a time; overlapping records and ranges are counted once."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(60):
        s = int(rng.integers(0, 900))
        records.append(("k", s, s + int(rng.integers(1, 40)),
                        int(rng.integers(0, 3))))
    spans, t = [], 0
    for r in range(4):
        d0 = t + int(rng.integers(0, 20))
        d1 = d0 + int(rng.integers(20, 150))
        t1 = d1 + int(rng.integers(-5, 100))     # may touch detection
        spans.append(span("detect", "round", 2, (d0 - 3, d1), (d0, d1)))
        spans.append(span("tail", "round", 2, (d1, t1), (d1 - 2, t1)))
        spans.append(span("round", "consensus", 1, (t, t1 + 5),
                          (t, t1 + 5)))
        t = t1 + 10
    spans.append(span("final_detect", "consensus", 1, (t, t + 50),
                      (t, t + 50)))
    spans.append(span("consensus", None, 0, (0, t + 60), (0, t + 60)))
    first = min(r[1] for r in records if r[3] != 1)
    last = max(r[2] for r in records if r[3] != 1)
    got = attribution.attribute(records, spans, exclude=1)
    summary = devtrace.summarize(records, exclude=1)
    window_s = (last - first) / 1e9
    assert got["window_s"] == pytest.approx(window_s)
    assert got["busy_s"] == pytest.approx(summary["busy_s"])
    idle = sum(got[k]["idle_s"] for k in ("detect", "tail", "driver"))
    assert idle == pytest.approx(window_s - summary["busy_s"])
    assert sum(s for _, s in got["idle_by_span"]) == pytest.approx(idle)
    want = brute(records, spans, (first, last), exclude=1)
    for part in ("detect", "tail", "driver"):
        for k in ("busy_s", "idle_s"):
            assert got[part][k] == pytest.approx(want[part][k], abs=1e-12)


def test_a_gap_goes_to_the_innermost_open_span():
    records = [("k", 0, 10, 0), ("k", 30, 40, 0), ("k", 45, 50, 0),
               ("k", 70, 80, 0), ("k", 100, 110, 0)]
    spans = [span("sweep_exit", "member_chunk", 3, (8, 35)),
             span("member_chunk", "detect", 2, (5, 60)),
             span("detect", "round", 1, (2, 65), (2, 65)),
             span("tail", "round", 1, (66, 90), (66, 90)),
             span("round", None, 0, (1, 95), (1, 95))]
    got = attribution.attribute(records, spans)
    # gaps [10, 30), [40, 45), [50, 70), [80, 100), each by its start
    assert dict(got["idle_by_span"]) == pytest.approx({
        "round/detect/member_chunk/sweep_exit": 20e-9,
        "round/detect/member_chunk": 25e-9,
        "round/tail": 20e-9})
    assert got["detect"]["idle_s"] == pytest.approx(40e-9)    # to 65
    assert got["tail"]["idle_s"] == pytest.approx(4e-9 + 10e-9)
    assert got["driver"]["idle_s"] == pytest.approx(1e-9 + 10e-9)


def test_no_span_open_and_the_excluded_stream():
    """A gap with no span open is outside the program; the left-out
    stream's copies fill no gap."""
    records = [("k", 0, 10, 0), ("Memcpy", 10, 50, 7), ("k", 50, 60, 0)]
    got = attribution.attribute(records, [], exclude=7)
    assert got["idle_by_span"] == [[attribution.OUTSIDE,
                                    pytest.approx(40e-9)]]
    assert got["driver"]["idle_s"] == pytest.approx(40e-9)
    kept = attribution.attribute(records, [])
    assert kept["idle_s"] == 0 and kept["idle_by_span"] == []


def test_window_bounds_count_the_ends():
    records = [("k", 20, 30, 0)]
    spans = [span("final_detect", None, 0, (0, 40), (0, 40))]
    got = attribution.attribute(records, spans, window=(0, 50))
    assert got["window_s"] == pytest.approx(50e-9)
    assert got["detect"] == pytest.approx({"busy_s": 10e-9,
                                           "idle_s": 30e-9})
    assert got["driver"] == pytest.approx({"busy_s": 0, "idle_s": 10e-9})
    # both gaps began while the span was open: all of each is its
    assert dict(got["idle_by_span"]) == pytest.approx(
        {"final_detect": 40e-9})


def _karate(batch):
    from fastconsensus_tpu_torch.graph import pack_edges
    from fastconsensus_tpu_torch.serve.bucketer import pad_to_bucket
    from fastconsensus_tpu_torch.utils.io import read_edgelist

    edges, _, ids = read_edgelist(str(ROOT / "examples" /
                                      "karate_club.txt"))
    if batch:
        return [pad_to_bucket(edges, len(ids), device="cpu")
                for _ in range(batch)]
    return pack_edges(edges, len(ids), device="cpu")


@pytest.mark.parametrize("batch", [0, 3])
def test_a_cpu_run_splits_by_its_own_spans(batch):
    """The program's device-timed spans over a CPU profiler session of a
    run (solo, then a batch): the split sums to the session's idle, and
    the gaps fall under the program's span paths."""
    from fastconsensus_tpu_torch.consensus import (ConsensusConfig,
                                                   run_consensus,
                                                   run_consensus_batch)
    from fastconsensus_tpu_torch.models.registry import get_detector
    from fastconsensus_tpu_torch.obs import Tracer, use_tracer

    torch.set_num_threads(1)
    det, cfg = get_detector("louvain"), ConsensusConfig(n_p=4,
                                                        max_rounds=2)
    session = devtrace.Session("cpu")
    tracer = Tracer(device_timed=True)
    t0 = time.time_ns()
    session.start()
    with use_tracer(tracer):
        if batch:
            padded = _karate(batch)
            run_consensus_batch([s for s, _ in padded], det, cfg,
                                n_closure=padded[0][1].n_closure,
                                seeds=list(range(batch)))
        else:
            run_consensus(_karate(0), det, cfg)
    session.stop()
    t1 = time.time_ns()
    spans, records = tracer.spans(), session.records()
    root = "consensus_batch" if batch else "consensus"
    assert spans[-1]["name"] == root and spans[-1]["device"]
    got = attribution.attribute(records, spans, window=(t0, t1))
    busy = devtrace.summarize(records)["busy_s"]
    assert got["busy_s"] == pytest.approx(busy, rel=1e-6)
    parts = sum(got[k]["idle_s"] for k in ("detect", "tail", "driver"))
    assert parts == pytest.approx((t1 - t0) / 1e9 - busy, rel=1e-6)
    assert got["detect"]["busy_s"] > 0 and got["tail"]["busy_s"] > 0
    paths = [p for p, _ in got["idle_by_span"]]
    assert any(p.startswith(root + "/") for p in paths)


def test_untraced_line_keeps_its_keys(tiny_root):
    """An untraced run's line: the keys it had before the program's
    spans and counters were added."""
    line = harness.run("tiny-louvain.solo", 11, 0.5, False,
                       time.perf_counter(), root=tiny_root, device="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "card", "checks"]
    assert list(line["card"]) == ["power_limit_w", "partitions",
                                  "unit_ends_s", "job_rounds",
                                  "unstable_share_max", "round_shares",
                                  "tap"]
    assert set(line["metrics"]) == {"partitions_per_s", "final_nmi",
                                    "setup_s"}

"""The CUDA kernels' plain versions against the Pallas kernels (interpret
mode), and the wrappers' dispatch rules.

Integer weights (the main path's co-membership counts) must give
bit-identical totals; non-integer weights agree to 1e-5 relative (the
sums run in another order).  The kernels themselves run only on the card:
their checks are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.ops import pallas_kernels as pk
from fastconsensus_tpu_torch.ops import row_kernels as rk

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

SENT = pk.SENTINEL


def random_rows(rng, n, d, n_labels=6, integer=True):
    lab = rng.integers(0, n_labels, (n, d)).astype(np.int32)
    lab[rng.random((n, d)) < 0.25] = SENT
    w = (rng.integers(1, 9, (n, d)) if integer else rng.random((n, d)) * 3
         ).astype(np.float32)
    w[lab == SENT] = 0.0
    return lab, w


@pytest.mark.parametrize("n,d", [(37, 17), (9, 130), (5, 7), (3, 300)])
def test_row_totals_plain_matches_pallas(n, d):
    lab, w = random_rows(np.random.default_rng(d), n, d)
    jt, jh = pk.row_totals(jnp.asarray(lab), jnp.asarray(w), interpret=True)
    tt, th = rk.row_totals(torch.as_tensor(lab), torch.as_tensor(w))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_row_totals_non_integer_weights():
    lab, w = random_rows(np.random.default_rng(0), 40, 33, integer=False)
    jt, jh = pk.row_totals(jnp.asarray(lab), jnp.asarray(w), interpret=True)
    tt, th = rk.row_totals(torch.as_tensor(lab), torch.as_tensor(w))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_row_totals_padding_and_sentinels():
    # the reference's own case (tests/test_pallas.py)
    lab = np.array([[1, 1, 2, SENT, 2, 1, 3]] * 5, np.int32)
    w = np.array([[1., 2., 3., 0., 4., 5., 6.]] * 5, np.float32)
    total, head = rk.row_totals(torch.as_tensor(lab), torch.as_tensor(w))
    np.testing.assert_array_equal(total[0].numpy(),
                                  [8., 8., 7., 0., 7., 8., 6.])
    assert head[0].tolist() == [True, False, True, False, False, False, True]


def fused_inputs(seed, n=300, d_self=20):
    """Rows shaped as models/louvain._FusedRows builds them: neighbour
    slots, then the node's own zero-weight slot."""
    rng = np.random.default_rng(seed)
    d = d_self + 1
    lab = rng.integers(0, 40, (n, d)).astype(np.int32)
    lab[rng.random((n, d)) < 0.3] = SENT
    lab[:, d_self] = rng.integers(0, 40, n)
    w = rng.integers(1, 9, (n, d)).astype(np.float32)
    w[lab == SENT] = 0.0
    w[:, d_self] = 0.0
    m2 = np.float32(rng.integers(1000, 200000))
    strength = rng.integers(1, 60, n).astype(np.float32)
    sig = rng.integers(0, 3000, (n, d)).astype(np.float32)
    scal = np.zeros((n, 8), np.float32)
    scal[:, 0] = strength
    scal[:, 1] = strength / m2
    scal[:, 2] = np.float32(0.25) / m2
    scal[:, 3] = np.float32(0.5) / m2
    scal[:, 4] = float(rng.integers(0, 1 << 24))
    scal[:, 5] = np.arange(n)
    return lab, w, sig, scal, d_self


@pytest.mark.parametrize("seed", range(3))
def test_fused_move_rows_plain_matches_pallas(seed):
    lab, w, sig, scal, d_self = fused_inputs(seed)
    pad = (-lab.shape[1]) % 128       # the reference pads rows to lanes
    jb, jw = pk.fused_move_rows(
        jnp.asarray(np.pad(lab, ((0, 0), (0, pad)), constant_values=SENT)),
        jnp.asarray(np.pad(w, ((0, 0), (0, pad)))),
        jnp.asarray(np.pad(sig, ((0, 0), (0, pad)))), jnp.asarray(scal),
        d_self, interpret=True)
    tb, tw = rk.fused_move_rows(*(torch.as_tensor(a)
                                  for a in (lab, w, sig, scal)), d_self)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert 0 < int(np.asarray(jw).sum())


def test_cpu_tensors_take_plain_version_without_counting():
    rk.ROW_TOTALS_SHAPES[(4, 9)] += 1
    rk.reset_launches()
    assert not rk.ROW_TOTALS_SHAPES
    lab, w = random_rows(np.random.default_rng(1), 4, 9)
    rk.row_totals(torch.as_tensor(lab), torch.as_tensor(w))
    args = fused_inputs(0, n=8, d_self=4)
    rk.fused_move_rows(*(torch.as_tensor(a) for a in args[:4]), args[4])
    assert rk.LAUNCHES == {"row_totals": 0, "fused_move_rows": 0}
    assert not rk.ROW_TOTALS_SHAPES


def test_cuda_wrappers_raise_instead_of_falling_back(monkeypatch):
    """A tensor the dispatch treats as a card tensor must reach the kernel
    wrapper, which raises when it cannot launch: there is no silent
    fallback to the plain version."""
    monkeypatch.setattr(rk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rk.reset_launches()
    lab, w = random_rows(np.random.default_rng(2), 4, 9)
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        rk.row_totals(torch.as_tensor(lab), torch.as_tensor(w))
    args = fused_inputs(0, n=8, d_self=4)
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        rk.fused_move_rows(*(torch.as_tensor(a) for a in args[:4]), args[4])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rk._load("row_totals")
    assert rk.LAUNCHES == {"row_totals": 0, "fused_move_rows": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(rk.shutil, "which", lambda name: None)
    monkeypatch.setattr(rk.os.path, "exists", lambda p: False)
    monkeypatch.setattr(rk, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rk.build()


def test_lib_path_covers_headers(monkeypatch, tmp_path):
    """Editing a shared header under csrc/ changes every library's build
    path, so no stale library is loaded after it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in rk.SOURCES.values():
        (csrc / src).write_text(f'#include "agg.cuh"  // {src}\n')
    (csrc / "agg.cuh").write_text("#define A 1\n")
    monkeypatch.setattr(rk, "CSRC", csrc)
    monkeypatch.setattr(rk, "BUILD_DIR", tmp_path / "build")
    before = {name: rk._lib_path(name) for name in rk.SOURCES}
    assert len(set(before.values())) == len(before)
    assert rk._lib_path("row_totals") == before["row_totals"]
    (csrc / "agg.cuh").write_text("#define A 2\n")
    after = {name: rk._lib_path(name) for name in rk.SOURCES}
    assert all(after[n] != before[n] for n in rk.SOURCES)
    assert all(p.parent == tmp_path / "build" for p in after.values())


def test_flat_max_d_matches_header():
    text = (rk.CSRC / "row_agg.cuh").read_text()
    assert f"#define ROW_AGG_FLAT_MAX {rk.FLAT_MAX_D}\n" in text
    for src in rk.SOURCES.values():
        assert '#include "row_agg.cuh"' in (rk.CSRC / src).read_text()


@pytest.mark.parametrize("integer", [True, False])
def test_row_totals_fold_is_ascending_left_fold(integer):
    """``row_totals_fold`` (what the kernels are held to at any weights) is
    the per-slot left fold in ascending j, and equals the plain version
    bit for bit at integer weights."""
    lab, w = random_rows(np.random.default_rng(5), 23, 19, integer=integer)
    fold = rk.row_totals_fold(torch.as_tensor(lab), torch.as_tensor(w))
    want = np.zeros(lab.shape, np.float32)
    for r in range(lab.shape[0]):
        for i in range(lab.shape[1]):
            t = np.float32(0.0)
            for j in range(lab.shape[1]):
                if lab[r, j] == lab[r, i]:
                    t = np.float32(t + w[r, j])
            want[r, i] = t
    np.testing.assert_array_equal(fold.numpy(), want)
    plain, _ = rk.row_totals_plain(torch.as_tensor(lab), torch.as_tensor(w))
    if integer:
        np.testing.assert_array_equal(fold.numpy(), plain.numpy())
    else:
        np.testing.assert_allclose(fold.numpy(), plain.numpy(), rtol=1e-5)

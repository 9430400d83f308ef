"""The one traffic generator: graphs and run keys from ``--seed``.

A configuration's ``graph`` says where its graphs come from: ``npz``, a
committed edge list with planted labels (the same graph for every job),
or ``lfr``, the seeded LFR generator below (a fresh graph per job).  A traffic mix (``traffic/<mix>.json``) says how jobs are
grouped (``batch``), which size class every graph must fall in
(``bucket``) and how many distinct batches of graphs a run draws
(``pool_batches``).  Every number comes from ``numpy.random.SeedSequence``
over ``(seed, stream, ...)``, so the same seed gives the same inputs and
any whole seed (negative or past 32 bits) is taken.

``lfr_graph`` is the benchmark's own (the program's ``utils/synth`` wraps
networkx, which the card's machine does not have), kept here so a change
to the program cannot change the traffic.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from portbench.spec import ROOT

# SeedSequence streams: warm-up, job keys, graphs
STREAM_WARMUP, STREAM_KEYS, STREAM_GRAPHS = 0, 1, 2
_M64 = (1 << 64) - 1
_MIN_CLASS = 64


def _entropy(seed: int, *idx: int) -> List[int]:
    return [int(seed) & _M64] + [int(i) for i in idx]


def key_seed(seed: int, *idx: int) -> int:
    """A run-key seed in the int32 range the program's ``prng.key`` takes,
    from ``(seed, STREAM_KEYS, *idx)``."""
    word = np.random.SeedSequence(_entropy(seed, STREAM_KEYS, *idx)
                                  ).generate_state(1, np.uint32)[0]
    return int(word) & 0x7FFFFFFF


def rng(seed: int, *idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, *idx)))


def _power_law(gen: np.random.Generator, lo: float, hi: float,
               exponent: float, size: int) -> np.ndarray:
    """Continuous ``x ** -exponent`` on ``[lo, hi)`` (inverse CDF)."""
    u = gen.random(size)
    if exponent == 1:
        return lo * (hi / lo) ** u
    a, b = lo ** (1 - exponent), hi ** (1 - exponent)
    return (a + u * (b - a)) ** (1 / (1 - exponent))


def _floor_mean(lo: float, hi: int, exponent: float) -> float:
    """Mean of ``floor(x)`` for the power law on ``[lo, hi + 1)``."""
    def cdf(x):
        if exponent == 1:
            return np.log(x / lo) / np.log((hi + 1) / lo)
        a, b = lo ** (1 - exponent), (hi + 1) ** (1 - exponent)
        return (x ** (1 - exponent) - a) / (b - a)
    k = np.arange(int(np.floor(lo)), hi + 1, dtype=float)
    p = cdf(np.minimum(k + 1, hi + 1)) - cdf(np.maximum(k, lo))
    return float((k * p).sum())


def lfr_degrees(gen, n: int, mean: float, k_max: int,
                exponent: float) -> np.ndarray:
    """Degrees ``floor(x)``, ``x`` on the power law whose lower end is
    set (bisection) so that their mean is ``mean``; the sum made even."""
    lo, hi = 1.0, float(k_max)
    for _ in range(60):
        mid = (lo + hi) / 2
        if _floor_mean(mid, k_max, exponent) < mean:
            lo = mid
        else:
            hi = mid
    k = np.floor(_power_law(gen, lo, k_max + 1, exponent, n)).astype(
        np.int64)
    k = np.minimum(k, k_max)
    if k.sum() % 2:
        k[int(np.argmin(k))] += 1
    return k


def lfr_sizes(gen, n: int, c_min: int, c_max: int,
              exponent: float) -> np.ndarray:
    """Community sizes ``floor(x)`` on the power law over ``[c_min,
    c_max + 1)``, drawn until they hold ``n`` nodes; the excess taken one
    node at a time from random communities above ``c_min``."""
    draw = np.floor(_power_law(gen, c_min, c_max + 1, exponent,
                               2 * n // c_min + 2)).astype(np.int64)
    cut = int(np.searchsorted(np.cumsum(draw), n)) + 1
    sizes = draw[:cut].copy()
    excess = int(sizes.sum()) - n
    while excess > 0:
        i = int(gen.choice(np.flatnonzero(sizes > c_min)))
        sizes[i] -= 1
        excess -= 1
    return sizes


def _assign(gen, k_in: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Each node's community: one with a free place and more members
    than the node's internal degree, drawn by free places, the nodes of
    largest internal degree first."""
    n = k_in.shape[0]
    free = sizes.copy()
    comm = np.full(n, -1, dtype=np.int64)
    perm = gen.permutation(n)
    for i in perm[np.argsort(-k_in[perm], kind="stable")]:
        ok = (free > 0) & (sizes > k_in[i])
        if not ok.any():
            raise ValueError("no community can hold a node")
        w = np.cumsum(np.where(ok, free, 0))
        c = int(np.searchsorted(w, gen.random() * w[-1], side="right"))
        comm[i] = c
        free[c] -= 1
    return comm


def _pair_stubs(gen, stubs: np.ndarray, n: int,
                comm: Optional[np.ndarray] = None, passes: int = 50
                ) -> np.ndarray:
    """Edges ``[E, 2]`` (``u < v``) from pairing ``stubs`` at random; a
    pair that is a loop, repeats an edge or (given the communities
    ``comm``) lies inside one community returns
    its two stubs to the next pass, up to ``passes`` or a pass that pairs
    nothing; then each pair of the stubs left is wired in by
    :func:`_rewire`."""
    keys = np.zeros(0, dtype=np.int64)
    left = stubs
    for _ in range(passes):
        if left.shape[0] < 2:
            break
        left = gen.permutation(left)
        if left.shape[0] % 2:
            left = left[:-1]
        u, v = left[0::2], left[1::2]
        a, b = np.minimum(u, v), np.maximum(u, v)
        key = a * n + b
        good = (a != b) & ~np.isin(key, keys)
        if comm is not None:
            good &= comm[a] != comm[b]
        # the first of a pair drawn twice in this pass
        _, first = np.unique(np.where(good, key, -1), return_index=True)
        once = np.zeros_like(good)
        once[first] = True
        good &= once
        if not good.any():
            break
        keys = np.concatenate([keys, key[good]])
        left = np.concatenate([u[~good], v[~good]])
    keys = _rewire(gen, keys, gen.permutation(left), n, comm)
    keys = np.sort(keys)
    return np.stack([keys // n, keys % n], axis=1)


def _rewire(gen, keys: np.ndarray, left: np.ndarray, n: int,
            comm: Optional[np.ndarray], tries: int = 50) -> np.ndarray:
    """Wire in the stub pairs ``(x, y)`` of ``left`` as LFR does: take a
    random edge ``(a, b)`` of ``keys`` and replace it by ``(x, a)`` and
    ``(y, b)`` where both are new, allowed edges; a pair that finds none
    in ``tries`` draws is dropped."""
    if left.shape[0] < 2:
        return keys
    have = set(keys.tolist())
    out = list(keys.tolist())
    side = comm.tolist() if comm is not None else None

    def key(p, q):
        return min(p, q) * n + max(p, q)

    def fits(p, q):
        return p != q and key(p, q) not in have and \
            (side is None or side[p] != side[q])

    for i in range(0, left.shape[0] - 1, 2):
        x, y = int(left[i]), int(left[i + 1])
        if fits(x, y):
            have.add(key(x, y))
            out.append(key(x, y))
            continue
        for _ in range(tries if out else 0):
            j = int(gen.integers(len(out)))
            a, b = divmod(out[j], n)
            if gen.random() < 0.5:
                a, b = b, a
            if fits(x, a) and fits(y, b) and key(x, a) != key(y, b):
                have.discard(out[j])
                out[j] = key(x, a)
                have.add(out[j])
                have.add(key(y, b))
                out.append(key(y, b))
                break
    return np.asarray(out, dtype=np.int64)


def lfr_graph(n: int, mean_degree: float, max_degree: int,
              degree_exponent: float, community_exponent: float,
              min_community: int, max_community: int, mu: float,
              gen: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """An LFR benchmark graph (Lancichinetti, Fortunato, Radicchi 2008):
    ``(edges int64[E, 2] with u < v, labels int64[n])``.

    Degrees and community sizes on power laws; each node keeps
    ``round((1 - mu) * k)`` of its edges inside its community (one with
    more members than that); stubs are paired at random inside each
    community and, for the rest, across communities.  Pairs that would
    be loops, repeats or (across) inside one community are paired again,
    then rewired into existing edges; the few that still find no place
    are dropped, so the realised degrees sit a little below the drawn
    ones.
    """
    k = lfr_degrees(gen, n, mean_degree, max_degree, degree_exponent)
    sizes = lfr_sizes(gen, n, min_community, max_community,
                      community_exponent)
    k_in = np.minimum(np.rint((1 - mu) * k).astype(np.int64),
                      int(sizes.max()) - 1)
    comm = _assign(gen, k_in, sizes)
    # an odd internal sum: one stub of the community goes outside
    for c in range(sizes.shape[0]):
        members = np.flatnonzero(comm == c)
        if k_in[members].sum() % 2:
            k_in[members[int(np.argmax(k_in[members]))]] -= 1
    k_out = k - k_in
    chunks = []
    for c in range(sizes.shape[0]):
        members = np.flatnonzero(comm == c)
        chunks.append(_pair_stubs(gen, np.repeat(members, k_in[members]), n))
    chunks.append(_pair_stubs(gen, np.repeat(np.arange(n), k_out), n, comm))
    edges = np.unique(np.concatenate(chunks, axis=0), axis=0)
    return edges, comm


def grid_up(n: int, minimum: int = _MIN_CLASS) -> int:
    """Smallest value >= n on the {2^k, 3*2^k} grid of size classes."""
    n = max(int(n), int(minimum), 1)
    p = 1
    while p < n:
        p *= 2
    q = (3 * p) // 4
    return q if p >= 4 and q >= n else p


def parse_bucket(key: str) -> Tuple[int, int]:
    """``"n1024_e24576"`` -> ``(1024, 24576)``, each on the grid."""
    n_part, e_part = key.split("_")
    n_class, e_class = int(n_part[1:]), int(e_part[1:])
    if grid_up(n_class) != n_class or grid_up(e_class) != e_class:
        raise ValueError(f"bucket {key!r} is not on the size-class grid")
    return n_class, e_class


def canonical_count(edges: np.ndarray) -> int:
    """Distinct undirected non-loop edges of ``edges``."""
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    return int(np.unique(u[keep] * (int(edges.max()) + 1) + v[keep]).size)


class Graph:
    """One job's input: ``edges int64[E, 2]``, ``n`` nodes, planted
    ``truth`` labels."""

    def __init__(self, edges: np.ndarray, n: int, truth: np.ndarray):
        self.edges, self.n, self.truth = edges, int(n), truth


class Traffic:
    """Graphs and keys of one cell's run, from its config, mix and seed."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 root: Path = ROOT):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.root = root
        self.batch = int(mix.get("batch", 1))
        self.bucket = parse_bucket(mix["bucket"]) if mix.get("bucket") \
            else None
        self.pool_batches = int(mix.get("pool_batches", 1))
        self._fixed: Optional[Graph] = None
        self._pool: dict = {}

    def _lfr(self, *idx: int) -> Graph:
        g = self.config["graph"]
        lo = hi = None
        if self.bucket is not None:
            hi = self.bucket[1]
            lo = _class_below(hi)
        for attempt in range(64):
            gen = rng(self.seed, STREAM_GRAPHS, *idx, attempt)
            try:
                edges, truth = lfr_graph(
                    g["n"], g["mean_degree"], g["max_degree"],
                    g["degree_exponent"], g["community_exponent"],
                    g["min_community"], g["max_community"], g["mu"], gen)
            except ValueError:
                continue
            m = canonical_count(edges)
            # a graph outside the mix's size class would not stack with
            # the rest of its batch: draw again from the next sub-seed
            if hi is None or lo < m <= hi:
                return Graph(edges, g["n"], truth)
        raise ValueError(f"no graph of {self.config['name']} in bucket "
                         f"{self.mix.get('bucket')} after 64 draws")

    def graph(self, batch: int, slot: int) -> Graph:
        """The graph of job ``slot`` of batch (or job) ``batch``."""
        g = self.config["graph"]
        if g["kind"] == "npz":
            if self._fixed is None:
                data = np.load(self.root / g["file"])
                truth = data["labels"]
                self._fixed = Graph(data["edges"], truth.shape[0], truth)
            return self._fixed
        if g["kind"] != "lfr":
            raise ValueError(f"unknown graph kind {g['kind']!r}")
        at = (batch % self.pool_batches, slot)
        if at not in self._pool:
            self._pool[at] = self._lfr(*at)
        return self._pool[at]

    def draw_pool(self) -> None:
        """Make every graph the run can ask for (set-up, not the window)."""
        for b in range(self.pool_batches):
            for s in range(self.batch):
                self.graph(b, s)

    def graphs(self, batch: int) -> List[Graph]:
        return [self.graph(batch, s) for s in range(self.batch)]

    def key_seeds(self, batch: int) -> List[int]:
        return [key_seed(self.seed, batch, s) for s in range(self.batch)]

    def warmup_key_seed(self) -> int:
        word = np.random.SeedSequence(_entropy(self.seed, STREAM_WARMUP)
                                      ).generate_state(1, np.uint32)[0]
        return int(word) & 0x7FFFFFFF


def _class_below(e_class: int) -> int:
    """The grid class just below ``e_class`` (0 below the smallest)."""
    if e_class <= _MIN_CLASS:
        return 0
    c = e_class - 1
    while grid_up(c) == e_class:
        c -= 1
    return grid_up(c)

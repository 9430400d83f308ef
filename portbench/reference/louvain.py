"""Louvain's single-node moves, in plain PyTorch.

``move_gains`` works out, for every member partition and node, the gain
of staying and the best gain of moving to a neighbouring community, with
the modularity gain the port's sweeps maximise (resolution ``gamma``):

    gain(i -> c) = k_i,c - gamma * k_i * (Sigma_c - [c = own] k_i) / 2m

where ``k_i,c`` is the weight from ``i`` into ``c``, ``k_i`` its strength,
``Sigma_c`` the strength of ``c`` and ``2m`` the strength of the graph.
The candidates are the communities ``i`` has positive weight into, as in
the port.  A Louvain partition is one where no node has a move that
gains: ``unstable_share`` is the share of (non-isolated) nodes that still
have one by more than ``REL_TOL * k_i``, worked out in float64.  The
tolerance sits far above float32 rounding of the same sums (about
1e-7 * k_i) and far below the rounding of bfloat16 (about 4e-3 * k_i).

``louvain`` is the plain detector itself: synchronous sweeps in which
each node that can gain moves with probability ``update_prob``, until no
node can gain or the sweep budget is spent, in any float dtype.  The
tests hold the judge to it: its partitions pass, shuffled ones do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

REL_TOL = 1e-5
# directed entries of a member chunk: bounds the sort's temporaries
CHUNK_ELEMS = 1 << 25


def directed(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both directions of the undirected edges ``(u, v, w)``, loops and
    zero weights dropped."""
    ok = (u != v) & (w > 0)
    u, v, w = u[ok], v[ok], w[ok]
    return torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w])


def move_gains(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
               labels: torch.Tensor, gamma: float = 1.0,
               dtype: torch.dtype = torch.float64
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """``(best_c, best_gain, stay_gain, k)`` for ``labels[M, n]`` on the
    graph ``(u, v, w)``: each node's best other community (``-1`` with
    ``best_gain = -inf`` where it has none), the gains, and the strengths
    ``k[n]`` (all gains and sums in ``dtype``)."""
    dev = labels.device
    a, b, ww = directed(u.to(dev), v.to(dev), w.to(dev))
    ww = ww.to(dtype)
    k = torch.zeros(n, dtype=dtype, device=dev).index_add_(0, a, ww)
    m2 = k.sum()
    m = labels.shape[0]
    best_c = torch.full((m, n), -1, dtype=torch.int64, device=dev)
    best_g = torch.full((m, n), float("-inf"), dtype=dtype, device=dev)
    stay = torch.empty((m, n), dtype=dtype, device=dev)
    step = max(1, CHUNK_ELEMS // max(1, a.numel()))
    for lo in range(0, m, step):
        lab = labels[lo:lo + step].to(torch.int64)
        mc = lab.shape[0]
        sigma = torch.zeros((mc, n), dtype=dtype, device=dev).scatter_add_(
            1, lab, k.expand(mc, n))
        own_sigma = torch.gather(sigma, 1, lab)
        # no neighbour in its own community: k_i,own = 0
        stay[lo:lo + mc] = -gamma * k * (own_sigma - k) / m2
        if a.numel() == 0:
            continue
        mi = torch.arange(mc, device=dev)[:, None]
        key = ((mi * n + a[None, :]) * n + lab[:, b]).reshape(-1)
        uniq, inv = torch.unique(key, return_inverse=True)
        kic = torch.zeros(uniq.numel(), dtype=dtype, device=dev).index_add_(
            0, inv, ww.expand(mc, -1).reshape(-1))
        gm, gi, gc = uniq // (n * n), (uniq // n) % n, uniq % n
        own = gc == lab[gm, gi]
        gain = kic - gamma * k[gi] * (sigma[gm, gc] - torch.where(
            own, k[gi], torch.zeros((), dtype=dtype, device=dev))) / m2
        flat = gm * n + gi
        st = stay[lo:lo + mc].reshape(-1)
        st[flat[own]] = gain[own]
        cand = ~own & (kic > 0)
        bg = torch.full((mc * n,), float("-inf"), dtype=dtype, device=dev)
        bg.scatter_reduce_(0, flat[cand], gain[cand], "amax")
        at_best = cand & (gain == bg[flat])
        bc = torch.full((mc * n,), n, dtype=torch.int64, device=dev)
        bc.scatter_reduce_(0, flat[at_best], gc[at_best], "amin")
        best_g[lo:lo + mc] = bg.view(mc, n)
        best_c[lo:lo + mc] = torch.where(bc < n, bc, -1).view(mc, n)
    return best_c, best_g, stay, k


def unstable_share(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   n: int, labels: torch.Tensor, gamma: float = 1.0
                   ) -> torch.Tensor:
    """Per member, the share of non-isolated nodes with a move that gains
    more than ``REL_TOL * k_i`` (float64): ``float64[M]``."""
    _, best, stay, k = move_gains(u, v, w, n, labels, gamma, torch.float64)
    moves = (best - stay) > REL_TOL * k
    live = k > 0
    return (moves & live).sum(dim=1).double() / max(1, int(live.sum()))


def louvain(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
            members: int, max_sweeps: int, seed: int,
            init: Optional[torch.Tensor] = None, update_prob: float = 0.5,
            gamma: float = 1.0, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``members`` plain Louvain partitions ``int64[members, n]``, from
    singletons or ``init``, every gain and sum in ``dtype``."""
    dev = u.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lab = (torch.arange(n, device=dev).expand(members, n).clone()
           if init is None else init.to(device=dev, dtype=torch.int64).clone())
    active = torch.ones(members, dtype=torch.bool, device=dev)
    for _ in range(max_sweeps):
        best, bg, stay, _ = move_gains(u, v, w, n, lab, gamma, dtype)
        want = (best >= 0) & (bg > stay) & active[:, None]
        active = want.any(dim=1)
        if not bool(active.any()):
            break
        coin = torch.rand((members, n), generator=gen, device=dev) \
            < update_prob
        lab = torch.where(want & coin, best, lab)
    return lab

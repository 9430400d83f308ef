"""One consensus tail, checked edge by edge in plain PyTorch.

fastconsensus's tail (Tandon et al. 2019, and the port's
``engine.consensus_tail``) takes a round's graph and its ``n_p`` member
partitions and returns the next round's graph:

1. every edge's weight becomes the number of members that put its two
   ends in one community, except an edge already at ``n_p``, which keeps
   it;
2. edges below ``tau * n_p`` (a float32 product) die;
3. unless the round has converged (at most ``delta`` of the live edges
   with a weight strictly between 0 and ``n_p``, compared in float32),
   triadic closure adds at most ``L`` sampled wedges ``(u, v)``
   of the thresholded graph that are not edges yet, each weighted by its
   own count and, with ``closure_tau``, only at ``closure_tau * n_p`` or
   more;
4. and then a node left with no edge gets back its strongest edge of the
   round's input (ties to the larger neighbour; two nodes that choose
   each other add one edge), at its input weight.

The wedges are drawn at random, so a check cannot name them; it holds
every added edge to what a wedge can give and every other edge to the
rules above.  ``check`` returns the number of edges that break a rule.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

# entries of a chunk of the co-membership compare or the wedge search
_ELEMS = 1 << 24


def f32(x: float) -> float:
    return float(np.float32(x))


def bar(frac: float, n_p: int) -> float:
    """``frac * n_p`` as the float32 product the threshold compares to."""
    return float(np.float32(frac) * np.float32(n_p))


def converged(w: torch.Tensor, n_p: int, delta: float) -> bool:
    """At most ``delta`` of the live edges (weights ``w``) strictly
    between 0 and ``n_p``, compared in float32."""
    n_mid = int(((w > 0) & (w < n_p)).sum())
    return bool(np.float32(n_mid) <=
                np.float32(delta) * np.float32(int(w.numel())))


@dataclasses.dataclass
class Edges:
    """A graph's live edges in canonical order: ``key = u * n + v``
    (``u < v``) ascending, weights beside, and how many live slots
    repeated a pair."""

    n: int
    key: torch.Tensor
    w: torch.Tensor
    repeats: int

    @property
    def u(self) -> torch.Tensor:
        return self.key // self.n

    @property
    def v(self) -> torch.Tensor:
        return self.key % self.n

    def digest(self) -> str:
        h = hashlib.sha1()
        h.update(np.int64(self.n).tobytes())
        h.update(self.key.cpu().numpy().astype(np.int64).tobytes())
        h.update(self.w.cpu().numpy().astype(np.float32).tobytes())
        return h.hexdigest()

    def find(self, key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(present, position)`` of each of ``key`` among the edges."""
        if self.key.numel() == 0:
            z = torch.zeros_like(key, dtype=torch.bool)
            return z, torch.zeros_like(key)
        pos = torch.searchsorted(self.key, key).clamp(max=self.key.numel() - 1)
        return self.key[pos] == key, pos


def edges_of(src, dst, w, alive, n: int, device=None) -> Edges:
    """The live edges of a slot array (any endpoint order)."""
    src, dst, w, alive = (torch.as_tensor(t, device=device)
                          for t in (src, dst, w, alive))
    a = alive.to(torch.bool)
    u = torch.minimum(src[a], dst[a]).to(torch.int64)
    v = torch.maximum(src[a], dst[a]).to(torch.int64)
    key = u * n + v
    order = torch.argsort(key, stable=True)
    key, ww = key[order], w[a][order].to(torch.float32)
    rep = int((key[1:] == key[:-1]).sum()) if key.numel() > 1 else 0
    return Edges(n, key, ww, rep)


def edges_from_list(edges: np.ndarray, n: int, device=None) -> Edges:
    """A graph given as an edge list, deduplicated, loops dropped, every
    weight 1 (how a consensus run starts)."""
    e = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2),
                        device=device)
    u = torch.minimum(e[:, 0], e[:, 1])
    v = torch.maximum(e[:, 0], e[:, 1])
    key = torch.unique(u[u != v] * n + v[u != v])
    return Edges(n, key, torch.ones(key.numel(), device=key.device), 0)


def comember(labels: torch.Tensor, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """Members that put ``u`` and ``v`` in one community: ``int64[K]``."""
    out = torch.zeros(u.numel(), dtype=torch.int64, device=u.device)
    if u.numel() == 0:
        return out
    step = max(1, _ELEMS // u.numel())
    for s in range(0, labels.shape[0], step):
        lab = labels[s:s + step]
        out += (lab[:, u] == lab[:, v]).sum(dim=0)
    return out


def _csr(e: Edges) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(offsets[n + 1], neighbours, directed keys sorted)`` of ``e``."""
    a = torch.cat([e.u, e.v])
    b = torch.cat([e.v, e.u])
    order = torch.argsort(a * e.n + b)
    a, b = a[order], b[order]
    offsets = torch.searchsorted(a, torch.arange(e.n + 1, device=a.device))
    return offsets, b, a * e.n + b


def common_neighbour(e: Edges, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """Whether each pair ``(x, y)`` closes a wedge of ``e``."""
    out = torch.zeros(x.numel(), dtype=torch.bool, device=x.device)
    if x.numel() == 0 or e.key.numel() == 0:
        return out
    offsets, nbr, dkey = _csr(e)
    deg = offsets[1:] - offsets[:-1]
    swap = deg[x] > deg[y]
    x, y = torch.where(swap, y, x), torch.where(swap, x, y)
    lo = 0
    while lo < x.numel():
        # a chunk of pairs whose expansion stays within _ELEMS
        cum = torch.cumsum(deg[x[lo:]], 0)
        hi = lo + max(1, int(torch.searchsorted(cum, torch.tensor(
            _ELEMS, device=cum.device))))
        xs, ys = x[lo:hi], y[lo:hi]
        cnt = deg[xs]
        total = int(cnt.sum())
        if total:
            rep = torch.repeat_interleave(torch.arange(xs.numel(),
                                                       device=xs.device), cnt)
            start = torch.cumsum(cnt, 0) - cnt
            idx = offsets[xs][rep] + torch.arange(total, device=xs.device) \
                - start[rep]
            q = nbr[idx] * e.n + ys[rep]
            pos = torch.searchsorted(dkey, q).clamp(max=dkey.numel() - 1)
            hit = (dkey[pos] == q).to(torch.int64)
            out[lo:hi] = torch.zeros(xs.numel(), dtype=torch.int64,
                                     device=xs.device).index_add_(
                0, rep, hit) > 0
        lo = hi
    return out


def _degree(e: Edges, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    u, v = e.u, e.v
    if mask is not None:
        u, v = u[mask], v[mask]
    d = torch.zeros(e.n, dtype=torch.int64, device=e.key.device)
    return d.index_add_(0, u, torch.ones_like(u)).index_add_(
        0, v, torch.ones_like(v))


def check(e_in: Edges, labels: torch.Tensor, e_out: Edges, n_p: int,
          tau: float, delta: float, closure_tau: Optional[float],
          n_dropped: int) -> dict:
    """Hold one tail (``e_in`` and the members' ``labels[n_p, n]`` in,
    ``e_out`` out) to the rules above.  ``n_dropped``: survivors the
    program dropped for want of slots (it then grows and replays the
    round, so added edges may be missing).  Returns ``faults`` (edges that
    break a rule, and repeated pairs), ``converged`` (the program's stop
    test on this round), ``closed`` and ``repaired`` edge counts (that
    ``closed`` stays within the round's ``L`` samples is the caller's to
    hold: ``L`` belongs to the job)."""
    n = e_in.n
    dev = e_in.key.device
    labels = labels.to(dev)
    faults = e_out.repeats
    if e_out.n != n or labels.shape != (n_p, n):
        return dict(faults=max(1, e_out.key.numel()), converged=False,
                    closed=0, repaired=0)
    cnt = comember(labels, e_in.u, e_in.v).to(torch.float32)
    w_new = torch.where(e_in.w >= n_p, e_in.w, cnt)
    keep = w_new >= bar(tau, n_p)
    t = Edges(n, e_in.key[keep], w_new[keep], 0)
    conv_mid = converged(t.w, n_p, delta)
    present, pos = e_out.find(t.key)
    faults += int((~present).sum())
    faults += int((present & (e_out.w[pos] != t.w)).sum())
    in_t, _ = t.find(e_out.key)
    extra = ~in_t
    closed = repaired = 0
    if conv_mid:
        faults += int(extra.sum())
    else:
        x = Edges(n, e_out.key[extra], e_out.w[extra], 0)
        cw = comember(labels, x.u, x.v).to(torch.float32)
        ok_c = (x.w == cw) & common_neighbour(t, x.u, x.v)
        if closure_tau is not None:
            ok_c &= cw >= bar(closure_tau, n_p)
        closed = int(ok_c.sum())
        deg_tc = _degree(t) + _degree(x, ok_c)
        # each node's strongest input edge, ties to the larger neighbour
        a = torch.cat([e_in.u, e_in.v])
        b = torch.cat([e_in.v, e_in.u])
        wa = torch.cat([e_in.w, e_in.w])
        best_w = torch.full((n,), float("-inf"), device=dev).scatter_reduce_(
            0, a, wa, "amax")
        partner = torch.full((n,), -1, dtype=torch.int64,
                             device=dev).scatter_reduce_(
            0, a, torch.where(wa == best_w[a], b, -1), "amax")
        r = ~ok_c
        ru, rv, rw = x.u[r], x.v[r], x.w[r]
        in_prev, ppos = e_in.find(x.key[r])
        same_w = in_prev & (e_in.w[ppos] == rw)

        def proposes(z, o):
            return (deg_tc[z] == 0) & (best_w[z] == rw) & (partner[z] == o)

        ok_r = same_w & (proposes(ru, rv) | proposes(rv, ru))
        repaired = int(ok_r.sum())
        faults += int((~ok_r).sum())
        if n_dropped == 0:
            lonely = (_degree(e_in) > 0) & (deg_tc == 0) & (_degree(e_out)
                                                           == 0)
            faults += int(lonely.sum())
    conv = conv_mid or converged(e_out.w, n_p, delta)
    return dict(faults=faults, converged=conv, closed=closed,
                repaired=repaired)

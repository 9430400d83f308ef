"""Shape arithmetic in plain Python.

``torch.broadcast_shapes`` imports sympy on its first call (through
torch's symbolic-shape machinery), a host stall of seconds in the middle
of a round; :func:`broadcast_shape` is the same rule without it.
"""

from __future__ import annotations

from typing import Sequence

import torch


def broadcast_shape(*shapes: Sequence[int]) -> torch.Size:
    """The broadcast of ``shapes`` (numpy's rule); raises ValueError when
    they do not broadcast."""
    ndim = max((len(s) for s in shapes), default=0)
    out = [1] * ndim
    for s in shapes:
        for i, d in enumerate(s, start=ndim - len(s)):
            d = int(d)
            if d == out[i] or d == 1:
                continue
            if out[i] != 1:
                raise ValueError(f"shapes {[tuple(x) for x in shapes]} do "
                                 f"not broadcast")
            out[i] = d
    return torch.Size(out)

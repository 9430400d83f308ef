"""Single keyed PRNG tree: a bit-exact threefry2x32, as integer tensor ops.

The JAX package draws every random number from one ``jax.random`` key
(``fold_in`` streams per round, per member and per sweep).  Whole-run
parity with it needs the same bits, so this module re-implements jax's
default PRNG — threefry2x32 with ``jax_threefry_partitionable=True`` —
over int64 tensors holding uint32 values, on whatever device the key
lives on.  It is part of the program's semantics, not a generator for
test noise.

A key is an int64 tensor ``[..., 2]`` whose two entries are the uint32
words of ``jax.random.key_data``.  Every function accepts a leading batch
of keys (one per ensemble member) and broadcasts over it:

* ``bits(key, shape)`` is ``x0 ^ x1`` of threefry over the counters
  ``(0, i)``, i the row-major index into ``shape`` — the partitionable
  layout;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both threefry of the
  counter ``(0, i)``;
* ``uniform`` fills the 23 mantissa bits of a float in [1, 2) and
  subtracts one; ``bernoulli`` is ``uniform < p``; ``randint`` is jax's
  two-draw modulus construction in wrapping uint32 arithmetic.

uint32 products are formed from 16-bit halves so that no int64 product
overflows.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from fastconsensus_tpu_torch.utils.env import resolve_device

M32 = 0xFFFFFFFF

# Stable stream tags: fold_in(key, TAG) partitions the key tree by purpose.
STREAM_ROUND = 0x01       # one sub-key per consensus round
STREAM_FINAL = 0x03       # final re-detection runs

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul32(a: torch.Tensor, b: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(a * b) mod 2**32`` for uint32 values held in int64 tensors."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed in the int32 range, on
    ``device`` (default CUDA; see ``utils.env.resolve_device``)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def key_data(k: torch.Tensor) -> np.ndarray:
    """uint32 words of a key (or a batch of keys), as ``jax.random.key_data``."""
    return k.detach().cpu().numpy().astype(np.uint32)


def wrap_key_data(data, device=None) -> torch.Tensor:
    """Inverse of :func:`key_data`, on ``device`` (default CUDA)."""
    arr = np.asarray(data, dtype=np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=resolve_device(device))


def _words(k: torch.Tensor, extra_dims: int):
    shape = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Mix ``data`` (an int, or an int tensor broadcastable against the key
    batch) into ``k``."""
    if isinstance(data, (int, np.integer)):
        # a fill, not a host-to-device copy: capture-safe (ops/capture.py)
        d = torch.full((), int(data) & M32, dtype=torch.int64,
                       device=k.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` child keys: shape ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    k0, k1 = _words(k, 1)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """uint32 random bits of ``shape`` per key: ``[..., *shape]`` (int64)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    k0, k1 = _words(k, len(shape))
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 in [0, 1), jax's mantissa construction."""
    b = (bits(k, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: torch.Tensor, p: float, shape: Sequence[int] = ()
              ) -> torch.Tensor:
    """``uniform < p`` with ``p`` rounded to float32 first."""
    return uniform(k, shape) < float(np.float32(p))


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32-range integers in [minval, maxval) (int64 tensor), drawn from
    two words per value exactly as jax does (wrapping uint32 arithmetic)."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) outside int32")
    ks = split(k, 2)
    higher = bits(ks[..., 0, :], shape)
    lower = bits(ks[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (mul32(higher % span, mult) + lower % span) & M32
    return minval + off % span


def stream(k: torch.Tensor, tag: int, *indices: int) -> torch.Tensor:
    """Sub-key for a named stream and optional indices (round, member)."""
    out = fold_in(k, tag)
    for ix in indices:
        out = fold_in(out, ix)
    return out


def partition_keys(k: torch.Tensor, n_p: int) -> torch.Tensor:
    """``n_p`` independent keys ``[n_p, 2]``, one per ensemble member."""
    return fold_in(k.reshape(1, 2),
                   torch.arange(n_p, dtype=torch.int64, device=k.device))

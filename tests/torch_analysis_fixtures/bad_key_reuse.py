"""Violating fixture: one threefry key drawn from twice on one path,
and a key made outside a loop drawn from inside it."""

from fastconsensus_tpu_torch.utils import prng


def jitter(key, n):
    a = prng.uniform(key, (n,))
    b = prng.bits(key, (n,))              # second draw, same key
    return a, b


def sweeps(key, n, rounds):
    out = []
    for _ in range(rounds):
        out.append(prng.bernoulli(key, 0.5, (n,)))   # same key each turn
    return out

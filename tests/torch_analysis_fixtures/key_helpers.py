"""Helper module for the cross-module key-reuse fixtures: one helper
that draws from its key, one that only derives."""

from fastconsensus_tpu_torch.utils import prng


def noise(key, n):
    return prng.uniform(key, (n,))        # one draw


def fan(key, n):
    return prng.split(key, n)             # derive-only

"""Violating fixture: the key reaches two draws through a helper of
another module (key_helpers.noise draws from its key argument)."""

from key_helpers import noise


def perturb(key, x):
    n = x.shape[0]
    return x + noise(key, n) + noise(key, n)

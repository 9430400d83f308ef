"""Clean twin of bad_key_reuse.py: a subkey per draw, and a key folded
with the loop index inside the loop."""

from fastconsensus_tpu_torch.utils import prng


def jitter(key, n):
    k1, k2 = prng.split(key, 2)
    return prng.uniform(k1, (n,)), prng.bits(k2, (n,))


def sweeps(key, n, rounds):
    out = []
    for it in range(rounds):
        sub = prng.fold_in(key, it)
        out.append(prng.bernoulli(sub, 0.5, (n,)))
    return out

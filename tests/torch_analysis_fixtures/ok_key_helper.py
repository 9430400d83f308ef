"""Clean twin of bad_key_helper.py: key_helpers.fan only derives, so it
may see the key twice; each draw gets its own subkey."""

from key_helpers import fan, noise


def perturb(key, x):
    n = x.shape[0]
    subs = fan(key, 2)
    again = fan(key, 2)                   # derive-only: safe
    return x + noise(subs[0], n) + noise(again[1], n)

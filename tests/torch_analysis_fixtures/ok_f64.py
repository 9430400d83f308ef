"""Clean twin of bad_f64.py: float32 on the device; float64 only on the
host, in numpy, and where it buys exactness, with its pragma."""

import numpy as np
import torch


def totals(w, n):
    out = torch.zeros(n, dtype=torch.float32)
    return out + w


def host_sum(values):
    return np.asarray(values, dtype=np.float64).sum()


def exact_sum(w):
    # fcheck: ok=f64-dtype (integer weights summed exactly in any order)
    return w.double().sum().to(torch.float32)

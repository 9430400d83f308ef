"""Violating fixture: float64 tensors with no reason given."""

import torch


def totals(w, n):
    out = torch.zeros(n, dtype=torch.float64)
    return out + w.double()


def scale(x):
    return x.to(torch.double) * 2.0

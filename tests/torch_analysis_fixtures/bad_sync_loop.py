"""Violating fixture: host syncs inside a Python loop over device work:
a readback each iteration and a device-wide barrier each iteration."""

import torch


def converge(x, steps):
    for _ in range(steps):
        x = x * 0.5
        if x.abs().max().item() < 1e-3:   # sync per iteration
            break
    return x


def collect(chunks):
    out = []
    for c in chunks:
        out.extend(c.tolist())            # readback per chunk
        torch.cuda.synchronize()          # barrier per chunk
    return out

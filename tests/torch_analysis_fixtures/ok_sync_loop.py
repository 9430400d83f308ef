"""Clean twin of bad_sync_loop.py: the loop stays on the device and one
readback follows it."""

import torch


def converge(x, steps):
    for _ in range(steps):
        x = x * 0.5
    return x, x.abs().max().item()


def collect(chunks):
    return torch.cat(list(chunks)).tolist()

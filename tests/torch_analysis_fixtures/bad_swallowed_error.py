"""Violating fixture: an out-of-memory on the card eaten silently."""

import logging

import torch

_logger = logging.getLogger(__name__)


def try_batch(run, jobs):
    try:
        run(jobs)
    except torch.cuda.OutOfMemoryError:
        _logger.warning("batch ran out of memory")   # a log is no outlet
    return jobs

"""Clean twin of bad_swallowed_error.py: the failure is counted and the
jobs go back to run alone."""

import torch


def try_batch(run, jobs, reg):
    try:
        run(jobs)
    except torch.cuda.OutOfMemoryError:
        reg.inc("serve.batch.oom_splits")
        return [[j] for j in jobs]
    return [jobs]

"""Violating fixture: a kernel-source file opened outside 'with', whose
close is skipped when the check between open and close raises."""


def read_kernel(path):
    fh = open(path, encoding="utf-8")
    text = fh.read()
    if "__global__" not in text:
        raise ValueError(f"{path}: no CUDA kernel in it")
    fh.close()
    return text

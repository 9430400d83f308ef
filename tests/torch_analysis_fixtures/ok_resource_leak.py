"""Clean twin of bad_resource_leak.py."""


def read_kernel(path):
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if "__global__" not in text:
        raise ValueError(f"{path}: no CUDA kernel in it")
    return text

"""``torch.cuda.max_memory_allocated()`` over the window, in GiB: the
program's live tensors at their high water, the part of
``peak_reserved_gib`` that is not the allocator's cache or a pool."""


def read(facts):
    peak = facts.get("peak_allocated_bytes")
    return None if peak is None else peak / 2 ** 30

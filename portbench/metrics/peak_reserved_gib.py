"""``torch.cuda.max_memory_reserved()`` over the window, in GiB: the
allocator's cache and every pool the program holds from the card."""


def read(facts):
    peak = facts.get("peak_reserved_bytes")
    return None if peak is None else peak / 2 ** 30

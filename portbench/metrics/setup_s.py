"""Seconds from the process's start to the window's opening: imports,
the card's context, loading the extensions (compiling them on a
checkout's first run), making the inputs and the warm-up."""


def read(facts):
    return facts["setup_s"]

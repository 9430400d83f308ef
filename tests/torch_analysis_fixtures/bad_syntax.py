"""Violating fixture: a file that does not parse."""


def broken(:
    return 1

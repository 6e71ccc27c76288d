"""Queries answered in the window, over the window's length."""

from wqlbench.readers import applies, rate


def read(run):
    return rate(run) if applies(run, "queries") else None

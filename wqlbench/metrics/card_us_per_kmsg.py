"""Microseconds in which the card ran any op, per 1,000 LocalMessages
dispatched in the window: the card time the fan-out of the whole window
cost, over all its messages."""

from wqlbench.readers import applies, card_us_per_k


def read(run):
    return card_us_per_k(run) if applies(run, "local") else None

"""Dispatch start to collected, per window tick, 95th percentile."""

from wqlbench.readers import applies, tick_p95_ms


def read(run):
    return tick_p95_ms(run) if applies(run, "queries") else None

"""Host wall of ``collect_local_batch`` on the collect worker (device
wait, fetch, decode; for queries the fold), mean per window tick."""

from wqlbench.readers import applies, span_mean_ms


def read(run):
    return span_mean_ms(run, "collect") if applies(run, "local") else None

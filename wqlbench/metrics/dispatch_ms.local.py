"""Host wall of ``dispatch_staged_batch`` (flush, encode, H2D, launch;
for queries the kind expansion too), mean per window tick."""

from wqlbench.readers import applies, span_mean_ms


def read(run):
    return span_mean_ms(run, "dispatch") if applies(run, "local") else None

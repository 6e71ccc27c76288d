"""Host wall of a tick's subscription moves (bulk remove, bulk add,
flush), mean per window tick; nothing where the mix moves no one."""

from wqlbench.readers import applies, span_mean_ms


def read(run):
    return span_mean_ms(run, "mutate") if applies(run, "local") else None

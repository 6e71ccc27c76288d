"""100 x (1 - union of the device's activity intervals / window), from
the profiler's trace of the window."""

from wqlbench.readers import applies, device_idle_pct


def read(run):
    return device_idle_pct(run) if applies(run, "local") else None

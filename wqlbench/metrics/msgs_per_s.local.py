"""LocalMessages whose recipient lists were collected in the window,
over the window's length: the host-paced rate of the pipeline."""

from wqlbench.readers import applies, rate


def read(run):
    return rate(run) if applies(run, "local") else None

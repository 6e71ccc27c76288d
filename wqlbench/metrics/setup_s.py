"""Set-up: process start to window open (imports, crowd, bulk load,
warm-up ticks of the cell's own batch shape)."""


def read(run):
    return run.setup_s

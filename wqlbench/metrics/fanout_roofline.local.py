"""The fan-out's share of the card's bandwidth roofline: the bytes the
window's batches need (``roofline.fanout_bytes``) at peak bandwidth,
over the device time the fan-out's own launches took."""

from wqlbench.readers import applies, fanout_roofline_pct


def read(run):
    return fanout_roofline_pct(run) if applies(run, "local") else None

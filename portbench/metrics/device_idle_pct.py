"""device_idle_pct: the share of a profiled slice of rounds in which no kernel
ran on the card, the mean over the cell's cards; it serves every metric
named device_idle_pct.<variant>."""
from portbench.harness.readers import device_idle as read  # noqa: F401

"""local_update_ms: one card's share of a cohort's H local SGD steps at the
cell's shapes, timed alone; it serves every metric named
local_update_ms.<variant>."""
from portbench.harness.readers import layer_ms

read = layer_ms("local_update_ms")

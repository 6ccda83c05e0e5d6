"""local_update_span_ms: the cohort's vmapped local steps in each round, as the
program's device stamps time it inside the round (the stamped recorded
slice), mean ms a round; it serves every metric named
local_update_span_ms.<variant>."""
from portbench.harness.span_readers import device_span_ms

read = device_span_ms("local_update")

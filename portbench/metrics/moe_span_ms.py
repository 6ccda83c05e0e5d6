"""moe_span_ms: every MoE layer's forward and backward in each round, as the
program's device stamps time it inside the round (the stamped recorded
slice), mean ms a round; it serves every metric named moe_span_ms.<variant>."""
from portbench.harness.span_readers import device_span_ms

read = device_span_ms("moe")

"""moe_layer_ms: one MoE layer, forward and backward, on one client step's
tokens, timed alone; it serves every metric named moe_layer_ms.<variant>."""
from portbench.harness.readers import layer_ms

read = layer_ms("moe_layer_ms")

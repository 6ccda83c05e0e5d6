"""sample_ms: one round's keyed cohort draw and its minibatch index draws,
timed alone; it serves every metric named sample_ms.<variant>."""
from portbench.harness.readers import layer_ms

read = layer_ms("sample_ms")

"""gather_ms: one round's gather of the cohort's minibatches from the packed
corpus, timed alone; it serves every metric named gather_ms.<variant>."""
from portbench.harness.readers import layer_ms

read = layer_ms("gather_ms")

"""server_step_ms: the fused FedMom server step on the cell's tree, timed
alone; it serves every metric named server_step_ms.<variant>."""
from portbench.harness.readers import layer_ms

read = layer_ms("server_step_ms")

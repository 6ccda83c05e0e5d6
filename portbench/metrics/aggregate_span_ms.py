"""aggregate_span_ms: each round's weighted delta (the secure or mesh reduction
included), as the program's device stamps time it inside the round (the
stamped recorded slice), mean ms a round; it serves every metric named
aggregate_span_ms.<variant>."""
from portbench.harness.span_readers import device_span_ms

read = device_span_ms("aggregate")

"""sample_span_ms: the keyed cohort draw of each round
(`sampler.sample_device`), as the program's device stamps time it inside the
round (the stamped recorded slice), mean ms a round; it serves every metric
named sample_span_ms.<variant>."""
from portbench.harness.span_readers import device_span_ms

read = device_span_ms("sample")

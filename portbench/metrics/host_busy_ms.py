"""host_busy_ms: the host's ms a round inside the trainer's run call, less
its waits for the card, from the program's host spans (the stamped
recorded slice); it serves every metric named host_busy_ms.<variant>."""
from portbench.harness.span_readers import host_busy as read  # noqa: F401

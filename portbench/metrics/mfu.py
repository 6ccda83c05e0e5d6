"""mfu: the round's analytic model flops over the slice's wall time, as a share
of the data-sheet peak of the configuration's compute precision times the
cards; it serves every metric named mfu.<variant>."""
from portbench.harness.readers import mfu as read  # noqa: F401

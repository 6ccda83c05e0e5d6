"""idle_on_host_pct: the share of a profiled slice in which no kernel ran
on the card and the host was inside a program span other than a wait;
it serves every metric named idle_on_host_pct.<variant>."""
from portbench.harness.span_readers import (  # noqa: F401
    idle_on_host as read)

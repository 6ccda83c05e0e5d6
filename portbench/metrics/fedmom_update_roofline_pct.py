"""fedmom_update_roofline_pct: the fused FedMom server step's least time (20
bytes an element at 3.35 TB/s) over its profiled device time a round; it
serves every metric named fedmom_update_roofline_pct.<variant>."""
from portbench.harness.readers import (  # noqa: F401
    fedmom_update_roofline as read)

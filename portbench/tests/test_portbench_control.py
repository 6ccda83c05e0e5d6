"""The comparison that decides ``correct`` fails what it must: the
control (the reference in the program's place, its products in TF32)
reads above the program's own gaps, and a run
with the timed path broken underneath comes out not correct, once for
each fault a training cell can have: the server step returning its state
unchanged, half of each minibatch left out (the mean taken over the
rest), and, on a mesh, the exchange between the ranks left out."""
import time

import pytest
import torch

from _tiny import GRANITE, LENET, one_thread, tiny  # noqa: F401
from portbench.harness import cell as cell_lib

CPU = torch.device("cpu")
SEED = 3_000_000_123


@pytest.mark.parametrize("name", [LENET, GRANITE])
def test_control_reads_above_the_program(name):
    """At a tiny size, free of route and max-pool flips, the control reads
    far above the program in every row; at the cells' own sizes on the
    card flips raise the sound runs' row median too, and the control
    still reads 4x (LeNet) and 11x (granite) above their largest
    (PERF.md)."""
    cell = tiny(name)
    control = cell_lib.control_numbers(cell, SEED, CPU, "tf32")
    sound = cell_lib.check_numbers(cell, SEED, CPU)
    assert (control["grad_row_median_gap"]
            > 10 * sound["grad_row_median_gap"])
    assert control["grad_gap"] > 10 * sound["grad_gap"]


@pytest.mark.parametrize("name, fault, ranks", [
    (LENET, "state_unchanged", None),
    (LENET, "half_batch", None),
    (GRANITE, "half_batch", None),
    (GRANITE, "no_exchange", 2),
])
def test_broken_run_is_not_correct(name, fault, ranks):
    cell = tiny(name, ranks=ranks)
    out = cell_lib.run(cell, SEED, 0.2, False, CPU, time.time(),
                       fault=fault)
    assert not out["correct"], out["checks"]


def test_row_median_sees_a_shift_and_not_a_few_flips():
    """The row median ignores a handful of rows moved far (a max-pool or
    route flip) and reads a small shift of every row (a lower
    precision); rows with no gradient in the reference are not counted."""
    from portbench.harness.check import row_median_gap
    g = torch.Generator().manual_seed(0)
    ref = {"a": torch.rand(400, generator=g) + 0.5,
           "b": torch.cat([torch.zeros(50), torch.rand(50, generator=g)
                           + 0.5])}
    flipped = {k: v.clone() for k, v in ref.items()}
    flipped["a"][:5] *= 2.0
    flipped["b"][:50] = 3.0                # rows the reference does not move
    assert row_median_gap(flipped, ref, ["a", "b"]) == 0.0
    shifted = {k: v * (1 + 1e-4) for k, v in ref.items()}
    assert abs(row_median_gap(shifted, ref, ["a", "b"]) - 1e-4) < 1e-5
    assert row_median_gap({"a": ref["a"][:10]}, ref, ["a"]) == float("inf")

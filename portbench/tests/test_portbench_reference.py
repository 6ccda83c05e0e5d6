"""The plain reference agrees with the port on the CPU at tiny sizes: a
LeNet round on the device plane and a 2-layer granite round on the
per-round plane, driven through the harness's own run; its threefry draws
are the port's bit for bit."""
import time

import numpy as np
import pytest
import torch

from _tiny import GRANITE, LENET, one_thread, tiny  # noqa: F401
from portbench.harness import cell as cell_lib
from portbench.reference import threefry

CPU = torch.device("cpu")
SEED = 2 ** 33 + 7           # wider than 32 bits, as the driver's are


def test_threefry_draws_are_the_ports():
    from repro_torch import random as prng
    from repro_torch.core.sampling import ClientPopulation, \
        DeviceUniformSampler
    from repro_torch.data.federated import minibatch_indices
    counts = np.random.default_rng(0).integers(2, 800, 3550)
    sampler = DeviceUniformSampler(ClientPopulation(counts), 32, seed=77)
    for t in (0, 1, 9):
        assert (sampler.sample(t)[0]
                == threefry.cohort(77, t, 3550, 32)).all()
    key = prng.PRNGKey(-5)
    for t, c, n in ((0, 5, 17), (3, 3549, 765), (2, 0, 2)):
        assert (minibatch_indices(key, t, c, n, 100).numpy()
                == threefry.minibatch_rows(-5, t, c, n, 100)).all()


@pytest.mark.parametrize("name, tol", [(LENET, 1e-5), (GRANITE, 1e-5)])
def test_reference_agrees_with_the_port(name, tol):
    cell = tiny(name)
    cell.config["precision"]["client_compute"] = "float32"
    out = cell_lib.run(cell, SEED, 0.2, False, CPU, time.time())
    nums = out["_numbers"]
    assert out["correct"], out["checks"]
    assert nums["ids_mismatch"] == 0
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert nums[k] < tol, (k, nums[k])
    assert {"setup_s", "peak_mem_gb"} <= set(out["metrics"])
    assert any(k.startswith("round_ms.") for k in out["metrics"])
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert [k for k in out if not k.startswith("_")][-1] == "checks"


def test_mesh_rounds_agree_with_the_reference():
    cell = tiny(GRANITE, ranks=2)
    out = cell_lib.run(cell, SEED, 0.2, False, CPU, time.time())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2

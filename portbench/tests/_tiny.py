"""Tiny copies of the benchmark's cells for CPU tests: the real cell's
files, with the sizes cut so that a run takes seconds."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench.harness.spec import load_cell  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes gain nothing from many threads, and the suite runs its
    workers side by side: one thread while a test of a module that
    imports this fixture runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)

LENET = "lenet-femnist.leaf-m32-device"
GRANITE = "granite-moe-1b-a400m.ft-s1024-m2"


def tiny(name: str, ranks: int = None):
    cell = copy.deepcopy(load_cell(name))
    if cell.config["family"] == "lenet":
        cell.mix.update(clients=40, m=4, local_steps=2, b=5, chunk_rounds=2,
                        check_rounds=3)
    else:
        cell.config["model"].update(n_layers=2, d_model=64, n_heads=4,
                                    n_kv_heads=2, d_head=16, d_ff=32,
                                    vocab=128, n_experts=4, top_k=2)
        cell.mix.update(clients=8, tokens_per_client=600, seq=32)
        if ranks:
            cell.mix.update(mesh_ranks=ranks, m=2 * ranks)
    return cell

"""The analytic flop counts behind ``mfu``, and the weight layouts the
benchmark makes against the port's own."""
import math

import pytest
import torch

from _tiny import GRANITE, LENET, tiny
from portbench.harness import flops, weights
from portbench.harness.families import family
from portbench.harness.spec import load_cell


def test_lenet_forward_flops():
    # conv1 172,800 + conv2 307,200 + fc1 61,440 + fc2 14,880
    assert flops.lenet_forward_flops(28, 62) == 556_320
    cell = load_cell(LENET)
    assert flops.lenet_round_flops(cell.config, cell.mix) == \
        3 * 556_320 * 32 * 10 * 10


def test_granite_flops_per_token():
    m = load_cell(GRANITE).config["model"]
    assert flops.moe_lm_active_params(m) == 428_608_512
    assert flops.moe_lm_train_flops_per_token(m, 1024) == 2_873_640_960
    cell = load_cell(GRANITE)
    assert flops.moe_lm_round_flops(cell.config, cell.mix) == \
        2 * 2 * 2 * 1024 * 2_873_640_960


def _program_shapes(fam):
    """The port's own parameter tree for the configuration, on meta."""
    if fam.config["family"] == "lenet":
        from repro_torch import random as prng
        from repro_torch.models import small
        tree = small.lenet_init(prng.PRNGKey(0),
                                n_classes=fam.model["n_classes"])
    else:
        from repro_torch.models import transformer as T
        tree, _ = T.abstract_params(fam.model_config())
    return {k: tuple(v.shape) for k, v in weights.flatten(tree).items()}


@pytest.mark.parametrize("name, total", [(LENET, 40_914),
                                         (GRANITE, 1_384_963_072)])
def test_weight_layout_is_the_ports(name, total):
    cell = load_cell(name)
    fam = family(cell.config, cell.mix)
    shapes = {k: tuple(v) for k, v in fam.shapes().items()}
    assert shapes == _program_shapes(fam)
    assert flops.tree_elements(shapes) == total
    assert sum(math.prod(s) for s in shapes.values()) == total


@pytest.mark.parametrize("name", [LENET, GRANITE])
def test_weights_redrawn_leaf_by_leaf(name):
    cell = tiny(name)
    fam = family(cell.config, cell.mix)
    shapes = fam.shapes()
    cpu = torch.device("cpu")
    whole = weights.draw(shapes, fam.rule, 12345, cpu)
    for path in shapes:
        assert torch.equal(whole[path],
                           weights.draw_leaf(shapes, fam.rule, 12345, path,
                                             cpu))
    other = weights.draw(shapes, fam.rule, 12346, cpu)
    assert any(not torch.equal(whole[p], other[p]) for p in shapes
               if whole[p].abs().sum() > 0)

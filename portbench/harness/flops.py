"""Analytic model flops of a federated round, fixed here so that a change
that removes wasted work (a dense MoE dispatch, a recompute) cannot lower
the count: ``mfu`` divides these by the time and the peak.

Training counts 3x the forward (the backward's two products per forward
product), and a round trains ``M`` clients for ``H`` local steps of ``b``
examples.
"""
from __future__ import annotations

import math


def lenet_forward_flops(image_hw: int = 28, n_classes: int = 62) -> int:
    """Multiply-adds x 2 of LeNet-5 on one image: conv 5x5 1->6 over 24x24,
    conv 5x5 6->16 over 8x8, dense 256->120, dense 120->classes."""
    o1 = image_hw - 4                        # 24
    conv1 = 2 * o1 * o1 * 6 * 5 * 5 * 1
    o2 = o1 // 2 - 4                         # 8
    conv2 = 2 * o2 * o2 * 16 * 5 * 5 * 6
    side = o2 // 2                           # 4
    fc1 = 2 * side * side * 16 * 120
    fc2 = 2 * 120 * n_classes
    return conv1 + conv2 + fc1 + fc2


def lenet_round_flops(config: dict, mix: dict) -> int:
    per_image = 3 * lenet_forward_flops(config["model"]["image_hw"],
                                        config["model"]["n_classes"])
    return per_image * mix["m"] * mix["local_steps"] * mix["b"]


def moe_lm_active_params(m: dict) -> int:
    """Parameters one token's forward multiplies by: per layer the
    attention projections, the router and its top-k experts; the untied
    output head.  Norms and the embedding gather are not products."""
    D, Dh = m["d_model"], m["d_head"]
    attn = D * m["n_heads"] * Dh * 2 + D * m["n_kv_heads"] * Dh * 2
    router = D * m["n_experts"]
    experts = m["top_k"] * 3 * D * m["d_ff"]
    return m["n_layers"] * (attn + router + experts) + D * m["vocab"]


def moe_lm_train_flops_per_token(m: dict, seq: int) -> int:
    """6 N_active + 12 L d_attn S: the products with the weights, forward
    and backward, plus causal-blind attention scores and values
    (``d_attn = n_heads * d_head``)."""
    d_attn = m["n_heads"] * m["d_head"]
    return (6 * moe_lm_active_params(m)
            + 12 * m["n_layers"] * d_attn * seq)


def moe_lm_round_flops(config: dict, mix: dict) -> int:
    tokens = mix["m"] * mix["local_steps"] * mix["b"] * mix["seq"]
    return tokens * moe_lm_train_flops_per_token(config["model"],
                                                 mix["seq"])


def tree_elements(shapes: dict) -> int:
    return sum(math.prod(s) for s in shapes.values())

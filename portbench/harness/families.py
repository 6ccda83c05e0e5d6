"""What differs between model families: the weight layout, the corpus, the
program's trainer, and the reference's loss and batches.

A family is picked by a configuration's ``family`` key.  ``lenet`` is the
paper's LeNet-5 on synthetic FEMNIST; ``moe_lm`` is a decoder-only MoE
language model (``repro_torch.models.transformer``) on per-client token
streams.  Both train through ``FederatedTrainer`` with FedMom on the
server (its fused ``fedmom_update`` kernel on the card) and SGD on the
clients, eta = K / M.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from . import corpus, flops, weights


@dataclass
class Seeds:
    """Every draw of a run, derived from ``--seed`` (any whole number)."""
    weights: int
    corpus: int
    sample: int        # the program's keyed cohort draws (32 bits)
    data: int          # the program's keyed minibatch draws (32 bits)

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        ss = np.random.SeedSequence(int(seed) & ((1 << 128) - 1))
        w, c, s, d = ss.generate_state(4, dtype=np.uint32)
        return cls(int(w), int(c), int(s) & 0x7FFFFFFF, int(d) & 0x7FFFFFFF)


@dataclass
class Corpus:
    program: list          # per-client dicts of host arrays the program takes
    counts: np.ndarray     # [K] rows (examples) a client
    raw: Any               # what the reference rebuilds its clients from


class Lenet:
    rule = staticmethod(weights.lenet_rule)

    def __init__(self, config: dict, mix: dict):
        self.config, self.mix = config, mix
        self.model = config["model"]

    def shapes(self) -> dict:
        from ..reference import lenet
        return lenet.shapes(self.model["n_classes"])

    def make_corpus(self, seeds: Seeds, device) -> Corpus:
        clients, counts, images, labels = corpus.femnist(
            self.config["corpus"], self.mix["clients"],
            self.model["n_classes"], self.model["image_hw"], seeds.corpus,
            device)
        return Corpus(clients, counts, (images, labels))

    def round_flops(self) -> int:
        return flops.lenet_round_flops(self.config, self.mix)

    def program_loss(self) -> Callable:
        from repro_torch.models import small
        return small.lenet_loss

    # -- the reference's side --------------------------------------------
    def ref_clients(self, corp: Corpus, device) -> list:
        images, labels = corp.raw
        x = torch.as_tensor(images, device=device)
        y = torch.as_tensor(labels, device=device)
        offs = np.concatenate([[0], np.cumsum(corp.counts)])
        return [{"x": x[offs[k]:offs[k + 1]], "y": y[offs[k]:offs[k + 1]]}
                for k in range(len(corp.counts))]

    def ref_loss(self) -> Callable:
        from ..reference import lenet
        return lenet.loss

    def ref_batches(self) -> Callable:
        from ..reference import lenet
        return lenet.batches


class MoeLM:
    rule = staticmethod(weights.moe_lm_rule)

    def __init__(self, config: dict, mix: dict):
        self.config, self.mix = config, mix
        self.model = config["model"]

    def shapes(self) -> dict:
        from ..reference import moe_lm
        return moe_lm.shapes(self.model)

    def make_corpus(self, seeds: Seeds, device) -> Corpus:
        streams = corpus.token_streams(self.config["corpus"],
                                       self.mix["clients"],
                                       self.model["vocab"],
                                       self.mix["tokens_per_client"],
                                       seeds.corpus)
        from repro_torch.data.federated import lm_clients_to_dataset
        ds = lm_clients_to_dataset(streams, self.mix["seq"])
        return Corpus(ds.data, ds.counts(), streams)

    def round_flops(self) -> int:
        return flops.moe_lm_round_flops(self.config, self.mix)

    def model_config(self):
        from repro_torch.models.config import ModelConfig, MoEConfig
        m = self.model
        return ModelConfig(
            name=self.config["name"], family="moe",
            n_layers=m["n_layers"], d_model=m["d_model"],
            n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
            d_head=m["d_head"], d_ff=m["d_ff"], vocab=m["vocab"],
            moe=MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"],
                          capacity_factor=m["capacity_factor"],
                          aux_loss_weight=m["aux_loss_weight"]),
            act="swiglu", rope_theta=m["rope_theta"],
            norm_eps=m["norm_eps"], tie_embeddings=m["tie_embeddings"],
            dtype=self.config["precision"]["client_compute"],
            remat=m["remat"])

    def program_loss(self) -> Callable:
        from repro_torch.models import transformer as T
        cfg = self.model_config()

        def loss_fn(params, batch):
            return T.loss_fn(params, cfg, batch)
        return loss_fn

    def ref_clients(self, corp: Corpus, device) -> list:
        from ..reference import moe_lm
        out = []
        for s in corp.raw:
            ex = moe_lm.examples(s, self.mix["seq"])
            out.append({k: torch.as_tensor(v, device=device)
                        for k, v in ex.items()})
        return out

    def ref_loss(self) -> Callable:
        from ..reference import moe_lm
        m = self.model

        def loss(p, batch, prec):
            return moe_lm.loss(p, batch, m, prec)
        return loss

    def ref_batches(self) -> Callable:
        from ..reference import moe_lm
        return moe_lm.batches


FAMILIES = {"lenet": Lenet, "moe_lm": MoeLM}


def family(config: dict, mix: dict):
    try:
        return FAMILIES[config["family"]](config, mix)
    except KeyError:
        raise KeyError(f"unknown model family {config['family']!r}: known "
                       f"{sorted(FAMILIES)}") from None

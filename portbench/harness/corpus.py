"""The traffic generator: per-client corpora made from the seed.

One generator serves every mix; the configuration's ``corpus.kind`` picks
the data form and the mix gives its scale.

* ``femnist``: synthetic FEMNIST at LEAF's shape (Caldas et al., arXiv
  1812.01097): 28x28x1 images of ``n_classes`` classes, K writers whose
  sizes are lognormal with the paper's Table 2 mean and deviation (one
  set of sizes, drawn from ``sizes_seed``, dealt to the writers in the
  run seed's order); each
  image is its class prototype (a smoothed random blob) plus its writer's
  style offset plus pixel noise, and each writer's labels follow its own
  Dirichlet(``label_alpha``) prior.  The images are drawn on the device
  in a few large calls, then handed to the program as per-writer host
  arrays (views of one buffer), as its ``FederatedDataset`` takes them.
* ``tokens``: K clients' token streams, each from its own permutation of
  a Zipf(``skew``) unigram over the vocabulary (non-IID but cheap).

The same seed gives the same corpus.  The system's own generators
(``repro_torch.data.synthetic``) make the same kinds of data; these are
the benchmark's frozen copies.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_ROWS = 1 << 17          # images drawn a call


def lognormal_sizes(n: int, mean: float, std: float,
                    rng: np.random.Generator) -> np.ndarray:
    sigma2 = np.log(1.0 + (std / mean) ** 2)
    mu = np.log(mean) - sigma2 / 2.0
    sizes = rng.lognormal(mu, np.sqrt(sigma2), size=n)
    return np.maximum(sizes.round().astype(np.int64), 2)


def femnist(spec: dict, n_clients: int, n_classes: int, hw: int, seed: int,
            device) -> tuple:
    """``(clients, counts, images, labels)``: per-client dicts ``{"x":
    [n_k, hw, hw, 1] float32, "y": [n_k] int32}`` (views into the host
    arrays ``images`` and ``labels``) and the [K] sizes."""
    rng = np.random.default_rng(seed)
    # one set of writer sizes for every seed (the packed corpus, and so the
    # memory and the work, do not move with the seed), dealt out in the
    # seed's order
    sizes = lognormal_sizes(n_clients, spec["mean"], spec["std"],
                            np.random.default_rng(spec["sizes_seed"]))
    counts = rng.permutation(sizes)
    priors = rng.dirichlet(np.full(n_classes, spec["label_alpha"]),
                           size=n_clients)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    protos = torch.randn((n_classes, 1, hw, hw), generator=g, device=device)
    protos = F.avg_pool2d(F.pad(protos, (1, 1, 1, 1), mode="replicate"), 3,
                          stride=1).permute(0, 2, 3, 1).contiguous()
    style = spec["writer_style"] * torch.randn((n_clients, hw, hw, 1),
                                               generator=g, device=device)
    draws = torch.multinomial(torch.as_tensor(priors, dtype=torch.float32,
                                              device=device),
                              int(counts.max()), replacement=True,
                              generator=g)
    cnt = torch.as_tensor(counts, device=device)
    keep = torch.arange(draws.shape[1], device=device)[None] < cnt[:, None]
    labels = draws[keep]
    owner = torch.repeat_interleave(torch.arange(n_clients, device=device),
                                    cnt)
    n = int(counts.sum())
    images = torch.empty((n, hw, hw, 1), dtype=torch.float32,
                         device="cpu", pin_memory=device.type == "cuda")
    for lo in range(0, n, _ROWS):
        hi = min(lo + _ROWS, n)
        block = (protos[labels[lo:hi]] + style[owner[lo:hi]]
                 + spec["image_noise"] * torch.randn(
                     (hi - lo, hw, hw, 1), generator=g, device=device))
        images[lo:hi].copy_(block)
    images = images.numpy()
    labels = labels.to(torch.int32).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(counts)])
    clients = [{"x": images[offs[k]:offs[k + 1]],
                "y": labels[offs[k]:offs[k + 1]]}
               for k in range(n_clients)]
    return clients, counts, images, labels


def token_streams(spec: dict, n_clients: int, vocab: int, tokens: int,
                  seed: int) -> list:
    """K int32 streams of ``tokens`` tokens."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** spec["skew"]
    out = []
    for _ in range(n_clients):
        p = base[rng.permutation(vocab)] / base.sum()
        out.append(rng.choice(vocab, size=tokens, p=p).astype(np.int32))
    return out

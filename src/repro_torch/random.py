"""Keyed threefry2x32 random numbers, bit-equal to ``jax.random``.

The JAX package keys every draw of the system by ``(seed, t, client_id)``
through ``jax.random``: minibatch indices (``data/federated.py``), the keyed
client samplers (``core/sampling.py``) and the central-DP noise
(``core/server_opt.py``).  This module reproduces those draws bit for bit
with the semantics of the installed JAX (0.9, ``jax_threefry_partitionable``
on, 64-bit mode off):

* a key is an ``int64`` tensor of shape ``(..., 2)`` holding the two uint32
  words of the raw JAX key (``jax.random.key_data``); leading dimensions
  batch keys the way ``jax.vmap`` would;
* ``fold_in(k, d)`` and the i-th key of ``split(k, n)`` both hash the
  64-bit counter ``(0, d)`` / ``(0, i)`` under ``k``;
* ``random_bits`` hashes the row-major iota of the output shape, split
  into high and low words, and XORs the two output words.

Torch has no ``add`` for ``uint32``, so the arithmetic runs in ``int64``
masked to 32 bits.  It runs on whichever device the key lives on; plain
Python ints (a round index, a bound) stay host scalars, so a draw on the
card copies nothing from the host.

``normal`` goes through ``erfinv``, which XLA and torch evaluate with
different polynomials: it is equal to JAX within a few float32 ulps, not
bit for bit.  Everything else here is bit-equal.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) on uint32 words held in int64.

    Arguments broadcast against each other; returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is taken
    as a 32-bit integer, giving the key words ``(0, seed mod 2**32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise TypeError(
            f"a key is an int64 tensor of shape (..., 2), got "
            f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _int_or_tensor(x, device):
    """A Python int stays a host scalar; anything else becomes an int64
    tensor on ``device``."""
    if isinstance(x, int):
        return x
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Mix ``data`` (an int, or integers broadcasting against the key's
    batch shape: a vector of round indices or client ids) into ``key``."""
    k0, k1 = _words(key)
    d = _int_or_tensor(data, key.device) & _M32
    y0, y1 = threefry2x32(k0, k1, 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape ``(..., num, 2)``."""
    k0, k1 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], i >> 32, i & _M32)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Uniform 32-bit words (as int64), shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _words(key)
    lead = k0.shape
    tail = (1,) * len(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    y0, y1 = threefry2x32(k0.reshape(lead + tail), k1.reshape(lead + tail),
                          idx >> 32, idx & _M32)
    return y0 ^ y1


def randint(key: torch.Tensor, shape: Sequence[int], minval,
            maxval) -> torch.Tensor:
    """``jax.random.randint`` into int32, with JAX's modulus construction:
    two 32-bit streams from ``split(key)`` combined through
    ``multiplier = (2**16 mod span)**2 mod span`` in wrapping uint32
    arithmetic.  ``minval`` / ``maxval`` broadcast against
    ``key.shape[:-1] + shape`` (a per-key bound needs trailing unit axes)."""
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    lo_v = _int_or_tensor(minval, key.device)
    hi_v = _int_or_tensor(maxval, key.device)
    if isinstance(lo_v, int) and isinstance(hi_v, int):
        span = 1 if hi_v <= lo_v else (hi_v - lo_v) & _M32
    else:
        span = (hi_v - lo_v) & _M32
        span = torch.where(hi_v <= lo_v, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (lo_v + off).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds of a stable sort of ``arange(n)`` on fresh 32-bit keys."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    for _ in range(rounds):
        pair = split(key, 2)
        key, sub = pair[0], pair[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def uniform(key: torch.Tensor, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): 23 random mantissa bits under
    exponent 0, minus one, scaled, in float32 arithmetic as XLA does."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard normals, float32: ``sqrt(2) * erfinv(u)`` with ``u`` uniform
    on (-1, 1).  Equal to ``jax.random.normal`` within a few ulps (the two
    frameworks' ``erfinv`` differ)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                         device=key.device)
    return sqrt2 * torch.erfinv(u)

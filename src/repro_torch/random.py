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

``normal`` goes through ``erfinv`` and ``gumbel`` through ``log``, which
XLA and torch evaluate with different polynomials: they are equal to JAX
within a few float32 ulps, not bit for bit.  Everything else here is
bit-equal (``categorical`` too, wherever no two candidates lie within
those ulps of each other).

A float draw from one key of more than ``_CHUNK`` values is computed slice
by slice of its counter, so that drawing a 302 M-element embedding holds
one slice's int64 temporaries at a time, not 2.4 GB each; the counter is
the row-major iota of the shape, so the values are those of one whole
draw.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_CHUNK = 1 << 24           # counters hashed at once by a large float draw


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
    as a 32-bit integer, giving the key words ``(0, seed mod 2**32)``.

    The words are filled in on ``device`` (no copy from the host), so a key
    can be made inside a captured CUDA graph."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1].fill_(seed & _M32)
    return key


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


def random_bits(key: torch.Tensor, shape: Sequence[int],
                span: tuple[int, int] | None = None) -> torch.Tensor:
    """Uniform 32-bit words (as int64), shape ``key.shape[:-1] + shape``.
    With ``span=(start, stop)``, only the words of flat counters ``start``
    to ``stop - 1`` of that draw, shape ``key.shape[:-1] + (stop - start,)``
    (the counter is the row-major iota of ``shape``)."""
    shape = tuple(int(s) for s in shape)
    start, stop = (0, math.prod(shape)) if span is None else span
    out = shape if span is None else (stop - start,)
    k0, k1 = _words(key)
    lead = k0.shape
    tail = (1,) * len(out)
    idx = torch.arange(start, stop, dtype=torch.int64,
                       device=key.device).reshape(out)
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
    rounds of a stable sort of ``arange(n)`` on fresh 32-bit keys.  A batch
    of keys ``(..., 2)`` gives one permutation a key, ``(..., n)``, each
    the one its key alone gives (the sorts are per row)."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        pair = split(key, 2)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def _float_draw(key: torch.Tensor, shape: Sequence[int],
                fn) -> torch.Tensor:
    """``fn(random_bits(key, shape))`` for an elementwise ``fn`` into
    float32.  One key's draw is hashed ``_CHUNK`` counters at a time (the
    same values, a bounded peak); batched keys draw whole."""
    shape = tuple(int(s) for s in shape)
    if key.dim() > 1:
        return fn(random_bits(key, shape))
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        out[start:stop] = fn(random_bits(key, shape, (start, stop)))
    return out.reshape(shape)


def _unit_floats(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """32-bit words -> float32 uniforms in [minval, maxval): 23 random
    mantissa bits under exponent 0, minus one, scaled, in float32
    arithmetic as XLA does.  XLA's CPU code fuses the scale and shift into
    one multiply-add, rounded once; so is this one (the float32 product is
    exact in float64, the sum rounded to float32 once).  Over [0, 1), and
    for ``normal``'s range, the product is exact and nothing changes."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    f64 = torch.float64
    scaled = ((f - 1.0).to(f64) * (hi - lo).to(f64) + lo.to(f64)).to(
        torch.float32)
    return torch.maximum(lo, scaled)


def uniform(key: torch.Tensor, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), as ``jax.random.uniform``."""
    return _float_draw(key, shape,
                       lambda bits: _unit_floats(bits, minval, maxval))


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = math.sqrt(2.0)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard normals, float32: ``sqrt(2) * erfinv(u)`` with ``u`` uniform
    on (-1, 1).  Equal to ``jax.random.normal`` within a few ulps (the two
    frameworks' ``erfinv`` differ)."""
    def fn(bits):
        sqrt2 = torch.full((), _SQRT2, dtype=torch.float32,
                           device=bits.device)
        return sqrt2 * torch.erfinv(_unit_floats(bits, _NORMAL_LO, 1.0))
    return _float_draw(key, shape, fn)


_TINY = float(torch.finfo(torch.float32).tiny)


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` rounded once from float64: within half an ulp of the
    exact value, where float32 ``log`` implementations differ by ulps."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, float32: ``-log(-log(u))`` with ``u`` uniform
    on [tiny, 1), as ``jax.random.gumbel`` computes it in its default
    (``"low"``) mode, each ``log`` rounded to float32.  Equal to it within a
    few float32 ulps of ``max(|g|, 1)`` (the two ``log``s; near g = 0 an
    ulp of the inner ``log`` is many ulps of g)."""
    return _float_draw(key, shape, lambda bits: -_log32(
        -_log32(_unit_floats(bits, _TINY, 1.0))))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` with replacement and
    no ``shape``: ``argmax(gumbel(key, logits.shape) + logits)`` over
    ``axis`` (the first index among ties, as JAX takes).  float32 logits
    only: JAX draws the noise in the logits' dtype."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    noise = gumbel(key, logits.shape)
    return torch.argmax(noise + logits, dim=axis)

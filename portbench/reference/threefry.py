"""Keyed threefry2x32 draws in NumPy: the frozen yardstick for the client
sampling and the minibatch rows of a federated round.

A key is a pair of uint32 words ``(k0, k1)``; ``PRNGKey(seed)`` is ``(0,
seed mod 2**32)``.  ``fold_in(key, d)`` and the i-th key of ``split(key, n)``
hash the 64-bit counter ``(0, d)`` / ``(0, i)`` under the key;
``random_bits`` hashes the row-major iota of the output shape and XORs the
two output words.  ``randint`` combines two streams through the modulus
construction ``multiplier = (2**16 mod span)**2 mod span``, and
``permutation`` stable-sorts ``arange(n)`` on fresh words for
``ceil(3 ln n / ln(2**32 - 1))`` rounds.  These are the semantics the
system's keyed draws follow (JAX's ``jax.random`` with 64-bit mode off);
this file is written apart from the system and imports none of it.

Round t's cohort is ``permutation(fold_in(sample_key, t), K)[:M]``; client
c's minibatch rows in round t are ``randint(fold_in(fold_in(data_key, t),
c), (H * b,), 0, n_c)``.
"""
from __future__ import annotations

import math

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def _u64(x):
    return np.asarray(x, dtype=np.uint64)


def _rotl(x, r: int):
    return ((x << np.uint64(r)) & M32) | (x >> np.uint64(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on uint32 words held in uint64 arrays;
    arguments broadcast."""
    k0, k1, x0, x1 = (_u64(a) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int) -> tuple:
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    return (np.uint64(0), np.uint64(seed & 0xFFFFFFFF))


def fold_in(key: tuple, d) -> tuple:
    return threefry2x32(key[0], key[1], 0, _u64(d) & M32)


def split(key: tuple, n: int) -> list:
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key[0], key[1], 0, i)
    return [(y0[j], y1[j]) for j in range(n)]


def random_bits(key: tuple, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key[0], key[1], 0, i)
    return y0 ^ y1


def randint(key: tuple, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` ints uniform in ``[lo, hi)``."""
    k_hi, k_lo = split(key, 2)
    bits_hi = random_bits(k_hi, n)
    bits_lo = random_bits(k_lo, n)
    span = np.uint64(1 if hi <= lo else (hi - lo) & 0xFFFFFFFF)
    mult = np.uint64(2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((bits_hi % span) * mult) & M32) + (bits_lo % span)
    off = (off & M32) % span
    return (lo + off.astype(np.int64)).astype(np.int64)


def permutation(key: tuple, n: int) -> np.ndarray:
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    x = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = np.argsort(random_bits(sub, n), kind="stable")
        x = x[order]
    return x


def cohort(sample_seed: int, t: int, n_clients: int, m: int) -> np.ndarray:
    """Round ``t``'s ``m`` client ids."""
    return permutation(fold_in(PRNGKey(sample_seed), t), n_clients)[:m]


def minibatch_rows(data_seed: int, t: int, client: int, n_rows: int,
                   need: int) -> np.ndarray:
    """Client ``client``'s ``need`` with-replacement row draws in round
    ``t`` from its ``n_rows`` rows."""
    key = fold_in(fold_in(PRNGKey(data_seed), t), client)
    return randint(key, need, 0, n_rows)

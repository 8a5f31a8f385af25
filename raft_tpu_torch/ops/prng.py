"""The parts of ``jax.random`` that simulate mode draws from, bit for bit.

The reference's simulate (``raft_tpu/checker/simulate.py``) draws with
``jax.random`` as ``raft_tpu`` runs it: ``jax_enable_x64`` on
(``raft_tpu/__init__.py``), so ``uniform`` gives float64 and ``randint``
int64, and the threefry2x32 PRNG with ``jax_threefry_partitionable`` on
(the default of jax 0.9), which fixes both the key split
(``_threefry_split_foldlike``) and the counter layout of the random bits
(``iota_2x32_shape``: element i of a flat shape is the 64-bit counter
(0, i)). A key is a pair of u32 words (k1, k2).

Every function takes either Python ints or int64 tensors that hold u32
values (torch has no unsigned 32-bit arithmetic on the CPU), and keeps
each word masked to 32 bits. The kernel of simulate mode
(``csrc/sim_step.cu``) computes the same draws in native u32/u64.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (``jax/_src/prng.py _threefry2x32_lowering``,
    five groups of four rounds) of the counters (x1, x2) under the key
    (k1, k2). Returns the two u32 output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int64 seed: its high and low
    32 bits."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    return s >> 32, s & M32


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` of one key: key i is the threefry
    block of the counter (0, i)."""
    return [tuple(int(w) for w in threefry2x32(key[0], key[1], 0, i)) for i in range(num)]


def random_bits64(key, n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """64 random bits for each of ``n`` elements, as (hi, lo) u32 words in
    int64 tensors: element i is the threefry block of the counter (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], torch.zeros_like(i), i)


def uniform(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` under x64: float64 in [0, 1) from
    the top 52 of each element's 64 random bits."""
    hi, lo = random_bits64(key, n, device)
    mant = (hi << 20) | (lo >> 12)  # bits >> 12 of the u64 (hi, lo)
    return mant.to(torch.float64) * 2.0**-52


def randint(key, n: int, span: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, span)`` under x64 (int64), for
    1 <= span <= 2**31: the offset (higher * 2**64 + lower) mod span of
    two 64-bit draws, by ``_randint``'s remainders and its multiplier
    (2**32 mod span)**2 mod span. With span <= 2**31 every intermediate
    fits int64 and none wraps, so the u64 arithmetic of the reference
    gives the same values."""
    if not 1 <= span <= 1 << 31:
        raise ValueError(f"randint: span {span} outside [1, 2**31]")
    k1, k2 = split(key)

    def rem(k):  # (u64 bits) mod span from the (hi, lo) words
        hi, lo = random_bits64(k, n, device)
        return ((hi % span) * ((1 << 32) % span) + lo) % span

    mult = (((1 << 32) % span) ** 2) % span
    return (rem(k1) * mult + rem(k2)) % span

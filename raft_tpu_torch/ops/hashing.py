"""64-bit state fingerprinting — formula v4 (u32-pair internals).

Counterpart of ``raft_tpu/ops/hashing.py``, bit-identical to it. Every
mixing step runs as two independent 32-bit streams (murmur3 fmix32 with
distinct multiplicative constants and positional salts), combined into
one u64 only at the end.

Encodings used throughout the port:

  - a u32 stream value is an int64 tensor holding a value in
    [0, 2**32); arithmetic is done in int64 and masked with
    ``& 0xFFFFFFFF`` (torch has no unsigned 32-bit shifts or adds on the
    CPU). Multiplications by a constant are split into 16-bit halves so
    no intermediate leaves the signed 64-bit range.
  - a fingerprint is an int64 tensor holding ``u64 ^ (1 << 63)``
    (``enc``). The map preserves order, so ``torch.sort`` /
    ``torch.searchsorted`` on enc values order the u64 values, and the
    reference's ``U64_MAX`` sentinel is ``INT64_MAX`` here.

The CUDA kernels use native ``uint32_t`` / ``uint64_t`` and flip the
sign bit only where they read or write a fingerprint tensor.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
INT64_MAX = (1 << 63) - 1

# u32 stream constants (murmur3 c1/c2 + fmix32 multipliers + golden ratios)
KA = 0xCC9E2D51
KB = 0x1B873593
PA = 0x9E3779B9
PB = 0x85EBCA77
F1 = 0x85EBCA6B
F2 = 0xC2B2AE35


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) tensor -> its uint32 value as int64 (the
    reference's ``astype(uint32)``: negative values wrap)."""
    return x.to(torch.int64) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for u32 values x (int64) and a constant c,
    without leaving the signed 64-bit range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on u32 values held in int64."""
    z = z ^ (z >> 16)
    z = mul32(z, F1)
    z = z ^ (z >> 13)
    z = mul32(z, F2)
    return z ^ (z >> 16)


def join_enc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 words -> enc fingerprint ``(hi << 32 | lo) ^ 2**63``,
    computed as ``(hi - 2**31) * 2**32 + lo`` (no signed overflow)."""
    return (a - (1 << 31)) * (1 << 32) + b


def split_enc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """enc fingerprint -> (hi, lo) u32 words of the u64 value."""
    return (x >> 32) + (1 << 31), x & M32


def combine_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(u32, u32) stream pair -> enc fingerprint, with the reference's
    final cross-avalanche."""
    a2 = mix32((a + (b ^ KA)) & M32)
    b2 = mix32((b + (a ^ KB)) & M32)
    return join_enc(a2, b2)


def xor_reduce(h: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """XOR-reduce an integer tensor over ``dim`` (torch has no xor
    reduction): a pairwise tree of elementwise XORs."""
    h = h.movedim(dim, -1)
    while h.shape[-1] > 1:
        if h.shape[-1] % 2:
            h = torch.cat([h, torch.zeros_like(h[..., :1])], dim=-1)
        h = h[..., 0::2] ^ h[..., 1::2]
    if h.shape[-1] == 0:
        return torch.zeros(h.shape[:-1], dtype=h.dtype, device=h.device)
    return h[..., 0]


def sum32(h: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of u32 values mod 2**32 over ``dim``."""
    return h.sum(dim=dim) & M32


def seed_salts(seed: int) -> tuple[int, int]:
    """Host-derived per-seed u32 salt pair; (0, 0) for seed=0 so the
    default family is the plain stream."""
    if not seed:
        return 0, 0
    m = 0xFFFFFFFFFFFFFFFF
    z = (seed * 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    z ^= z >> 31
    return z >> 32, z & M32


def np_mix32(z: np.ndarray) -> np.ndarray:
    """fmix32 on numpy arrays (u64 intermediate, masked) — for building
    static tables at construction time."""
    z = z.astype(np.uint64) & M32
    z = ((z ^ (z >> np.uint64(16))) * np.uint64(F1)) & np.uint64(M32)
    z = ((z ^ (z >> np.uint64(13))) * np.uint64(F2)) & np.uint64(M32)
    return (z ^ (z >> np.uint64(16))).astype(np.int64)


def hash_lanes_pair(vec: torch.Tensor, seed: int = 0):
    """Hash an int32 [..., K] vector to a (u32, u32) stream pair."""
    k = vec.shape[-1]
    x = u32(vec)
    pos = torch.arange(k, dtype=torch.int64, device=vec.device)
    pa = mul32(pos, PA)
    pb = mul32(pos, PB)
    xa = xb = x
    if seed:
        sa, sb = seed_salts(seed)
        xa = x ^ mix32((pa + sa) & M32)
        xb = x ^ mix32((pb + sb) & M32)
    ha = mix32((mul32(xa, KA) + pa) & M32)
    hb = mix32((mul32(xb, KB) + pb) & M32)
    ka = (k * KA) & M32
    kb = (k * KB) & M32
    return xor_reduce(ha) ^ ka, xor_reduce(hb) ^ kb


def hash_lanes(vec: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash an int32 [..., K] vector to an enc fingerprint [...]."""
    return combine_pair(*hash_lanes_pair(vec, seed))


def memo_slot(fp: torch.Tensor, mcap: int) -> torch.Tensor:
    """Direct-mapped slot of an enc fingerprint in a table of ``mcap``
    (power-of-two) rows: both u32 halves remixed through fmix32."""
    hi, lo = split_enc(fp)
    idx = mix32(lo ^ ((mix32((hi + KB) & M32) + KA) & M32))
    return idx & (mcap - 1)


def sort_fps(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of enc fingerprints (= ascending u64 order)."""
    return torch.sort(x).values


def sort_fps_with_idx(x: torch.Tensor):
    """Stable ascending sort returning (sorted, original index): equal
    values keep first-occurrence order (gid-numbering parity)."""
    s = torch.sort(x, stable=True)
    return s.values, s.indices

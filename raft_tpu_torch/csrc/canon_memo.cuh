// canon_memo.cuh — device code of the canonical fingerprint of layouts with
// at most four servers: the min of the permuted view's hash over all
// P = S! server permutations (raft_tpu/ops/symmetry.py:1017
// _masked_min(view, None) over the full tables of :490 _build_direct).
//
// The hash of one permutation is canon_tiers.cuh's ct_hash_part: positional
// salts computed from the permutation (the lane descriptors of the spec
// vector, equal to the reference's tables), server values and bitmasks
// remapped, the bag's message fields remapped in place by kind, XOR over
// the non-bag lanes and addition mod 2^32 over the occupied bag slots. A
// group of G members splits the permutations: member t hashes the
// permutations of lexicographic rank p = t, t + G, ... whole (cm_nth_perm),
// and g.min64() leaves the least over the group in every member, the same
// min at every G (min is commutative and associative). Splitting each
// hash's lanes over the group instead (a butterfly a permutation,
// canon_tiered's all-tied route) was 1.5x slower cold on the general build's
// chunks, each split at its best tile (the timed table in PERF.md).
// Everything is plain C++ once CUDA's
// qualifiers are defined away (CtSerial runs the G shares in turn on the
// host: tests/test_torch_canon_memo_host.py).
#pragma once

#include "canon_tiers.cuh"

#define CM_MAX_S 4  // the full S! min's most servers (P <= 24)

__device__ __forceinline__ int cm_factorial(int n) {
  int f = 1;
  for (int i = 2; i <= n; ++i) f *= i;
  return f;
}

// a permutation of at most CM_MAX_S servers, four bits a server in one
// register (an int array indexed at run time would live in local memory)
struct CmPerm {
  uint32_t bits;
  __device__ __forceinline__ int operator[](int i) const { return (int)(bits >> (4 * i)) & 15; }
};

// the permutation of 0..S-1 of lexicographic rank p (p < S!)
__device__ __forceinline__ CmPerm cm_nth_perm(int p, int S) {
  uint32_t pool = 0x3210u, bits = 0;  // the servers not yet placed, in order
  int f = cm_factorial(S - 1);
  for (int i = 0; i < S; ++i) {
    const int q = p / f;
    p -= q * f;
    bits |= ((pool >> (4 * q)) & 15u) << (4 * i);
    const uint32_t low = (1u << (4 * q)) - 1u;
    pool = (pool & low) | ((pool >> 4) & ~low);
    if (i < S - 1) f /= S - 1 - i;
  }
  return CmPerm{bits};
}

// the min over all S! permutations, split over the group g
template <int NW, class Grp>
__device__ uint64_t cm_canon(const int* sp, const int* v, Grp& g) {
  const int S = sp[CT_S], P = cm_factorial(S);
  uint64_t best = ~0ull;
  g.each([&](int t, int G) {
    for (int p = t; p < P; p += G) {
      const uint64_t h =
          ct_hash_final(sp, ct_hash_part<NW>(sp, v, cm_nth_perm(p, S), true, 0, 1));
      best = h < best ? h : best;
    }
  });
  return g.min64(best);
}

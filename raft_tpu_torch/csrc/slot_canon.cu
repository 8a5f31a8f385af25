// slot_canon — KRaftWithReconfig's canonical fingerprints: slot_canon.
//
// Replaces raft_tpu/models/kraft_reconfig.py:2059-2147 SlotCanonicalizer
// (_fp1 over _canon_hash, with ops/bag.py:27 wide_bag_sort and
// ops/hashing.py:135 hash_lanes); the plain version is
// raft_tpu_torch/ops/slot_canon.py, whose docstring lists the steps, and
// the device code is slot_canon.cuh. For each row n: for every (sigma, tau)
// pair p of host and value permutations, the canonical view's hash (formula
// v4 with the seed's salts); out[n] = the minimum over the pairs as u64, as
// enc (u64 ^ 2^63); INT64_MAX where valid[n] is false.
//
// Design: one warp per row, SC_WARPS warps a block. The warp loops over the
// pairs; for each it builds the canonical view in its slice of shared
// memory, the lanes striding over each field's elements and reading the
// row through the cache (1,916 bytes a row at the full cfg's shapes need no
// staging), scatters the remapped bag to its sorted positions, hashes the
// view 32 lanes at a time and combines the lanes with a shuffle reduction.
// Bound: bytes (each row read once, 8 bytes written) against the int32
// operations of P hashes of VL lanes a row; PERF.md says which is larger.
#include "slot_canon.cuh"

#define SC_WARPS 4

__global__ void slot_canon_kernel(const int* __restrict__ states, long long N,
                                  const bool* __restrict__ valid, const int* __restrict__ spec,
                                  const int* __restrict__ sig, const int* __restrict__ tau,
                                  int P, int warp_ints, uint32_t sa, uint32_t sb, int seeded,
                                  long long* __restrict__ out) {
  extern __shared__ int smem[];
  int* sp = smem;
  for (int t = threadIdx.x; t < KC_LEN; t += blockDim.x) sp[t] = spec[t];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * SC_WARPS + warp;
  if (n >= N) return;  // whole warps leave together
  if (valid && !valid[n]) {
    if (lane == 0) out[n] = RT_ENC_MAX;
    return;
  }
  const int H = sp[KC_N_HOSTS], V = sp[KC_V], VL = sp[KC_VL];
  int* cr = smem + KC_LEN + warp * warp_ints;  // the canonical view [VL]
  int* keys = cr + VL;                         // the remapped bag
  const int* s = states + n * sp[KC_W];
  unsigned long long best = ~0ull;
  for (int p = 0; p < P; ++p) {
    int order[KC_MAX_S], inv[KC_MAX_S];
    sc_order(sp, s, sig + p * H, order, inv);
    sc_build_view(sp, s, sig + p * H, tau + p * V, order, inv, cr, keys, lane, 32);
    __syncwarp();
    sc_scatter_bag(sp, keys, cr, lane, 32);
    __syncwarp();
    uint32_t ha = 0, hb = 0;
    sc_hash_part(sp, cr, lane, 32, sa, sb, seeded, &ha, &hb);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ha ^= __shfl_xor_sync(0xffffffffu, ha, o);
      hb ^= __shfl_xor_sync(0xffffffffu, hb, o);
    }
    const unsigned long long h = rt_combine(ha ^ (uint32_t)VL * RT_KA, hb ^ (uint32_t)VL * RT_KB);
    best = h < best ? h : best;
    __syncwarp();  // the next pair rewrites the view
  }
  if (lane == 0) out[n] = rt_enc(best);
}

// states [N, W] int32; valid [N] bool or null; spec the model's kernel spec
// (KC_LEN ints); sig [P, H] and tau [P, V] int32 the (sigma, tau) pairs;
// warp_ints = VL + (NW + 1) * M, a warp's shared memory in ints; (sa, sb,
// seeded) the fingerprint seed's salts (ops/hashing.py seed_salts); out [N]
// int64. Returns a cudaError_t.
extern "C" int slot_canon(const int* states, long long N, const bool* valid, const int* spec,
                          int spec_len, const int* sig, const int* tau, int P, int warp_ints,
                          unsigned sa, unsigned sb, int seeded, long long* out, void* stream) {
  if (spec_len != KC_LEN || P < 1 || warp_ints <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const size_t smem = sizeof(int) * (KC_LEN + (size_t)SC_WARPS * warp_ints);
  const long long blocks = (N + SC_WARPS - 1) / SC_WARPS;
  slot_canon_kernel<<<(unsigned)blocks, 32 * SC_WARPS, smem, (cudaStream_t)stream>>>(
      states, N, valid, spec, sig, tau, P, warp_ints, sa, sb, seeded, out);
  return (int)cudaGetLastError();
}

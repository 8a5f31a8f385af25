// hash_rows — the full-state fingerprint of each row: hash_rows.
//
// Replaces the full-state hash of the liveness graph build,
// raft_tpu/checker/liveness.py:104,125 via raft_tpu/ops/hashing.py:135
// hash_lanes (formula v4, u32-pair streams), seeded family included: for
// row n of [N, W], lane j with value x and positional salts pa = j * PA,
// pb = j * PB (mod 2^32):
//
//   xa = x ^ fmix32(pa + sa), xb = x ^ fmix32(pb + sb)  (seeded family only)
//   ha = XOR_j fmix32(xa * KA + pa) ^ W * KA, hb likewise with KB, PB
//   out[n] = enc(combine(ha, hb))                    (u64 ^ 2^63 as int64)
//
// Design: one warp per row; the lanes read the row 32 lanes at a time
// (coalesced) and XOR their hashes, then a shuffle reduction. Bound: bytes
// at Raft widths (each row read once, 8 bytes written); the operations are
// two fmix32 a lane (four when seeded).
#include "common.cuh"

#define HASH_THREADS 256
#define RT_PA 0x9E3779B9u
#define RT_PB 0x85EBCA77u

__global__ void hash_rows_kernel(const int* __restrict__ rows, long long N, int W, uint32_t sa,
                                 uint32_t sb, int seeded, long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (n >= N) return;  // whole warps leave together
  const int* row = rows + n * W;
  uint32_t ha = 0, hb = 0;
  for (int j = lane; j < W; j += 32) {
    const uint32_t x = (uint32_t)row[j];
    const uint32_t pa = (uint32_t)j * RT_PA, pb = (uint32_t)j * RT_PB;
    uint32_t xa = x, xb = x;
    if (seeded) {
      xa ^= rt_mix32(pa + sa);
      xb ^= rt_mix32(pb + sb);
    }
    ha ^= rt_mix32(xa * RT_KA + pa);
    hb ^= rt_mix32(xb * RT_KB + pb);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ha ^= __shfl_xor_sync(0xffffffffu, ha, o);
    hb ^= __shfl_xor_sync(0xffffffffu, hb, o);
  }
  if (lane == 0)
    out[n] = rt_enc(rt_combine(ha ^ (uint32_t)W * RT_KA, hb ^ (uint32_t)W * RT_KB));
}

// rows [N, W] int32; (sa, sb) the family's salt pair and seeded whether the
// family is a seeded one (ops/hashing.py seed_salts); out [N] int64.
// Returns a cudaError_t.
extern "C" int hash_rows(const int* rows, long long N, int W, unsigned sa, unsigned sb,
                         int seeded, long long* out, void* stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const long long threads = N * 32;
  hash_rows_kernel<<<(unsigned)((threads + HASH_THREADS - 1) / HASH_THREADS), HASH_THREADS, 0,
                     (cudaStream_t)stream>>>(rows, N, W, sa, sb, seeded, out);
  return (int)cudaGetLastError();
}

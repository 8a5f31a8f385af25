// sim_step — the pick of one simulate step: sim_pick.
//
// Replaces the draws and the uniform pick of raft_tpu/checker/simulate.py:
// 75-81 and the restart draw of :101 (the rest of that step is raft_guard,
// raft_apply and raft_sim_check). Per walk w of R, over its row of the
// guard's [R, A] valid grid:
//
//   n_valid = the walk's enabled candidates; u = jax.random.uniform(ku,
//   (R,))[w] (float64); k = floor(u * max(n_valid, 1)); chosen = the k-th
//   enabled candidate (0 when none); moved = n_valid > 0; sel = w * A +
//   chosen, or R * A when the walk did not move (raft_apply's drop lane); ridx
//   = jax.random.randint(kr, (R,), 0, n_init)[w] (int64, here int32);
//   stats[0] += moved, stats[1] |= moved && ovf[w, chosen].
//
// (ku, kr) = jax.random.split(key) of the step's key, and (ka, kb) =
// split(kr), randint's two keys, are the same for every walk: the host
// computes them (ops/prng.split) and passes ku, ka and kb. The draws are
// jax's threefry2x32 as raft_tpu runs it (ops/prng.py): x64 on, so 64
// random bits an element from the counter (0, w) (partitionable
// threefry), the float64 mantissa from their top 52, and randint's two
// 64-bit draws under ka and kb, combined as (hi mod n) * (2^64 mod n) +
// (lo mod n), mod n.
//
// Design: one warp per walk. The lanes read the walk's valid row 32
// candidates at a time (coalesced) and count them with a ballot; lane 0
// draws u and the restart index; a second pass over the ballots finds the
// k-th enabled candidate. Bound: bytes — the valid row read (twice, the
// second from cache) and four ints a walk written; the draws are three
// threefry blocks a walk.
#include "common.cuh"

#define PICK_THREADS 256

__device__ __forceinline__ uint32_t sp_rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// Threefry-2x32, 20 rounds (jax/_src/prng.py _threefry2x32_lowering)
__device__ void sp_threefry(uint32_t k1, uint32_t k2, uint32_t x1, uint32_t x2, uint32_t* o1,
                            uint32_t* o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = sp_rotl(x2, rot[i & 1][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o1 = x1;
  *o2 = x2;
}

// 64 random bits of element i under key (k1, k2): the counter (0, i)
__device__ __forceinline__ uint64_t sp_bits64(uint32_t k1, uint32_t k2, uint32_t i) {
  uint32_t hi, lo;
  sp_threefry(k1, k2, 0u, i, &hi, &lo);
  return ((uint64_t)hi << 32) | lo;
}

__global__ void sim_pick_kernel(const bool* __restrict__ valid, const bool* __restrict__ ovf, int R,
                                int A, uint32_t ku1, uint32_t ku2, uint32_t ka1, uint32_t ka2,
                                uint32_t kb1, uint32_t kb2, int n_init,
                                int* __restrict__ chosen, bool* __restrict__ moved,
                                int* __restrict__ sel, int* __restrict__ ridx,
                                unsigned long long* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int w = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (w >= R) return;  // whole warps leave together
  const bool* v = valid + (long long)w * A;
  int n = 0;
  for (int a0 = 0; a0 < A; a0 += 32) {
    const unsigned b = __ballot_sync(0xffffffffu, a0 + lane < A && v[a0 + lane]);
    n += __popc(b);
  }
  int k = 0;
  if (lane == 0) {
    const double u = (double)(sp_bits64(ku1, ku2, (uint32_t)w) >> 12) * 0x1p-52;
    k = (int)floor(u * (double)(n > 1 ? n : 1));
    const uint64_t span = (uint64_t)n_init;
    uint64_t mult = ((uint64_t)1 << 32) % span;
    mult = (mult * mult) % span;
    const uint64_t off =
        ((sp_bits64(ka1, ka2, (uint32_t)w) % span) * mult + sp_bits64(kb1, kb2, (uint32_t)w) % span) %
        span;
    ridx[w] = (int)off;
  }
  k = __shfl_sync(0xffffffffu, k, 0);
  int c = -1;  // the k-th enabled candidate, -1 while not found
  for (int a0 = 0; a0 < A && c < 0; a0 += 32) {
    unsigned b = __ballot_sync(0xffffffffu, a0 + lane < A && v[a0 + lane]);
    const int cnt = __popc(b);
    if (k < cnt) {
      for (int j = 0; j < k; ++j) b &= b - 1;  // drop the k lowest set bits
      c = a0 + __ffs(b) - 1;
    } else {
      k -= cnt;
    }
  }
  if (lane == 0) {
    const bool m = n > 0;
    const int ch = c < 0 ? 0 : c;
    chosen[w] = ch;
    moved[w] = m;
    sel[w] = (int)((long long)(m ? w : R) * A + (m ? ch : 0));
    if (m) {
      atomicAdd(&stats[0], 1ull);
      if (ovf[(long long)w * A + ch]) atomicOr(&stats[1], 1ull);
    }
  }
}

// valid, ovf [R, A] bool; ku the uniform draw's key, ka and kb randint's
// two keys (each two u32 words); n_init the restart pool's rows (>= 1);
// chosen, sel, ridx [R] int32; moved [R] bool; stats [4] int64, of which
// [0] and [1] are set here. Returns a cudaError_t.
extern "C" int sim_pick(const bool* valid, const bool* ovf, int R, int A, unsigned ku1,
                        unsigned ku2, unsigned ka1, unsigned ka2, unsigned kb1, unsigned kb2,
                        int n_init, int* chosen, bool* moved, int* sel, int* ridx,
                        long long* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (A <= 0 || n_init < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (R <= 0) return 0;
  const long long threads = (long long)R * 32;
  sim_pick_kernel<<<(unsigned)((threads + PICK_THREADS - 1) / PICK_THREADS), PICK_THREADS, 0, s>>>(
      valid, ovf, R, A, ku1, ku2, ka1, ka2, kb1, kb2, n_init, chosen, moved, sel, ridx,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

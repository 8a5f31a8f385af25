// Shared helpers of the raft_tpu_torch kernels: the u32 hash streams of
// raft_tpu/ops/hashing.py, the enc fingerprint encoding and a block scan.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_KA 0xCC9E2D51u
#define RT_KB 0x1B873593u
#define RT_SIGN 0x8000000000000000ull
#define RT_ENC_MAX 0x7FFFFFFFFFFFFFFFll  // enc of the U64_MAX sentinel

// murmur3 fmix32 (raft_tpu/ops/hashing.py mix32)
__device__ __forceinline__ uint32_t rt_mix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// (u32, u32) stream pair -> u64 with the final cross-avalanche
// (raft_tpu/ops/hashing.py combine_pair)
__device__ __forceinline__ uint64_t rt_combine(uint32_t a, uint32_t b) {
  uint32_t a2 = rt_mix32(a + (b ^ RT_KA));
  uint32_t b2 = rt_mix32(b + (a ^ RT_KB));
  return ((uint64_t)a2 << 32) | (uint64_t)b2;
}

// direct-mapped canon memo slot of a raw key (raft_tpu/ops/hashing.py
// memo_slot): both u32 halves remixed through fmix32, masked to mcap rows
__device__ __forceinline__ int rt_memo_slot(uint64_t raw, int mcap) {
  uint32_t hi = (uint32_t)(raw >> 32), lo = (uint32_t)raw;
  uint32_t idx = rt_mix32(lo ^ (rt_mix32(hi + RT_KB) + RT_KA));
  return (int)(idx & (uint32_t)(mcap - 1));
}

// u64 fingerprint <-> the int64 tensor encoding u64 ^ 2^63
__device__ __forceinline__ long long rt_enc(uint64_t u) {
  return (long long)(u ^ RT_SIGN);
}

// Exclusive prefix sum of one value per thread over a block of NT
// threads (NT a multiple of 32, at most 1024); *total gets the block sum.
template <typename T, int NT>
__device__ T rt_block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T w = lane < NT / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;  // inclusive warp prefixes
  }
  __syncthreads();
  T excl = (wid > 0 ? warp_sums[wid - 1] : T(0)) + x - v;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return excl;
}

#ifdef __CUDACC__
// Stage the first VL lanes of the block's rows of the [B, W] states into
// srow, one row per thread at stride VL + 1 so threads hit distinct banks,
// zeros past B; returns this thread's row. The caller syncs the block.
__device__ __forceinline__ const int* rt_stage_rows(int* srow, const int* __restrict__ states,
                                                    int B, int W, int VL) {
  const int stride = VL + 1;
  const long long base = (long long)blockIdx.x * blockDim.x;
  for (int e = threadIdx.x; e < (int)blockDim.x * VL; e += blockDim.x) {
    const int r = e / VL, c = e - r * VL;
    const long long row = base + r;
    srow[r * stride + c] = row < B ? states[row * W + c] : 0;
  }
  return srow + threadIdx.x * stride;
}

// The canon memo protocol of canon_memo and canon_tiered, first launch, for
// lane b (every thread of the block calls it: the hits are a warp ballot).
// memo is a direct-mapped [mcap, 2] table of (raw key, fingerprint) enc
// rows. A valid lane probes the row rt_memo_slot(raw); on a miss it takes
// canon() as its fingerprint and claims the slot with atomicMax (the highest
// lane wins). Without memoize the fingerprint is the raw key. Writes the
// lane's fingerprint (RT_ENC_MAX when invalid), raw key and claimed slot
// (-1: none) and adds the warp's hits to *n_hit.
template <class Canon>
__device__ __forceinline__ void rt_memo_lane(bool active, bool memoize, const bool* valid,
                                             long long b, uint64_t raw,
                                             const long long* __restrict__ memo, int mcap,
                                             int* claim, long long* fps, long long* raw_out,
                                             int* slot_out, unsigned long long* n_hit,
                                             Canon canon) {
  bool hit = false;
  long long fp = RT_ENC_MAX, raw_enc = RT_ENC_MAX;
  int slot = -1;
  if (active) {
    raw_enc = rt_enc(raw);
    const bool ok = valid[b];
    if (!memoize) {
      fp = ok ? raw_enc : RT_ENC_MAX;
    } else if (ok) {
      const int s = rt_memo_slot(raw, mcap);
      hit = memo[2 * (long long)s] == raw_enc && raw_enc != RT_ENC_MAX;
      if (hit) {
        fp = memo[2 * (long long)s + 1];
      } else {
        fp = rt_enc(canon());
        slot = s;
        atomicMax(&claim[s], (int)b);
      }
    }
  }
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(n_hit, (unsigned long long)__popc(hits));
  if (active) {
    fps[b] = fp;
    raw_out[b] = raw_enc;
    slot_out[b] = slot;
  }
}

// The protocol's second launch, one thread per lane: each claimed slot's
// winner writes its whole row, then releases the claim, so no row is torn.
__device__ __forceinline__ void rt_memo_insert_lane(long long* __restrict__ memo,
                                                    int* __restrict__ claim,
                                                    const long long* __restrict__ fps,
                                                    const long long* __restrict__ raw,
                                                    const int* __restrict__ slot, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int s = slot[b];
  if (s < 0 || claim[s] != b) return;
  memo[2 * (long long)s] = raw[b];
  memo[2 * (long long)s + 1] = fps[b];
  claim[s] = -1;
}

// Rows per block of a kernel that stages one state row of VL + 1 ints per
// thread beside fixed_bytes of tables in dynamic shared memory: the most of
// 128, 64 and 32 rows that keeps the block within 64 KB (several blocks per
// SM), else 32 rows up to the device's opt-in limit (cudaErrorInvalidValue
// past it). Sets the kernel's dynamic shared-memory limit to *smem.
static inline cudaError_t rt_rows_per_block(const void* kernel, size_t fixed_bytes, int VL,
                                            int* threads, size_t* smem) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t row = (size_t)(VL + 1) * 4;
  int nt = 128;
  while (nt > 32 && fixed_bytes + nt * row > 64 * 1024) nt >>= 1;
  *threads = nt;
  *smem = fixed_bytes + nt * row;
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}
#endif

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

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

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

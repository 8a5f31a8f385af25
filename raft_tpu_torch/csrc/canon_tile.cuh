// canon_tile.cuh — what the two memoized canon kernels (canon_tiered.cu,
// canon_memo.cu) share on the card: the tile of G threads that
// canonicalizes one state (a group type for canon_tiers.cuh's device code),
// the staging of the spec vector and of each tile's row in shared memory,
// the host-side checks of the spec vector and the block shape.
#pragma once

#include <cooperative_groups.h>

#include "canon_tiers.cuh"

namespace cg = cooperative_groups;

#define CT_BLOCK 256  // threads a block (fewer where the rows would not fit)

// The tile's group type for canon_tiers.cuh and slot_canon.cuh: a member
// runs its own share, sum() (addition; the hash part's non-bag streams by
// XOR) and xor2() combine the members' partials by butterflies within the
// tile and min64() takes the least of the members' values, each leaving the
// result in every member; sync() is the tile's barrier
template <int G>
struct CtTile {
  cg::thread_block_tile<G> tile;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f((int)tile.thread_rank(), G);
  }
  __device__ __forceinline__ void sum(uint32_t* a, uint32_t* b, int S) {
#pragma unroll
    for (int i = 0; i < CT_MAX_S; ++i) {
      if (i >= S) break;
      for (int o = G / 2; o > 0; o >>= 1) {
        a[i] += tile.shfl_xor(a[i], o);
        b[i] += tile.shfl_xor(b[i], o);
      }
    }
  }
  __device__ __forceinline__ void sum(CtHashPart& h) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      h.na ^= tile.shfl_xor(h.na, o);
      h.nb ^= tile.shfl_xor(h.nb, o);
      h.ba += tile.shfl_xor(h.ba, o);
      h.bb += tile.shfl_xor(h.bb, o);
    }
  }
  __device__ __forceinline__ void xor2(uint32_t& a, uint32_t& b) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      a ^= tile.shfl_xor(a, o);
      b ^= tile.shfl_xor(b, o);
    }
  }
  __device__ __forceinline__ void sync() { tile.sync(); }
  __device__ __forceinline__ uint64_t min64(uint64_t x) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const uint32_t hi = tile.shfl_xor((uint32_t)(x >> 32), o);
      const uint32_t lo = tile.shfl_xor((uint32_t)x, o);
      const uint64_t y = ((uint64_t)hi << 32) | lo;
      x = y < x ? y : x;
    }
    return x;
  }
};

__host__ __device__ __forceinline__ int ct_row_stride(int VL) { return VL | 1; }

// stage the spec vector into smem, then this tile's row of the [B, W]
// states after it; returns the row. Every thread of the block calls it.
template <int G>
__device__ __forceinline__ int* ct_stage(int* smem, const int* __restrict__ gspec, int spec_len,
                                         const int* __restrict__ states, long long b, bool load,
                                         int W, cg::thread_block_tile<G>& tile) {
  for (int e = threadIdx.x; e < spec_len; e += blockDim.x) smem[e] = gspec[e];
  __syncthreads();
  const int VL = smem[CT_VL];
  int* row = smem + spec_len + (int)(threadIdx.x / G) * ct_row_stride(VL);
  if (load) {
    const int* src = states + b * W;
    for (int c = tile.thread_rank(); c < VL; c += G) row[c] = src[c];
  }
  tile.sync();
  return row;
}

// The canon memo protocol's first launch, a tile of G threads a state
// (the body of canon_tiered_kernel and canon_memo_kernel). memo is a
// direct-mapped [mcap, 2] table of (raw key, fingerprint) enc rows. Only
// valid lanes work: an invalid lane's tile writes its fingerprint
// (RT_ENC_MAX) and slot (-1) and reads no row, and a block without a valid
// lane (past the engine's valid prefix) writes those and returns before it
// stages anything. A valid lane's tile computes the raw key (ct_raw);
// without memoize the fingerprint is the raw key. Else one member probes
// the row rt_memo_slot(raw); on a miss the tile computes canon(sp, v, g)
// and that member claims the slot with atomicMax (the highest lane wins)
// and writes the lane's fingerprint, raw key and claimed slot (-1: none).
// Hits are counted a state: a block's sum is added to *n_hit once. An
// invalid lane's raw_out stays unwritten: rt_memo_insert_lane reads raw[b]
// only where slot[b] >= 0.
template <int NW, int G, class Canon>
__device__ __forceinline__ void ct_memo_tile(const int* __restrict__ gspec, int spec_len,
                                             bool memoize, const int* __restrict__ states,
                                             int B, int W, const bool* __restrict__ valid,
                                             const long long* __restrict__ memo, int mcap,
                                             int* __restrict__ claim, long long* __restrict__ fps,
                                             long long* __restrict__ raw_out,
                                             int* __restrict__ slot_out,
                                             unsigned long long* __restrict__ n_hit,
                                             Canon canon) {
  extern __shared__ int smem[];
  __shared__ unsigned block_hits;
  cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const int t = (int)tile.thread_rank();
  const long long b = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool in = b < B;
  const bool ok = in && valid[b];
  if (in && !ok && t == 0) {
    fps[b] = RT_ENC_MAX;
    slot_out[b] = -1;
  }
  if (!__syncthreads_or(ok)) return;  // no valid lane in the block
  if (threadIdx.x == 0) block_hits = 0;
  const int* v = ct_stage<G>(smem, gspec, spec_len, states, b, ok, W, tile);
  const int* sp = smem;
  if (ok) {
    CtTile<G> g{tile};
    const uint64_t raw = ct_raw<NW>(sp, v, g);
    const long long raw_enc = rt_enc(raw);
    const int s = rt_memo_slot(raw, mcap);
    int hit = 0;
    long long fp = raw_enc;
    if (memoize) {
      if (t == 0) {
        hit = memo[2 * (long long)s] == raw_enc && raw_enc != RT_ENC_MAX;
        if (hit) fp = memo[2 * (long long)s + 1];
      }
      hit = tile.shfl(hit, 0);
      if (!hit) fp = rt_enc(canon(sp, v, g));
    }
    if (t == 0) {
      fps[b] = fp;
      raw_out[b] = raw_enc;
      slot_out[b] = memoize && !hit ? s : -1;
      if (hit)
        atomicAdd(&block_hits, 1u);
      else if (memoize)
        atomicMax(&claim[s], (int)b);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_hits) atomicAdd(n_hit, (unsigned long long)block_hits);
}

// host-side checks of the spec vector against a build: the 2-word path
// takes two key words and at most CT_FAST_FIELDS plain or Nil-able message
// fields
static bool ct_spec_ok(const int* hspec, int spec_len) {
  if (spec_len < CT_HDR || hspec[CT_LEN] != spec_len || hspec[CT_S] < 1 ||
      hspec[CT_S] > CT_MAX_S || hspec[CT_NW] < 1 || hspec[CT_NW] > CT_MAX_WORDS)
    return false;
  if (hspec[CT_GENERAL]) return hspec[CT_NF] <= CT_MAX_FIELDS;
  if (hspec[CT_NW] != 2 || hspec[CT_NF] > CT_FAST_FIELDS) return false;
  const int* fd = hspec + hspec[CT_OFF_FIELDS];
  for (int f = 0; f < hspec[CT_NF]; ++f)
    if (fd[4 * f + 3] == CT_MSG_BITMASK) return false;
  return true;
}

// Threads a block: CT_BLOCK, halved (down to one tile) until the spec and
// a row a tile fit the device's opt-in shared memory
// (cudaErrorInvalidValue past it). Sets the kernel's dynamic shared-memory
// limit to *smem.
static cudaError_t ct_block(const void* kernel, int G, int spec_len, int VL, int* threads,
                            size_t* smem) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t row = (size_t)ct_row_stride(VL) * 4, fixed = (size_t)spec_len * 4;
  int nt = CT_BLOCK;
  while (nt > G && fixed + (size_t)(nt / G) * row > (size_t)optin) nt >>= 1;
  *threads = nt;
  *smem = fixed + (size_t)(nt / G) * row;
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// The launch shape of a canon kernel built with tiles of G threads for this
// spec and what it reaches: out = {G, threads a block, dynamic shared bytes
// a block, resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// warps an SM}
static cudaError_t ct_occupancy(const void* kernel, int G, int spec_len, int VL, int* out) {
  int nt, nb;
  size_t smem;
  cudaError_t e = ct_block(kernel, G, spec_len, VL, &nt, &smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, nt, smem);
  if (e != cudaSuccess) return e;
  out[0] = G;
  out[1] = nt;
  out[2] = (int)smem;
  out[3] = nb;
  out[4] = nb * nt / 32;
  return cudaSuccess;
}

// chunk_sort — one stable sort per chunk: first occurrence and the R0 run.
//
// Replaces the two per-chunk sorts of raft_tpu/checker/device_bfs.py: the
// first-occurrence dedup of _st_dedup (:413-420, sort_u64_with_idx of
// raft_tpu/ops/hashing.py:162) and the R0 run emit of _st_finish (:495,
// sort_u64 of hashing.py:154). Both sort the same chunk of fingerprints,
// so one sort serves both:
//
//   1. sort the n enc fingerprints as u64 together with their lane index;
//      ties keep lane order (the 3-key sort of sort_u64_with_idx);
//   2. over the sorted order: first_s[p] = key differs from its left
//      neighbour; new_sorted[p] = fresh[order[p]] & first_s[p], scattered
//      back to lane order as `new` (= fresh & first of _st_dedup);
//   3. the run: the stable compaction of the sorted keys where new_sorted
//      holds, padded with INT64_MAX to R lanes. A compaction of an
//      ascending sequence is ascending, so the run equals
//      sort(where(new, fps, INT64_MAX)) bit for bit.
//
// Design. Ordering pairs (key, lane) lexicographically makes every element
// distinct, so the order is total and any correct sort returns the stable
// one. cs_tile_sort sorts tiles of CS_TILE pairs with a bitonic network in
// shared memory (lanes past n get key U64_MAX and an index past every real
// lane, so they sort last); cs_merge then doubles the sorted runs until one
// run holds the chunk: each element finds its place by binary search in the
// other run of its pair (its rank there plus its own position). cs_flags
// writes `new` and per-block counts; cs_emit scans them into the run and
// pads it. 1 + log2(np / CS_TILE) + 2 launches.
//
// Bound: bytes — the n keys (8 B) and the fresh flags (1 B) read once, new
// (1 B) and the R-lane run (8 B) written once.
#include "common.cuh"

#define CS_TILE 2048
#define CS_SORT_THREADS (CS_TILE / 2)  // one compare-exchange each per stage
#define CS_THREADS 1024

__device__ __forceinline__ bool cs_less(uint64_t ka, int ia, uint64_t kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__global__ void __launch_bounds__(CS_SORT_THREADS)
cs_tile_sort(const long long* __restrict__ fps, int n, uint64_t* __restrict__ keys,
             int* __restrict__ idx) {
  __shared__ uint64_t sk[CS_TILE];
  __shared__ int si[CS_TILE];
  const int base = blockIdx.x * CS_TILE;
  for (int e = threadIdx.x; e < CS_TILE; e += blockDim.x) {
    const int g = base + e;
    sk[e] = g < n ? (uint64_t)fps[g] ^ RT_SIGN : ~0ull;
    si[e] = g;
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int size = 2; size <= CS_TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int lo = 2 * t - (t & (stride - 1));
      const int hi = lo + stride;
      const bool up = (lo & size) == 0;
      const uint64_t ka = sk[lo], kb = sk[hi];
      const int ia = si[lo], ib = si[hi];
      if (up ? cs_less(kb, ib, ka, ia) : cs_less(ka, ia, kb, ib)) {
        sk[lo] = kb;
        sk[hi] = ka;
        si[lo] = ib;
        si[hi] = ia;
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < CS_TILE; e += blockDim.x) {
    keys[base + e] = sk[e];
    idx[base + e] = si[e];
  }
}

// merge sorted runs of L pairs two by two into runs of 2L
__global__ void cs_merge(const uint64_t* __restrict__ ki, const int* __restrict__ ii,
                         uint64_t* __restrict__ ko, int* __restrict__ io, int np, int L) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  const uint64_t k = ki[p];
  const int i = ii[p];
  const int run = p / L, pos = p - run * L;
  const int pair = (run & ~1) * L;
  const int other = (run & 1) ? pair : pair + L;
  int lo = 0, hi = L;  // elements of the other run below (k, i)
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (cs_less(ki[other + m], ii[other + m], k, i)) lo = m + 1; else hi = m;
  }
  ko[pair + pos + lo] = k;
  io[pair + pos + lo] = i;
}

__device__ __forceinline__ bool cs_new_sorted(const uint64_t* __restrict__ sk,
                                              const int* __restrict__ si,
                                              const bool* __restrict__ fresh, int p) {
  return (p == 0 || sk[p] != sk[p - 1]) && fresh[si[p]];
}

__global__ void __launch_bounds__(CS_THREADS)
cs_flags(const uint64_t* __restrict__ sk, const int* __restrict__ si,
         const bool* __restrict__ fresh, int n, bool* __restrict__ new_out,
         int* __restrict__ blk_count) {
  const int p = blockIdx.x * CS_THREADS + threadIdx.x;
  bool ns = false;
  if (p < n) {
    ns = cs_new_sorted(sk, si, fresh, p);
    new_out[si[p]] = ns;
  }
  const int c = __syncthreads_count(ns);
  if (threadIdx.x == 0) blk_count[blockIdx.x] = c;
}

__global__ void __launch_bounds__(CS_THREADS)
cs_emit(const uint64_t* __restrict__ sk, const int* __restrict__ si,
        const bool* __restrict__ fresh, int n, const int* __restrict__ blk_count, int nblk,
        long long* __restrict__ run, int R) {
  __shared__ int s_off, s_total;
  if (threadIdx.x < 32) {  // this block's offset and the total, by warp 0
    int before = 0, total = 0;
    for (int j = threadIdx.x; j < nblk; j += 32) {
      const int c = blk_count[j];
      total += c;
      before += j < (int)blockIdx.x ? c : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    if (threadIdx.x == 0) {
      s_off = before;
      s_total = total;
    }
  }
  __syncthreads();
  const int p = blockIdx.x * CS_THREADS + threadIdx.x;
  const bool ns = p < n && cs_new_sorted(sk, si, fresh, p);
  int block_total;
  const int excl = rt_block_exclusive_scan<int, CS_THREADS>(ns ? 1 : 0, &block_total);
  if (ns) run[s_off + excl] = (long long)(sk[p] ^ RT_SIGN);
  if (p >= s_total && p < R) run[p] = RT_ENC_MAX;
}

// np: a power of two times CS_TILE, at least n; k0/i0 and k1/i1 hold np
// pairs each; blk_count holds ceil(n / CS_THREADS) ints; R >= n.
extern "C" int chunk_sort(const long long* fps, const bool* fresh, int n, int np,
                          uint64_t* k0, int* i0, uint64_t* k1, int* i1, int* blk_count,
                          bool* new_out, long long* run, int R, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (np < CS_TILE || np % CS_TILE || (np & (np - 1)) || np < n || R < n)
    return (int)cudaErrorInvalidValue;
  const int nblk = (n + CS_THREADS - 1) / CS_THREADS;
  if (n > 0) {
    cs_tile_sort<<<np / CS_TILE, CS_SORT_THREADS, 0, s>>>(fps, n, k0, i0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int L = CS_TILE; L < np; L <<= 1) {
      cs_merge<<<np / 256, 256, 0, s>>>(k0, i0, k1, i1, np, L);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      uint64_t* tk = k0; k0 = k1; k1 = tk;
      int* ti = i0; i0 = i1; i1 = ti;
    }
    cs_flags<<<nblk, CS_THREADS, 0, s>>>(k0, i0, fresh, n, new_out, blk_count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int span = n > R ? n : R;
  if (span == 0) return 0;
  cs_emit<<<(span + CS_THREADS - 1) / CS_THREADS, CS_THREADS, 0, s>>>(
      k0, i0, fresh, n, blk_count, nblk, run, R);
  return (int)cudaGetLastError();
}

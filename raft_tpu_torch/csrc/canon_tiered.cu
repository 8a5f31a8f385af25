// canon_tiered — memoized canonical fingerprints of layouts with five or
// more servers, and their server signatures.
//
// Replaces raft_tpu/ops/symmetry.py:1230 fingerprints_memo on the path of
// layouts with S >= 5, where the reference canonicalizes through the
// signature tiers (_signatures :581, _tier_pre :1081, _hash_dyn :944,
// _tier3_local :1143, _tier3_full :1193); the device code is
// canon_tiers.cuh. Two entry points:
//
//   canon_tiered      per valid lane: the raw key (the view's hash with no
//                     permutation), a probe of the memo row memo_slot(raw);
//                     on a miss the signatures and the min of the permuted
//                     hash over the admissible permutations, and an
//                     atomicMax claim of the slot. A second launch lets only
//                     each slot's winner write its whole row and release the
//                     claim, so no row is torn (the memo protocol of
//                     common.cuh, shared with canon_memo).
//   canon_signatures  the [B, S] signatures (enc int64) of every lane, for
//                     checks.
//
// Both are built twice from the templates of canon_tiers.cuh: NW = 2 for
// the 2-word bags (Raft, FlexibleRaft, KRaft at five servers) and NW = 0,
// the general path, for N-word bags, member-set message fields and fields
// of several lanes a server (the reconfiguration specs); the spec's
// CT_GENERAL picks one.
//
// Design. A state is canonicalized by a tile of G threads
// (cooperative_groups::tiled_partition), CT_BLOCK / G states a block. Each
// member takes a share of the non-bag lanes and bag slots of every hash and
// of the (signature field, server) units and bag slots of every signature
// round (canon_tiers.cuh); the tile combines the shares with
// __shfl_xor_sync butterflies: XOR for the non-bag streams, addition mod
// 2^32 for the bag streams and the signature sums. Both are commutative and
// associative, so the result is bit-identical to the serial order (the
// host build checks every G against the reference). The butterfly leaves
// the totals in every member, so the members agree on the signatures, the
// admissible permutations (the products of per-tie-group permutations of
// the sort, enumerated by every member alike; the lanes, not the
// permutations, are split: one path for totally ordered and all-tied
// states) and the min. G is 8 on the 2-word build (327 view lanes at five
// servers: 17 non-bag lanes and 8 bag slots a member, 32 states a block)
// and 16 on the general build (922 and 1,221 view lanes, 250 and 325
// non-bag lanes, 112 slots of 5- and 7-word keys: 16 states a block). Of
// the tiles of 8, 16 and 32 these were the fastest on a cold chunk and
// within 10% of the fastest on a warm one (scripts/canon_groups.py: the
// cold chunk takes 1.3-1.7x longer at G = 32, whose butterflies and
// per-member serial work, the sort and the permutation walk, cost more
// than the warps it keeps resident). The spec vector goes to shared memory
// once a block, each state's row (VL ints, odd stride) once a tile, read
// coalesced by the tile. One thread of a tile probes the memo, the tile computes the canon
// on a miss, and that thread claims the slot and writes the lane.
//
// Only valid lanes work. An invalid lane's tile writes its fingerprint
// (RT_ENC_MAX) and slot (-1) and reads no row; a block without a valid lane
// (past the engine's valid prefix) writes those and returns before staging
// the spec. An invalid lane's raw_out stays unwritten: ct_memo_insert reads
// raw[b] only for a lane holding a claimed slot (slot[b] >= 0), and the
// wrapper (ops/symmetry.py fingerprints_memo_cuda) returns only the
// fingerprints and the hit count.
//
// Bound: operations on a cold chunk — per missed lane the signatures (about
// (1 + rounds) * (NF + 1) fmix32 pairs per occupied slot plus the per-server
// folds) and one permuted hash (K non-bag lanes + NW + 1 per occupied slot)
// per admissible permutation; on a warm one the valid lanes' raw hashes, or
// the bytes (the valid lanes' view rows read once, each memo row read and
// written once).
#include <cooperative_groups.h>

#include "canon_tiers.cuh"

namespace cg = cooperative_groups;

#define CT_BLOCK 256  // threads a block (fewer where the rows would not fit)

// The tile's group type for canon_tiers.cuh: a member runs its own share,
// sum() combines the members' partials by butterflies within the tile
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
};

// the tile of each build (scripts/canon_groups.py builds others to compare)
#ifndef CT_G2
#define CT_G2 8
#endif
#ifndef CT_GGEN
#define CT_GGEN 16
#endif
template <int NW>
constexpr int ct_tile = NW ? CT_G2 : CT_GGEN;

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

template <int NW>
__global__ void __launch_bounds__(CT_BLOCK)
canon_tiered_kernel(const int* __restrict__ gspec, int spec_len, const int* __restrict__ states,
                    int B, int W, const bool* __restrict__ valid,
                    const long long* __restrict__ memo, int mcap, int* __restrict__ claim,
                    long long* __restrict__ fps, long long* __restrict__ raw_out,
                    int* __restrict__ slot_out, unsigned long long* __restrict__ n_hit) {
  constexpr int G = ct_tile<NW>;
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
    long long fp = RT_ENC_MAX;
    if (t == 0) {
      hit = memo[2 * (long long)s] == raw_enc && raw_enc != RT_ENC_MAX;
      if (hit) fp = memo[2 * (long long)s + 1];
    }
    hit = tile.shfl(hit, 0);
    if (!hit) fp = rt_enc(ct_canon<NW>(sp, v, g));
    if (t == 0) {
      fps[b] = fp;
      raw_out[b] = raw_enc;
      slot_out[b] = hit ? -1 : s;
      if (hit)
        atomicAdd(&block_hits, 1u);
      else
        atomicMax(&claim[s], (int)b);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_hits) atomicAdd(n_hit, (unsigned long long)block_hits);
}

__global__ void ct_memo_insert(long long* __restrict__ memo, int* __restrict__ claim,
                               const long long* __restrict__ fps,
                               const long long* __restrict__ raw,
                               const int* __restrict__ slot, int B) {
  rt_memo_insert_lane(memo, claim, fps, raw, slot, B);
}

template <int NW>
__global__ void __launch_bounds__(CT_BLOCK)
canon_signatures_kernel(const int* __restrict__ gspec, int spec_len,
                        const int* __restrict__ states, int B, int W,
                        long long* __restrict__ out) {
  constexpr int G = ct_tile<NW>;
  extern __shared__ int smem[];
  cg::thread_block_tile<G> tile = cg::tiled_partition<G>(cg::this_thread_block());
  const long long b = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const int* v = ct_stage<G>(smem, gspec, spec_len, states, b, b < B, W, tile);
  if (b >= B) return;
  CtTile<G> g{tile};
  uint64_t sig[CT_MAX_S];
  ct_signatures<NW>(smem, v, sig, g);
  const int S = smem[CT_S];
  for (int i = (int)tile.thread_rank(); i < S; i += G) out[b * S + i] = rt_enc(sig[i]);
}

// host-side checks of the spec vector against this build: the 2-word path
// takes two key words and at most CT_FAST_FIELDS message fields
static bool ct_spec_ok(const int* hspec, int spec_len) {
  if (spec_len < CT_HDR || hspec[CT_LEN] != spec_len || hspec[CT_S] < 1 ||
      hspec[CT_S] > CT_MAX_S || hspec[CT_NW] < 1 || hspec[CT_NW] > CT_MAX_WORDS)
    return false;
  return hspec[CT_GENERAL] ? hspec[CT_NF] <= CT_MAX_FIELDS
                           : hspec[CT_NW] == 2 && hspec[CT_NF] <= CT_FAST_FIELDS;
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

// hspec: the spec vector in host memory, spec: the same on the device
extern "C" int canon_tiered(const int* hspec, const int* spec, int spec_len, const int* states,
                            int B, int W, const bool* valid, long long* memo, int mcap,
                            int* claim, long long* fps, long long* raw, int* slot,
                            long long* n_hit, void* stream) {
  if (!ct_spec_ok(hspec, spec_len) || W < hspec[CT_VL]) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool general = hspec[CT_GENERAL] != 0;
  const auto kernel = general ? canon_tiered_kernel<0> : canon_tiered_kernel<2>;
  const int G = general ? ct_tile<0> : ct_tile<2>;
  int nt;
  size_t smem;
  cudaError_t e = ct_block((const void*)kernel, G, spec_len, hspec[CT_VL], &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  const int per = nt / G;
  kernel<<<(B + per - 1) / per, nt, smem, s>>>(spec, spec_len, states, B, W, valid, memo, mcap,
                                               claim, fps, raw, slot,
                                               (unsigned long long*)n_hit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ct_memo_insert<<<(B + 255) / 256, 256, 0, s>>>(memo, claim, fps, raw, slot, B);
  return (int)cudaGetLastError();
}

// The launch shape canon_tiered takes for this spec and what it reaches:
// out = {G, threads a block, dynamic shared bytes a block, resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), warps an SM}
extern "C" int canon_tiered_occupancy(const int* hspec, int spec_len, int* out) {
  if (!ct_spec_ok(hspec, spec_len)) return (int)cudaErrorInvalidValue;
  const bool general = hspec[CT_GENERAL] != 0;
  const auto kernel = general ? canon_tiered_kernel<0> : canon_tiered_kernel<2>;
  const int G = general ? ct_tile<0> : ct_tile<2>;
  int nt, nb;
  size_t smem;
  cudaError_t e = ct_block((const void*)kernel, G, spec_len, hspec[CT_VL], &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, (const void*)kernel, nt, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = G;
  out[1] = nt;
  out[2] = (int)smem;
  out[3] = nb;
  out[4] = nb * nt / 32;
  return 0;
}

extern "C" int canon_signatures(const int* hspec, const int* spec, int spec_len,
                                const int* states, int B, int W, long long* out, void* stream) {
  if (!ct_spec_ok(hspec, spec_len) || W < hspec[CT_VL]) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool general = hspec[CT_GENERAL] != 0;
  const int G = general ? ct_tile<0> : ct_tile<2>;
  const auto kernel = general ? canon_signatures_kernel<0> : canon_signatures_kernel<2>;
  int nt;
  size_t smem;
  cudaError_t e = ct_block((const void*)kernel, G, spec_len, hspec[CT_VL], &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  const int per = nt / G;
  kernel<<<(B + per - 1) / per, nt, smem, (cudaStream_t)stream>>>(spec, spec_len, states, B, W,
                                                                  out);
  return (int)cudaGetLastError();
}

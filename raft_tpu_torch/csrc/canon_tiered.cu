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
//                     canon_tile.cuh and common.cuh, shared with
//                     canon_memo).
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
// Only valid lanes work (the protocol's tile form, ct_memo_tile of
// canon_tile.cuh, shared with canon_memo): a block without a valid lane
// (past the engine's valid prefix) returns before staging the spec, and
// the wrapper (ops/symmetry.py fingerprints_memo_cuda) returns only the
// fingerprints and the hit count.
//
// Bound: operations on a cold chunk — per missed lane the signatures (about
// (1 + rounds) * (NF + 1) fmix32 pairs per occupied slot plus the per-server
// folds) and one permuted hash (K non-bag lanes + NW + 1 per occupied slot)
// per admissible permutation; on a warm one the valid lanes' raw hashes, or
// the bytes (the valid lanes' view rows read once, each memo row read and
// written once).
#include "canon_tile.cuh"

// the tile of each build (scripts/canon_groups.py builds others to compare)
#ifndef CT_G2
#define CT_G2 8
#endif
#ifndef CT_GGEN
#define CT_GGEN 16
#endif
template <int NW>
constexpr int ct_tile = NW ? CT_G2 : CT_GGEN;

template <int NW>
__global__ void __launch_bounds__(CT_BLOCK)
canon_tiered_kernel(const int* __restrict__ gspec, int spec_len, const int* __restrict__ states,
                    int B, int W, const bool* __restrict__ valid,
                    const long long* __restrict__ memo, int mcap, int* __restrict__ claim,
                    long long* __restrict__ fps, long long* __restrict__ raw_out,
                    int* __restrict__ slot_out, unsigned long long* __restrict__ n_hit) {
  ct_memo_tile<NW, ct_tile<NW>>(gspec, spec_len, true, states, B, W, valid, memo, mcap, claim,
                                fps, raw_out, slot_out, n_hit, [](const int* sp, const int* v,
                                                                  CtTile<ct_tile<NW>>& g) {
                                  return ct_canon<NW>(sp, v, g);
                                });
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
  return (int)ct_occupancy((const void*)kernel, general ? ct_tile<0> : ct_tile<2>, spec_len,
                           hspec[CT_VL], out);
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

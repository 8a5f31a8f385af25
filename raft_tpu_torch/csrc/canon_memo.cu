// canon_memo — memoized canonical (VIEW + SYMMETRY) fingerprints of layouts
// with at most four servers.
//
// Replaces raft_tpu/ops/symmetry.py:1230 fingerprints_memo on the path of
// layouts with S <= 4 (or no symmetry), together with what it calls there:
// :571 _perm_hash (the raw identity-permutation view hash, the memo key),
// :543 _bag_hash_pair, :850 _hash_static over the full S! direct tables of
// :490 _build_direct, :1017 _masked_min(view, None), and the u32 streams of
// raft_tpu/ops/hashing.py (mix32, combine_pair, hash_lanes_pair, memo_slot).
// The canonical fingerprint is the min of the permuted view's hash over all
// P = S! permutations (canon_memo.cuh); without symmetry it is the raw key.
//
// Design. A state is canonicalized by a tile of G threads
// (cooperative_groups::tiled_partition), CT_BLOCK / G states a block, in
// the memo protocol's tile form (ct_memo_tile of canon_tile.cuh, shared
// with canon_tiered):
//   1. only valid lanes work: an invalid lane's tile writes its fingerprint
//      (RT_ENC_MAX) and slot (-1) and reads no row; a block past the
//      engine's valid prefix returns before it stages anything;
//   2. the spec vector (ops/symmetry.py Canonicalizer.memo_spec: the lane
//      descriptors from which every permutation's positional salts are
//      computed, in place of P x K tables) goes to shared memory once a
//      block, each state's row (VL ints, odd stride) once a tile, read
//      coalesced by the tile;
//   3. the tile computes the raw key, its members taking the non-bag lanes
//      j = t, t + G, ... and the occupied bag slots m = t, t + G, ...,
//      combined by __shfl_xor_sync butterflies (XOR for the non-bag
//      streams, addition mod 2^32 for the bag streams: bit-identical at
//      every G);
//   4. one member probes the direct-mapped memo row memo_slot(raw); a hit
//      returns the row's fingerprint, and hits are counted a state;
//   5. on a miss the tile computes the min over the P permutations, split
//      over its members (canon_memo.cuh), then that member claims the slot
//      with atomicMax of its lane index and writes the lane.
// A second launch lets only each slot's winner write its whole row (key and
// value) and release the claim, so no row is ever torn: CUDA promises no
// 16-byte single-copy atomicity, and the reference writes key+value in one
// row scatter (rt_memo_insert_lane of common.cuh). Memo hit counts can
// differ from the reference (it also dedups equal raw keys inside a chunk);
// fingerprints cannot.
//
// Two builds: NW = 2 for the 2-word bags with at most four plain or Nil-able
// message fields (Raft, pull, KRaft, --net-faults); NW = 0, the general one,
// for N-word bags (up to CT_MAX_WORDS words) and the bitmask kind (up to
// CT_MAX_FIELDS message fields): the spec's CT_GENERAL picks one. The
// 2-word build takes tiles of 8 (P = 6: six members hash one permutation
// each), the general one tiles of 32 (P = 24: one each; 8 states a block,
// 40 KB of shared memory at the four-server JointConsensus rows, 4 blocks
// and 32 warps an SM at 64 registers): of the tiles of 4 to 32 these were
// the fastest cold on the chunks of scripts/canon_groups.py --memo (the
// 2-word ones within 15% of each other, whose chunks take 0.03-0.1 ms).
//
// Bound: on a cold chunk, operations: per valid lane about (1 + P) hashes of
// K non-bag lanes + NW + 1 streams per occupied slot, ~24 INT32 operations
// each (an fmix32 pair); on a warm one the valid lanes' raw hashes, or the
// bytes (the valid lanes' view rows read once, each memo row read and
// written once, the fingerprints written).
#include "canon_memo.cuh"
#include "canon_tile.cuh"

// the tile of each build (scripts/canon_groups.py --memo builds others to
// compare)
#ifndef CM_G2
#define CM_G2 8
#endif
#ifndef CM_GGEN
#define CM_GGEN 32
#endif
template <int NW>
constexpr int cm_tile = NW ? CM_G2 : CM_GGEN;

template <int NW>
__global__ void __launch_bounds__(CT_BLOCK)
canon_memo_kernel(const int* __restrict__ gspec, int spec_len, int sym,
                  const int* __restrict__ states, int B, int W, const bool* __restrict__ valid,
                  const long long* __restrict__ memo, int mcap, int* __restrict__ claim,
                  long long* __restrict__ fps, long long* __restrict__ raw_out,
                  int* __restrict__ slot_out, unsigned long long* __restrict__ n_hit) {
  ct_memo_tile<NW, cm_tile<NW>>(gspec, spec_len, sym != 0, states, B, W, valid, memo, mcap,
                                claim, fps, raw_out, slot_out, n_hit,
                                [](const int* sp, const int* v, CtTile<cm_tile<NW>>& g) {
                                  return cm_canon<NW>(sp, v, g);
                                });
}

__global__ void memo_insert_kernel(long long* __restrict__ memo, int* __restrict__ claim,
                                   const long long* __restrict__ fps,
                                   const long long* __restrict__ raw,
                                   const int* __restrict__ slot, int B) {
  rt_memo_insert_lane(memo, claim, fps, raw, slot, B);
}

// the spec vector checked against the builds (with symmetry at most
// CM_MAX_S servers)
static bool cm_spec_ok(const int* hspec, int spec_len, int sym) {
  return ct_spec_ok(hspec, spec_len) && (!sym || hspec[CT_S] <= CM_MAX_S);
}

// hspec: the spec vector in host memory, spec: the same on the device;
// sym: 0 takes the raw key as the fingerprint (no memo, no second launch)
extern "C" int canon_memo(const int* hspec, const int* spec, int spec_len, int sym,
                          const int* states, int B, int W, const bool* valid, long long* memo,
                          int mcap, int* claim, long long* fps, long long* raw, int* slot,
                          long long* n_hit, void* stream) {
  if (!cm_spec_ok(hspec, spec_len, sym) || W < hspec[CT_VL]) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool general = hspec[CT_GENERAL] != 0;
  const auto kernel = general ? canon_memo_kernel<0> : canon_memo_kernel<2>;
  const int G = general ? cm_tile<0> : cm_tile<2>;
  int nt;
  size_t smem;
  cudaError_t e = ct_block((const void*)kernel, G, spec_len, hspec[CT_VL], &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  const int per = nt / G;
  kernel<<<(B + per - 1) / per, nt, smem, s>>>(spec, spec_len, sym, states, B, W, valid, memo,
                                               mcap, claim, fps, raw, slot,
                                               (unsigned long long*)n_hit);
  e = cudaGetLastError();
  if (e != cudaSuccess || !sym) return (int)e;
  memo_insert_kernel<<<(B + 255) / 256, 256, 0, s>>>(memo, claim, fps, raw, slot, B);
  return (int)cudaGetLastError();
}

// The launch shape canon_memo takes for this spec and what it reaches:
// out = {G, threads a block, dynamic shared bytes a block, resident blocks
// an SM, warps an SM}
extern "C" int canon_memo_occupancy(const int* hspec, int spec_len, int* out) {
  if (!ct_spec_ok(hspec, spec_len)) return (int)cudaErrorInvalidValue;
  const bool general = hspec[CT_GENERAL] != 0;
  const auto kernel = general ? canon_memo_kernel<0> : canon_memo_kernel<2>;
  return (int)ct_occupancy((const void*)kernel, general ? cm_tile<0> : cm_tile<2>, spec_len,
                           hspec[CT_VL], out);
}

// canon_tiered — memoized canonical fingerprints of layouts with five or
// more servers, and their server signatures.
//
// Replaces raft_tpu/ops/symmetry.py:1230 fingerprints_memo on the path of
// layouts with S >= 5, where the reference canonicalizes through the
// signature tiers (_signatures :581, _tier_pre :1081, _hash_dyn :944,
// _tier3_local :1143, _tier3_full :1193); the device code is
// canon_tiers.cuh. Two entry points:
//
//   canon_tiered      per lane (one thread each): the raw key (the view's
//                     hash with no permutation), a probe of the memo row
//                     memo_slot(raw); on a miss the signatures and the min
//                     of the permuted hash over the admissible
//                     permutations, and an atomicMax claim of the slot. A
//                     second launch lets only each slot's winner write its
//                     whole row and release the claim, so no row is torn
//                     (the memo protocol of common.cuh, shared with
//                     canon_memo).
//   canon_signatures  the [B, S] signatures (enc int64), for checks.
//
// Both are built twice from the templates of canon_tiers.cuh: NW = 2 for
// the 2-word bags (Raft, FlexibleRaft, KRaft at five servers) and NW = 0,
// the general path, for N-word bags, member-set message fields and fields
// of several lanes a server (the reconfiguration specs); the spec's
// CT_GENERAL picks one.
//
// Each block stages the spec vector and its rows in shared memory (row
// stride VL + 1); the rows per block follow from VL (rt_rows_per_block,
// common.cuh): 32 at the five-server layouts' 327 to 1,221 view lanes.
//
// Bound: operations on a cold chunk — per missed lane the signatures (about
// (1 + rounds) * (NF + 1) fmix32 pairs per occupied slot plus the per-server
// folds) and one permuted hash (K non-bag lanes + 3 per occupied slot) per
// admissible permutation; bytes (the view lanes read once, each memo row
// read and written once) on a warm one. On the general path the key words,
// message fields and per-record folds sit in local arrays (CT_MAX_WORDS,
// CT_MAX_FIELDS), which may spill to local memory.
#include "canon_tiers.cuh"

#define CT_THREADS_MAX 128  // rt_rows_per_block's most rows per block

// stage the spec vector, then the block's rows; returns this thread's row
__device__ __forceinline__ const int* ct_stage(int* smem, const int* __restrict__ gspec,
                                               int spec_len, const int* __restrict__ states,
                                               int B, int W, int VL) {
  for (int e = threadIdx.x; e < spec_len; e += blockDim.x) smem[e] = gspec[e];
  const int* v = rt_stage_rows(smem + spec_len, states, B, W, VL);
  __syncthreads();
  return v;
}

template <int NW>
__global__ void __launch_bounds__(CT_THREADS_MAX)
canon_tiered_kernel(const int* __restrict__ gspec, int spec_len, const int* __restrict__ states,
                    int B, int W, const bool* __restrict__ valid,
                    const long long* __restrict__ memo, int mcap, int* __restrict__ claim,
                    long long* __restrict__ fps, long long* __restrict__ raw_out,
                    int* __restrict__ slot_out, unsigned long long* __restrict__ n_hit) {
  extern __shared__ int smem[];
  const int* v = ct_stage(smem, gspec, spec_len, states, B, W, gspec[CT_VL]);
  const int* sp = smem;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  rt_memo_lane(active, true, valid, b, active ? ct_raw<NW>(sp, v) : 0ull, memo, mcap, claim,
               fps, raw_out, slot_out, n_hit, [&] { return ct_canon<NW>(sp, v); });
}

__global__ void ct_memo_insert(long long* __restrict__ memo, int* __restrict__ claim,
                               const long long* __restrict__ fps,
                               const long long* __restrict__ raw,
                               const int* __restrict__ slot, int B) {
  rt_memo_insert_lane(memo, claim, fps, raw, slot, B);
}

template <int NW>
__global__ void __launch_bounds__(CT_THREADS_MAX)
canon_signatures_kernel(const int* __restrict__ gspec, int spec_len,
                        const int* __restrict__ states, int B, int W,
                        long long* __restrict__ out) {
  extern __shared__ int smem[];
  const int VL = gspec[CT_VL], S = gspec[CT_S];
  const int* v = ct_stage(smem, gspec, spec_len, states, B, W, VL);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint64_t sig[CT_MAX_S];
  ct_signatures<NW>(smem, v, sig);
  for (int i = 0; i < S; ++i) out[b * S + i] = rt_enc(sig[i]);
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

// hspec: the spec vector in host memory, spec: the same on the device
extern "C" int canon_tiered(const int* hspec, const int* spec, int spec_len, const int* states,
                            int B, int W, const bool* valid, long long* memo, int mcap,
                            int* claim, long long* fps, long long* raw, int* slot,
                            long long* n_hit, void* stream) {
  if (!ct_spec_ok(hspec, spec_len) || W < hspec[CT_VL]) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto kernel = hspec[CT_GENERAL] ? canon_tiered_kernel<0> : canon_tiered_kernel<2>;
  int nt;
  size_t smem;
  cudaError_t e = rt_rows_per_block((const void*)kernel, (size_t)spec_len * 4, hspec[CT_VL],
                                    &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + nt - 1) / nt, nt, smem, s>>>(spec, spec_len, states, B, W, valid, memo, mcap,
                                             claim, fps, raw, slot,
                                             (unsigned long long*)n_hit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ct_memo_insert<<<(B + 255) / 256, 256, 0, s>>>(memo, claim, fps, raw, slot, B);
  return (int)cudaGetLastError();
}

extern "C" int canon_signatures(const int* hspec, const int* spec, int spec_len,
                                const int* states, int B, int W, long long* out, void* stream) {
  if (!ct_spec_ok(hspec, spec_len) || W < hspec[CT_VL]) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const auto kernel = hspec[CT_GENERAL] ? canon_signatures_kernel<0>
                                        : canon_signatures_kernel<2>;
  int nt;
  size_t smem;
  cudaError_t e = rt_rows_per_block((const void*)kernel, (size_t)spec_len * 4, hspec[CT_VL],
                                    &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + nt - 1) / nt, nt, smem, (cudaStream_t)stream>>>(spec, spec_len, states, B, W,
                                                                out);
  return (int)cudaGetLastError();
}

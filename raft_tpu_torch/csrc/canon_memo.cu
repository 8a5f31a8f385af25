// canon_memo — memoized canonical (VIEW + SYMMETRY) fingerprints.
//
// Replaces raft_tpu/ops/symmetry.py:1230 fingerprints_memo on the path of
// layouts with at most four servers, together with what it calls there:
// :571 _perm_hash (the raw identity-permutation view hash, the memo key),
// :543 _bag_hash_pair, :850 _hash_static over the full S! direct tables of
// :490 _build_direct, :1017 _masked_min(view, None), and the u32 streams of
// raft_tpu/ops/hashing.py (mix32, combine_pair, hash_lanes_pair, memo_slot).
//
// Per lane (one thread each):
//   1. raw = hash of the view with no remap (non-bag lanes positional and
//      XOR-reduced, occupied bag slots hashed position-free and ADDED);
//   2. probe the direct-mapped memo row memo_slot(raw); a hit returns the
//      row's canonical fingerprint;
//   3. on a miss, the min over all P = S! permutations of the permuted
//      view's hash: non-bag lanes hash against the permutation's positional
//      salts (server-valued lanes and bitmasks remapped through the value
//      tables), message keys get their server fields remapped in place by
//      kind (a plain index u -> perm[u]; a Nil-able one, KRaft's mleader:
//      0 -> 0, u -> perm[u - 1] + 1; a value naming no server -> 0, as the
//      reference's one-hot remap sums give, raft_tpu/ops/symmetry.py:887-900);
//   4. the missed lane claims its memo slot with atomicMax of its index.
// A second launch lets only each slot's winner write its whole row (key and
// value) and release the claim, so no row is ever torn: CUDA promises no
// 16-byte single-copy atomicity, and the reference writes key+value in one
// row scatter (rt_memo_lane and rt_memo_insert_lane of common.cuh, shared
// with canon_tiered). Memo hit counts can differ from the reference (it also
// dedups equal raw keys inside a chunk); fingerprints cannot.
//
// Tables: the host (ops/symmetry.py Canonicalizer._kernel_tables) packs
// the static per-permutation tables into one u32 buffer, staged into
// shared memory per block; the block's state rows are staged too (row
// stride VL+1 so threads hit distinct banks), as many rows per block as
// rt_rows_per_block (common.cuh) sizes from VL: 64 at Raft.cfg's 189 lanes,
// down to 32 for wide rows.
//
// Bound: bytes at the main path's shapes (65,536 state rows of 192 lanes
// read, the 2^21-row memo read and written once each), ahead of the
// operations: about P * (K non-bag lanes + 3 words per occupied bag slot)
// fmix32 pairs per missed lane. The design stages each block's rows in
// shared memory (coalesced loads) and skips the permutations on a hit.
#include "common.cuh"

#define CANON_THREADS_MAX 128  // rt_rows_per_block's most rows per block
#define MAX_FIELDS 4
#define EMPTY_WORD (1 << 30)

struct Params {
  int S, P, K, n_plain, n_val, n_bm;
  int hi_off, lo_off, cnt_off, M, sym, n_fields;
  uint32_t ka, kb, wa[3], wb[3], sx[3];
  int VL;
  int f_word[MAX_FIELDS], f_shift[MAX_FIELDS], f_kind[MAX_FIELDS];  // kind 1: Nil-able
  uint32_t f_mask[MAX_FIELDS];
};

struct Tables {
  const uint32_t *lanes, *pa, *pb, *xa, *xb, *rpa, *rpb, *rxa, *rxb;
  const uint32_t *valmap, *pow2, *perms;
};

__device__ __forceinline__ Tables carve(const uint32_t* t, const Params& p) {
  Tables T;
  const int K = p.K, PK = p.P * p.K;
  T.lanes = t;
  T.pa = T.lanes + K;
  T.pb = T.pa + PK;
  T.xa = T.pb + PK;
  T.xb = T.xa + PK;
  T.rpa = T.xb + PK;
  T.rpb = T.rpa + K;
  T.rxa = T.rpb + K;
  T.rxb = T.rxa + K;
  T.valmap = T.rxb + K;
  T.pow2 = T.valmap + p.P * (p.S + 1);
  T.perms = T.pow2 + p.P * p.S;
  return T;
}

// hash of one message slot's words under given (possibly remapped) key
// words; the count part (ca, cb) does not depend on the permutation
__device__ __forceinline__ void slot_hash(const Params& p, uint32_t hi, uint32_t lo,
                                          uint32_t ca, uint32_t cb, uint32_t* ha,
                                          uint32_t* hb) {
  uint32_t h0 = hi ^ p.sx[0], h1 = lo ^ p.sx[1];
  uint32_t a = rt_mix32(h0 * RT_KA + p.wa[0]) ^ rt_mix32(h1 * RT_KA + p.wa[1]) ^ ca;
  uint32_t b = rt_mix32(h0 * RT_KB + p.wb[0]) ^ rt_mix32(h1 * RT_KB + p.wb[1]) ^ cb;
  *ha = rt_mix32(a + RT_KB);
  *hb = rt_mix32(b + RT_KA);
}

__device__ uint64_t raw_hash(const Params& p, const Tables& T, const int* v) {
  uint32_t ra = 0, rb = 0;
  for (int j = 0; j < p.K; ++j) {
    uint32_t x = (uint32_t)v[T.lanes[j]];
    ra ^= rt_mix32((x ^ T.rxa[j]) * RT_KA + T.rpa[j]);
    rb ^= rt_mix32((x ^ T.rxb[j]) * RT_KB + T.rpb[j]);
  }
  ra ^= p.ka;
  rb ^= p.kb;
  uint32_t ba = 0, bb = 0;
  for (int m = 0; m < p.M; ++m) {
    int hi = v[p.hi_off + m];
    if (hi == EMPTY_WORD) continue;
    uint32_t c = (uint32_t)v[p.cnt_off + m] ^ p.sx[2];
    uint32_t ca = rt_mix32(c * RT_KA + p.wa[2]), cb = rt_mix32(c * RT_KB + p.wb[2]);
    uint32_t ha, hb;
    slot_hash(p, (uint32_t)hi, (uint32_t)v[p.lo_off + m], ca, cb, &ha, &hb);
    ba += ha;
    bb += hb;
  }
  return rt_combine(ra ^ ba, rb ^ bb);
}

template <int P>
__device__ uint64_t canon_hash(const Params& p, const Tables& T, const int* v) {
  uint32_t aa[P], ab[P], ga[P], gb[P];
#pragma unroll
  for (int t = 0; t < P; ++t) aa[t] = ab[t] = ga[t] = gb[t] = 0;
  const int K = p.K, S = p.S;
  int j = 0;
  for (; j < p.n_plain; ++j) {  // value-invariant lanes: only positions move
    uint32_t x = (uint32_t)v[T.lanes[j]];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      aa[t] ^= rt_mix32((x ^ T.xa[t * K + j]) * RT_KA + T.pa[t * K + j]);
      ab[t] ^= rt_mix32((x ^ T.xb[t * K + j]) * RT_KB + T.pb[t * K + j]);
    }
  }
  for (; j < p.n_plain + p.n_val; ++j) {  // server values: 0 = Nil, i+1 = server i
    int x = v[T.lanes[j]];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      uint32_t y = (x >= 1 && x <= S) ? T.valmap[t * (S + 1) + x] : 0u;
      aa[t] ^= rt_mix32((y ^ T.xa[t * K + j]) * RT_KA + T.pa[t * K + j]);
      ab[t] ^= rt_mix32((y ^ T.xb[t * K + j]) * RT_KB + T.pb[t * K + j]);
    }
  }
  for (; j < K; ++j) {  // server bitmasks: bit q moves to bit perm[q]
    int x = v[T.lanes[j]];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      uint32_t y = 0;
      for (int q = 0; q < S; ++q) y += (uint32_t)((x >> q) & 1) * T.pow2[t * S + q];
      aa[t] ^= rt_mix32((y ^ T.xa[t * K + j]) * RT_KA + T.pa[t * K + j]);
      ab[t] ^= rt_mix32((y ^ T.xb[t * K + j]) * RT_KB + T.pb[t * K + j]);
    }
  }
  for (int m = 0; m < p.M; ++m) {  // the bag: a multiset sum over slots
    int hi = v[p.hi_off + m];
    if (hi == EMPTY_WORD) continue;
    uint32_t w[2] = {(uint32_t)v[p.lo_off + m], (uint32_t)hi};  // packer words
    uint32_t c = (uint32_t)v[p.cnt_off + m] ^ p.sx[2];
    uint32_t ca = rt_mix32(c * RT_KA + p.wa[2]), cb = rt_mix32(c * RT_KB + p.wb[2]);
    uint32_t val[MAX_FIELDS];
    for (int f = 0; f < p.n_fields; ++f) val[f] = (w[p.f_word[f]] >> p.f_shift[f]) & p.f_mask[f];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      uint32_t nw[2] = {w[0], w[1]};
      for (int f = 0; f < p.n_fields; ++f) {
        uint32_t nv;
        if (p.f_kind[f])
          nv = (val[f] >= 1u && val[f] <= (uint32_t)S) ? T.perms[t * S + val[f] - 1] + 1u : 0u;
        else
          nv = val[f] < (uint32_t)S ? T.perms[t * S + val[f]] : 0u;
        uint32_t& word = nw[p.f_word[f]];
        word = (word & ~(p.f_mask[f] << p.f_shift[f])) | (nv << p.f_shift[f]);
      }
      uint32_t ha, hb;
      slot_hash(p, nw[1], nw[0], ca, cb, &ha, &hb);
      ga[t] += ha;
      gb[t] += hb;
    }
  }
  uint64_t best = ~0ull;
#pragma unroll
  for (int t = 0; t < P; ++t) {
    uint64_t h = rt_combine(aa[t] ^ p.ka ^ ga[t], ab[t] ^ p.kb ^ gb[t]);
    best = h < best ? h : best;
  }
  return best;
}

template <int P>
__global__ void __launch_bounds__(CANON_THREADS_MAX)
canon_memo_kernel(Params p, const uint32_t* __restrict__ gtab, int tab_words,
                  const int* __restrict__ states, int B, int W,
                  const bool* __restrict__ valid, const long long* __restrict__ memo,
                  int mcap, int* __restrict__ claim, long long* __restrict__ fps,
                  long long* __restrict__ raw_out, int* __restrict__ slot_out,
                  unsigned long long* __restrict__ n_hit) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;
  for (int e = threadIdx.x; e < tab_words; e += blockDim.x) tab[e] = gtab[e];
  const int* v = rt_stage_rows((int*)(smem + tab_words), states, B, W, p.VL);
  __syncthreads();
  const Tables T = carve(tab, p);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  rt_memo_lane(active, p.sym != 0, valid, b, active ? raw_hash(p, T, v) : 0ull, memo, mcap,
               claim, fps, raw_out, slot_out, n_hit, [&] { return canon_hash<P>(p, T, v); });
}

__global__ void memo_insert_kernel(long long* __restrict__ memo, int* __restrict__ claim,
                                   const long long* __restrict__ fps,
                                   const long long* __restrict__ raw,
                                   const int* __restrict__ slot, int B) {
  rt_memo_insert_lane(memo, claim, fps, raw, slot, B);
}

template <int P>
static cudaError_t launch(const Params& p, const uint32_t* tab, int tab_words, const int* states,
                          int B, int W, const bool* valid, long long* memo, int mcap, int* claim,
                          long long* fps, long long* raw, int* slot, unsigned long long* n_hit,
                          cudaStream_t s) {
  int nt;
  size_t smem;
  cudaError_t e = rt_rows_per_block((const void*)canon_memo_kernel<P>, (size_t)tab_words * 4,
                                    p.VL, &nt, &smem);
  if (e != cudaSuccess) return e;
  canon_memo_kernel<P><<<(B + nt - 1) / nt, nt, smem, s>>>(
      p, tab, tab_words, states, B, W, valid, memo, mcap, claim, fps, raw, slot, n_hit);
  return cudaGetLastError();
}

extern "C" int canon_memo(const int* hp, int n_hp, const uint32_t* tab, int tab_bytes,
                          const int* states, int B, int W, const bool* valid,
                          long long* memo, int mcap, int* claim, long long* fps,
                          long long* raw, int* slot, long long* n_hit, void* stream) {
  Params p;
  int* fixed[] = {&p.S, &p.P, &p.K, &p.n_plain, &p.n_val, &p.n_bm, &p.hi_off, &p.lo_off,
                  &p.cnt_off, &p.M, &p.sym, &p.n_fields};
  const int nfixed = (int)(sizeof(fixed) / sizeof(fixed[0]));
  if (n_hp < nfixed + 12) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nfixed; ++i) *fixed[i] = hp[i];
  int k = nfixed;
  p.ka = (uint32_t)hp[k++];
  p.kb = (uint32_t)hp[k++];
  for (int i = 0; i < 3; ++i) p.wa[i] = (uint32_t)hp[k++];
  for (int i = 0; i < 3; ++i) p.wb[i] = (uint32_t)hp[k++];
  for (int i = 0; i < 3; ++i) p.sx[i] = (uint32_t)hp[k++];
  p.VL = hp[k++];
  if (p.n_fields > MAX_FIELDS || n_hp != k + 4 * p.n_fields) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < p.n_fields; ++f) {
    p.f_word[f] = hp[k++];
    p.f_shift[f] = hp[k++];
    p.f_mask[f] = (uint32_t)hp[k++];
    p.f_kind[f] = hp[k++];
  }
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* hits = (unsigned long long*)n_hit;
  const int tw = tab_bytes / 4;
  cudaError_t e;
  switch (p.P) {
    case 1: e = launch<1>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 2: e = launch<2>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 6: e = launch<6>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 24: e = launch<24>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (p.sym) {
    memo_insert_kernel<<<(B + 255) / 256, 256, 0, s>>>(memo, claim, fps, raw, slot, B);
    e = cudaGetLastError();
  }
  return (int)e;
}

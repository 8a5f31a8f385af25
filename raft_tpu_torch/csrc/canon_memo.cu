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
//      reference's one-hot remap sums give, raft_tpu/ops/symmetry.py:887-900;
//      a member-set bitmask of the reconfiguration specs: bit q -> bit
//      perm[q], :902); a slot hashes as the streams of its key words in
//      sort order, then its count, each salted by its stream index (:541-560
//      and :823-858: (hi, lo) for a 2-word bag, words 0..N-1 for an N-word
//      one), so the bag needs no re-sort under a permutation;
//   4. the missed lane claims its memo slot with atomicMax of its index.
// A second launch lets only each slot's winner write its whole row (key and
// value) and release the claim, so no row is ever torn: CUDA promises no
// 16-byte single-copy atomicity, and the reference writes key+value in one
// row scatter (rt_memo_lane and rt_memo_insert_lane of common.cuh, shared
// with canon_tiered). Memo hit counts can differ from the reference (it also
// dedups equal raw keys inside a chunk); fingerprints cannot.
//
// Two instantiations per permutation count: the 2-word bags with at most
// four plain or Nil-able message fields (Raft, pull, KRaft) take a path
// with the word count fixed at compile time; the N-word bags (up to
// MAX_WORDS words) and the bitmask kind (up to MAX_FIELDS message fields)
// take the general one.
//
// Tables: the host (ops/symmetry.py Canonicalizer._kernel_tables) packs
// the static per-permutation tables into one u32 buffer. The 2-word path
// stages it in shared memory per block, with the block's state rows (row
// stride VL+1 so threads hit distinct banks), as many rows per block as
// rt_rows_per_block (common.cuh) sizes from VL: 64 at Raft.cfg's 189 lanes,
// down to 32 for wide rows. The general path reads the tables and each
// lane's row through the cache, 128 lanes a block and no shared memory, so
// several blocks share an SM (staged, JointConsensus' rows of 1,036 lanes
// would leave one block of 32 lanes an SM).
//
// Bound: bytes at the main path's shapes (65,536 state rows of 192 lanes
// read, the 2^21-row memo read and written once each), ahead of the
// operations: about P * (K non-bag lanes + N + 1 streams per occupied bag
// slot) fmix32 pairs per missed lane. The design stages each block's rows in
// shared memory (coalesced loads) and skips the permutations on a hit.
#include "common.cuh"

#define CANON_THREADS_MAX 128  // rt_rows_per_block's most rows per block
#define MAX_FIELDS 32          // message remap fields (ops/symmetry.py MAX_MSG_FIELDS)
#define MAX_WORDS 8            // key words of a bag (ops/symmetry.py MAX_BAG_WORDS)
#define FAST_FIELDS 4          // the 2-word path's most message fields
#define EMPTY_WORD (1 << 30)

enum { KIND_SERVER = 0, KIND_SERVER_NIL = 1, KIND_SERVER_BITMASK = 2 };

struct Params {
  int S, P, K, n_plain, n_val, n_bm;
  int M, cnt_off, sym, n_fields, n_words, VL;
  uint32_t ka, kb;
  int word_off[MAX_WORDS];  // each key word's slot offset in a row, in stream (sort) order
  uint32_t wa[MAX_WORDS + 1], wb[MAX_WORDS + 1], sx[MAX_WORDS + 1];  // per stream, count last
  int f_stream[MAX_FIELDS], f_shift[MAX_FIELDS], f_kind[MAX_FIELDS];
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

// the key words of a bag (NW at compile time, or p.n_words when NW is 0)
template <int NW>
__device__ __forceinline__ int n_words(const Params& p) {
  return NW ? NW : p.n_words;
}

// hash of one message slot's key words w[0..nw) (stream order, possibly
// remapped); the count part (ca, cb) does not depend on the permutation
template <int NW>
__device__ __forceinline__ void slot_hash(const Params& p, const uint32_t* w, uint32_t ca,
                                          uint32_t cb, uint32_t* ha, uint32_t* hb) {
  uint32_t a = ca, b = cb;
#pragma unroll
  for (int k = 0; k < (NW ? NW : MAX_WORDS); ++k) {
    if (!NW && k >= p.n_words) break;
    const uint32_t h = w[k] ^ p.sx[k];
    a ^= rt_mix32(h * RT_KA + p.wa[k]);
    b ^= rt_mix32(h * RT_KB + p.wb[k]);
  }
  *ha = rt_mix32(a + RT_KB);
  *hb = rt_mix32(b + RT_KA);
}

// the count stream of a slot
__device__ __forceinline__ void count_hash(const Params& p, int cnt, int nw, uint32_t* ca,
                                           uint32_t* cb) {
  const uint32_t c = (uint32_t)cnt ^ p.sx[nw];
  *ca = rt_mix32(c * RT_KA + p.wa[nw]);
  *cb = rt_mix32(c * RT_KB + p.wb[nw]);
}

template <int NW>
__device__ uint64_t raw_hash(const Params& p, const Tables& T, const int* v) {
  uint32_t ra = 0, rb = 0;
  for (int j = 0; j < p.K; ++j) {
    uint32_t x = (uint32_t)v[T.lanes[j]];
    ra ^= rt_mix32((x ^ T.rxa[j]) * RT_KA + T.rpa[j]);
    rb ^= rt_mix32((x ^ T.rxb[j]) * RT_KB + T.rpb[j]);
  }
  ra ^= p.ka;
  rb ^= p.kb;
  const int nw = n_words<NW>(p);
  uint32_t ba = 0, bb = 0;
  for (int m = 0; m < p.M; ++m) {
    const int w0 = v[p.word_off[0] + m];
    if (w0 == EMPTY_WORD) continue;
    uint32_t w[NW ? NW : MAX_WORDS];
#pragma unroll
    for (int k = 0; k < (NW ? NW : MAX_WORDS); ++k)
      if (NW || k < nw) w[k] = (uint32_t)v[p.word_off[k] + m];
    uint32_t ca, cb, ha, hb;
    count_hash(p, v[p.cnt_off + m], nw, &ca, &cb);
    slot_hash<NW>(p, w, ca, cb, &ha, &hb);
    ba += ha;
    bb += hb;
  }
  return rt_combine(ra ^ ba, rb ^ bb);
}

// a message field's value under permutation t, by its kind
__device__ __forceinline__ uint32_t remap_field(const Params& p, const Tables& T, int t, int f,
                                                uint32_t val) {
  const int S = p.S;
  if (p.f_kind[f] == KIND_SERVER) return val < (uint32_t)S ? T.perms[t * S + val] : 0u;
  if (p.f_kind[f] == KIND_SERVER_NIL)
    return (val >= 1u && val <= (uint32_t)S) ? T.perms[t * S + val - 1] + 1u : 0u;
  uint32_t y = 0;  // KIND_SERVER_BITMASK
  for (int q = 0; q < S; ++q) y += ((val >> q) & 1u) * T.pow2[t * S + q];
  return y;
}

// NW = 2: the 2-word bags with at most FAST_FIELDS plain or Nil-able
// message fields; NW = 0: up to MAX_WORDS words and MAX_FIELDS fields of
// any kind
template <int P, int NW>
__device__ uint64_t canon_hash(const Params& p, const Tables& T, const int* v) {
  constexpr int WMAX = NW ? NW : MAX_WORDS;
  constexpr int FMAX = NW ? FAST_FIELDS : MAX_FIELDS;
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
  const int nw = n_words<NW>(p);
  for (int m = 0; m < p.M; ++m) {  // the bag: a multiset sum over slots
    const int w0 = v[p.word_off[0] + m];
    if (w0 == EMPTY_WORD) continue;
    uint32_t w[WMAX];  // the key words, stream order
#pragma unroll
    for (int k = 0; k < WMAX; ++k)
      if (NW || k < nw) w[k] = (uint32_t)v[p.word_off[k] + m];
    uint32_t ca, cb;
    count_hash(p, v[p.cnt_off + m], nw, &ca, &cb);
    uint32_t val[FMAX];
    for (int f = 0; f < p.n_fields; ++f)
      val[f] = (w[p.f_stream[f]] >> p.f_shift[f]) & p.f_mask[f];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      uint32_t nwd[WMAX];
#pragma unroll
      for (int k = 0; k < WMAX; ++k)
        if (NW || k < nw) nwd[k] = w[k];
      for (int f = 0; f < p.n_fields; ++f) {
        const uint32_t nv = remap_field(p, T, t, f, val[f]);
        uint32_t& word = nwd[p.f_stream[f]];
        word = (word & ~(p.f_mask[f] << p.f_shift[f])) | (nv << p.f_shift[f]);
      }
      uint32_t ha, hb;
      slot_hash<NW>(p, nwd, ca, cb, &ha, &hb);
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

template <int P, int NW>
__global__ void __launch_bounds__(CANON_THREADS_MAX)
canon_memo_kernel(Params p, const uint32_t* __restrict__ gtab, int tab_words,
                  const int* __restrict__ states, int B, int W,
                  const bool* __restrict__ valid, const long long* __restrict__ memo,
                  int mcap, int* __restrict__ claim, long long* __restrict__ fps,
                  long long* __restrict__ raw_out, int* __restrict__ slot_out,
                  unsigned long long* __restrict__ n_hit) {
  extern __shared__ uint32_t smem[];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  // the 2-word path stages the tables and its block's rows in shared
  // memory; the general one reads both through the cache: a row of 1,036
  // lanes a thread would leave one 32-thread block an SM
  const int staged = NW ? tab_words : 0;
  for (int e = threadIdx.x; e < staged; e += blockDim.x) smem[e] = gtab[e];
  const int* v = NW ? rt_stage_rows((int*)(smem + staged), states, B, W, p.VL)
                    : states + (active ? b : 0) * (long long)W;
  __syncthreads();
  const Tables T = carve(NW ? smem : gtab, p);
  rt_memo_lane(active, p.sym != 0, valid, b, active ? raw_hash<NW>(p, T, v) : 0ull, memo, mcap,
               claim, fps, raw_out, slot_out, n_hit, [&] { return canon_hash<P, NW>(p, T, v); });
}

__global__ void memo_insert_kernel(long long* __restrict__ memo, int* __restrict__ claim,
                                   const long long* __restrict__ fps,
                                   const long long* __restrict__ raw,
                                   const int* __restrict__ slot, int B) {
  rt_memo_insert_lane(memo, claim, fps, raw, slot, B);
}

template <int P, int NW>
static cudaError_t launch(const Params& p, const uint32_t* tab, int tab_words, const int* states,
                          int B, int W, const bool* valid, long long* memo, int mcap, int* claim,
                          long long* fps, long long* raw, int* slot, unsigned long long* n_hit,
                          cudaStream_t s) {
  int nt = CANON_THREADS_MAX;
  size_t smem = 0;
  if (NW) {
    cudaError_t e = rt_rows_per_block((const void*)canon_memo_kernel<P, NW>,
                                      (size_t)tab_words * 4, p.VL, &nt, &smem);
    if (e != cudaSuccess) return e;
  }
  canon_memo_kernel<P, NW><<<(B + nt - 1) / nt, nt, smem, s>>>(
      p, tab, tab_words, states, B, W, valid, memo, mcap, claim, fps, raw, slot, n_hit);
  return cudaGetLastError();
}

template <int P>
static cudaError_t launch_p(const Params& p, bool fast, const uint32_t* tab, int tw,
                            const int* states, int B, int W, const bool* valid, long long* memo,
                            int mcap, int* claim, long long* fps, long long* raw, int* slot,
                            unsigned long long* hits, cudaStream_t s) {
  if (fast)
    return launch<P, 2>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits,
                        s);
  return launch<P, 0>(p, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s);
}

// hp: the int32 params of ops/symmetry.py Canonicalizer._kernel_tables —
// S, P, K, n_plain, n_val, n_bm, M, cnt_off, sym, n_fields, n_words, VL,
// ka, kb, the n_words key-word offsets (stream order), wa, wb and sx of
// the n_words + 1 streams, then (stream, shift, mask, kind) per message
// field.
extern "C" int canon_memo(const int* hp, int n_hp, const uint32_t* tab, int tab_bytes,
                          const int* states, int B, int W, const bool* valid,
                          long long* memo, int mcap, int* claim, long long* fps,
                          long long* raw, int* slot, long long* n_hit, void* stream) {
  Params p;
  int* fixed[] = {&p.S, &p.P, &p.K, &p.n_plain, &p.n_val, &p.n_bm, &p.M, &p.cnt_off,
                  &p.sym, &p.n_fields, &p.n_words, &p.VL};
  const int nfixed = (int)(sizeof(fixed) / sizeof(fixed[0]));
  if (n_hp < nfixed + 2) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nfixed; ++i) *fixed[i] = hp[i];
  const int nw = p.n_words;
  if (nw < 1 || nw > MAX_WORDS || p.n_fields < 0 || p.n_fields > MAX_FIELDS ||
      n_hp != nfixed + 2 + nw + 3 * (nw + 1) + 4 * p.n_fields)
    return (int)cudaErrorInvalidValue;
  int k = nfixed;
  p.ka = (uint32_t)hp[k++];
  p.kb = (uint32_t)hp[k++];
  for (int i = 0; i < nw; ++i) p.word_off[i] = hp[k++];
  for (int i = 0; i <= nw; ++i) p.wa[i] = (uint32_t)hp[k++];
  for (int i = 0; i <= nw; ++i) p.wb[i] = (uint32_t)hp[k++];
  for (int i = 0; i <= nw; ++i) p.sx[i] = (uint32_t)hp[k++];
  bool fast = nw == 2 && p.n_fields <= FAST_FIELDS;
  for (int f = 0; f < p.n_fields; ++f) {
    p.f_stream[f] = hp[k++];
    p.f_shift[f] = hp[k++];
    p.f_mask[f] = (uint32_t)hp[k++];
    p.f_kind[f] = hp[k++];
    if (p.f_stream[f] < 0 || p.f_stream[f] >= nw) return (int)cudaErrorInvalidValue;
    fast = fast && p.f_kind[f] != KIND_SERVER_BITMASK;
  }
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* hits = (unsigned long long*)n_hit;
  const int tw = tab_bytes / 4;
  cudaError_t e;
  switch (p.P) {
    case 1: e = launch_p<1>(p, fast, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 2: e = launch_p<2>(p, fast, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 6: e = launch_p<6>(p, fast, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    case 24: e = launch_p<24>(p, fast, tab, tw, states, B, W, valid, memo, mcap, claim, fps, raw, slot, hits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (p.sym) {
    memo_insert_kernel<<<(B + 255) / 256, 256, 0, s>>>(memo, claim, fps, raw, slot, B);
    e = cudaGetLastError();
  }
  return (int)e;
}

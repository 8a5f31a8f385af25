// chunk_dedup — the dedup stage of a chunk: sort first, then probe each
// distinct fingerprint in sorted order.
//
// Replaces raft_tpu/checker/device_bfs.py:401 _st_dedup (the probe of the
// seen run and the wave's ladder runs through raft_tpu/checker/util.py:21
// probe_sorted, and :413-420's first occurrence from sort_u64_with_idx)
// and the run emit of _st_finish (:495, sort_u64). For the n enc
// fingerprints of a chunk it writes
//
//   new[i]    lane i holds a real fingerprint (not INT64_MAX), no earlier
//             lane holds it and no run holds it;
//   run[R]    the new fingerprints ascending, INT64_MAX-padded to R lanes;
//   order[n]  (optional) the lanes ordered by (fingerprint as u64, lane).
//
// Design. Pairs (key, lane) order totally, so any correct sort is the
// stable one. An MSD bucket pass splits the chunk into B ~ n / 256 buckets,
// contiguous key ranges that one block each sorts in registers; equal keys
// share a bucket, so the first occurrence is a bucket-local test. Keys are
// 64-bit hashes, but a canonical fingerprint is the least of a state's
// permuted hashes, so they lean toward small values (the least of 24 puts
// 9% of a four-server chunk below 2^56): a bucket is a run of fine bins
// (the key's top CD_FINE_BITS) holding about 1/B of a sample of the lanes.
// The sentinel lanes (INT64_MAX) form a last bucket of their own, kept in
// lane order and never sorted or probed. Three launches at any n > 0 (the
// probe_runs and chunk_sort kernels it replaces took 9 at n = 65,536):
//
//   cd_count       G blocks of lanes. Each block draws the same CD_SAMPLES
//                  evenly spaced lanes, counts their real keys a fine bin
//                  and maps fine bin f to bucket floor(samples below f * B /
//                  real samples); counts its lanes per bucket (shared memory
//                  atomics, the sentinel's by warp ballot) into a [B + 1, G]
//                  matrix; fills the run with INT64_MAX; and finds every
//                  run's slice of every bucket (from the first entry at or
//                  above the bucket's first key to the next bucket's), a
//                  32-ary search by a warp each.
//   cd_scatter     the same blocks: each turns the matrix into its own
//                  offset per bucket (block 0 also writes the bucket starts
//                  and clears the look-back state), scatters its real lanes'
//                  (key, lane) pairs to their buckets and ranks its sentinel
//                  lanes in lane order (new = false, their order slots).
//   cd_sort_probe  a block per bucket, taken in bucket order from an atomic
//                  ticket. Sort: a bucket of at most CD_CAP pairs is a
//                  bitonic network over the least power of two >= its size,
//                  E = 1, 2, 4 or 8 pairs a thread (element e * 256 + t):
//                  strides below a warp by __shfl_xor_sync, strides of a
//                  warp up to the block through shared memory, larger
//                  strides between a thread's own registers. A larger
//                  bucket (skewed keys: all lanes equal, a narrow key range)
//                  sorts its CD_CAP-pair pieces the same way and merges them
//                  in global scratch inside the block, one rank search a
//                  pair a pass (slow, but any bucket size is correct).
//                  Probe: only a sorted position whose key differs from its
//                  left neighbour searches the runs, inside the bucket's
//                  slice of each run (from cd_count). The runs go in groups:
//                  consecutive runs whose slices fit CD_POOL entries
//                  together (the ladder runs) are staged whole in shared
//                  memory in one pass; a longer slice (the seen run's) is
//                  staged every step-th entry, CD_SPK samples a thread with
//                  a fresh key (the top levels of its keys' searches), and
//                  a key finishes between two samples by halving down to
//                  CD_SCAN entries and reading those at once. Every load of
//                  a staging pass is issued before its first store. A key
//                  stops at its first hit, and the block stops when every
//                  key has hit. No fresh array goes through device memory.
//                  Emit: the bucket's new count is published with a
//                  decoupled look-back over the tickets before it (a warp
//                  reads 32 at once), giving the bucket's offset into the
//                  run; a block scan places its new keys.
//
// Bound: bytes — the n keys (8 B) read once, new (1 B) and the R-lane run
// (8 B) written once, the order (4 B) where asked, plus the 32-byte sectors
// of the runs that a lower-bound search of each distinct real key reads
// (early exit at the first hit); operations — those search steps.
#include "common.cuh"

#define MAX_RUNS 32
#define CD_T 256             // threads of a cd_sort_probe block
#define CD_CAP 2048          // pairs a bucket sorts in registers (E = CD_CAP / CD_T at most 8)
#define CD_E (CD_CAP / CD_T) // sorted positions a thread probes
#define CD_POOL 2048         // run entries a block stages in shared memory
#define CD_SCAN 16           // run entries a key reads at once between two samples
#define CD_SPK 2             // samples of a long slice staged a thread with a fresh key
#define CD_MIN_SAMPLES 64    // samples of a long slice staged at least
#define CD_LANE_T 1024       // threads of a cd_count / cd_scatter block
#define CD_FINE_BITS 12      // the fine bins a bucket is a run of: the key's top bits
#define CD_FINE (1 << CD_FINE_BITS)
#define CD_SAMPLES 4096      // lanes whose keys place the bucket boundaries
#define CD_LANES 1024        // lanes a cd_count block takes at least
#define CD_MAX_G 64          // cd_count blocks at most
#define CD_MAX_LOG_B 12      // 4,096 buckets at most (cd_scatter's offsets in shared memory)
#define CD_NEW_BIT 0x80000000u
#define CD_FLAG_AGG (1ull << 32)
#define CD_FLAG_PREFIX (2ull << 32)

struct CdRuns {
  const long long* ptr[MAX_RUNS];
  long long len[MAX_RUNS];
  int n;
};

// the geometry of a call: buckets (B = 2^log_b, plus the sentinel bucket),
// count blocks G and the lanes L each takes
struct CdGeom {
  int log_b, B, G, L;
};

static CdGeom cd_geom(int n) {
  CdGeom g;
  int lg = 0;
  while ((1ll << lg) < (long long)n) ++lg;
  g.log_b = lg > 8 ? lg - 8 : 0;
  if (g.log_b > CD_MAX_LOG_B) g.log_b = CD_MAX_LOG_B;
  g.B = 1 << g.log_b;
  g.G = (n + CD_LANES - 1) / CD_LANES;
  if (g.G < 1) g.G = 1;
  if (g.G > CD_MAX_G) g.G = CD_MAX_G;
  g.L = (n + g.G - 1) / g.G;
  return g;
}

// scratch layout (8-byte words first): keys a, keys b, look-back status,
// the runs' bucket bounds, the fine bins' buckets, then lanes a, lanes b,
// the count matrix, the bucket starts and the ticket
struct CdScratch {
  uint64_t *ka, *kb;
  unsigned long long* status;
  long long* bounds;
  unsigned short* fine_bucket;
  int *la, *lb, *cnt, *bstart;
  unsigned* ticket;
};

static long long cd_scratch_layout(int n, const CdGeom& g, char* base, CdScratch* s) {
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 7) & ~7ll;
    return p;
  };
  uint64_t* ka = (uint64_t*)take(8ll * n);
  uint64_t* kb = (uint64_t*)take(8ll * n);
  unsigned long long* status = (unsigned long long*)take(8ll * g.B);
  long long* bounds = (long long*)take(8ll * MAX_RUNS * (g.B + 1));
  unsigned short* fine_bucket = (unsigned short*)take(2ll * CD_FINE);
  int* la = (int*)take(4ll * n);
  int* lb = (int*)take(4ll * n);
  int* cnt = (int*)take(4ll * g.G * (g.B + 1));
  int* bstart = (int*)take(4ll * (g.B + 2));
  unsigned* ticket = (unsigned*)take(4);
  if (s) *s = CdScratch{ka, kb, status, bounds, fine_bucket, la, lb, cnt, bstart, ticket};
  return off;
}

__device__ __forceinline__ int cd_fine(uint64_t u) {
  return (int)(u >> (64 - CD_FINE_BITS));
}

__device__ __forceinline__ bool cd_less(uint64_t ka, int ia, uint64_t kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// First index i in [0, len) of the sorted run a with a[i] >= x, len when
// none: a 32-ary search by the calling warp, one load a lane a level. Every
// lane returns the answer.
__device__ __forceinline__ long long cd_warp_search(const long long* a, long long len,
                                                    long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = len;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long pos = lo + lane * step;
    bool below = false;
    if (pos < hi) {
      const long long v = a[pos];
      below = v < x;
    }
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // the first c samples
    if (c == 0) {
      hi = lo;
    } else {
      lo = lo + (long long)(c - 1) * step + 1;
      hi = min(lo - 1 + step, hi);
    }
  }
  return lo;
}

__global__ void __launch_bounds__(CD_LANE_T)
cd_count(const long long* __restrict__ fps, int n, int log_b, int L, int* __restrict__ cnt,
         long long* __restrict__ run, int R, CdRuns runs, long long* __restrict__ bounds,
         unsigned short* __restrict__ fine_bucket) {
  __shared__ int hist[(1 << CD_MAX_LOG_B) + 1];
  __shared__ int fine[CD_FINE];  // the samples' counts a fine bin, then its bucket
  __shared__ const long long* rptr[MAX_RUNS];
  __shared__ long long rlen[MAX_RUNS];
  const int B = 1 << log_b, t = threadIdx.x, g = blockIdx.x;
  if (t < runs.n) {
    rptr[t] = runs.ptr[t];
    rlen[t] = runs.len[t];
  }
  for (int b = t; b <= B; b += CD_LANE_T) hist[b] = 0;
  for (int f = t; f < CD_FINE; f += CD_LANE_T) fine[f] = 0;
  __syncthreads();
  // the buckets: fine bins (the key's top CD_FINE_BITS) merged so that each
  // holds about 1/B of CD_SAMPLES evenly spaced lanes' real keys (every
  // block the same; block 0 keeps them for cd_scatter)
#pragma unroll
  for (int k = 0; k < CD_SAMPLES / CD_LANE_T; ++k) {
    const long long lane = (long long)(k * CD_LANE_T + t) * n / CD_SAMPLES;
    const uint64_t u = n ? (uint64_t)fps[lane] ^ RT_SIGN : ~0ull;
    if (u != ~0ull) atomicAdd(&fine[cd_fine(u)], 1);
  }
  __syncthreads();
  {
    constexpr int Q = CD_FINE / CD_LANE_T;  // consecutive fine bins a thread
    int c[Q], sum = 0;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      c[k] = fine[t * Q + k];
      sum += c[k];
    }
    int nr;  // the real samples
    int before = rt_block_exclusive_scan<int, CD_LANE_T>(sum, &nr);
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int bk = nr ? min(B - 1, (int)((long long)before * B / nr)) : 0;
      fine[t * Q + k] = bk;
      if (g == 0) fine_bucket[t * Q + k] = (unsigned short)bk;
      before += c[k];
    }
  }
  __syncthreads();
  const int lo = g * L, hi = min(n, lo + L);
  for (int base = lo; base < hi; base += CD_LANE_T) {
    const int i = base + t;
    const bool active = i < hi;
    const uint64_t u = active ? (uint64_t)fps[i] ^ RT_SIGN : 0;
    const bool sent = active && u == ~0ull;
    if (active && !sent) atomicAdd(&hist[fine[cd_fine(u)]], 1);
    const unsigned ws = __ballot_sync(0xffffffffu, sent);
    if ((t & 31) == 0 && ws) atomicAdd(&hist[B], __popc(ws));
  }
  __syncthreads();
  for (int b = t; b <= B; b += CD_LANE_T) cnt[b * gridDim.x + g] = hist[b];
  for (int p = g * CD_LANE_T + t; p < R; p += gridDim.x * CD_LANE_T) run[p] = RT_ENC_MAX;
  // each run's slice of each bucket: bounds[r][j] = the first index of run
  // r at or above bucket j's first key (that of its first fine bin; none:
  // the run's real length, as for j = B, the first INT64_MAX); a warp a bound
  const int nw = gridDim.x * (CD_LANE_T / 32);
  for (int j = g * (CD_LANE_T / 32) + (t >> 5); j < runs.n * (B + 1); j += nw) {
    const int r = j / (B + 1), bd = j - r * (B + 1);
    int f0 = 0, f1 = bd == B ? CD_FINE : bd ? CD_FINE : 0;  // the first fine bin of bucket bd
    if (bd && bd < B) {
      while (f0 < f1) {
        const int mid = (f0 + f1) >> 1;
        if (fine[mid] < bd) f0 = mid + 1; else f1 = mid;
      }
    }
    const long long x = f1 == CD_FINE ? RT_ENC_MAX
                                      : (long long)(((uint64_t)f1 << (64 - CD_FINE_BITS)) ^ RT_SIGN);
    const long long at = cd_warp_search(rptr[r], rlen[r], x);
    if ((t & 31) == 0) bounds[j] = at;
  }
}

__global__ void __launch_bounds__(CD_LANE_T)
cd_scatter(const long long* __restrict__ fps, int n, int log_b, int L,
           const unsigned short* __restrict__ fine_bucket, const int* __restrict__ cnt,
           int* __restrict__ bstart,
           unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
           uint64_t* __restrict__ ka, int* __restrict__ la, bool* __restrict__ new_out,
           int* __restrict__ order) {
  __shared__ int off[(1 << CD_MAX_LOG_B) + 1], tot_s[(1 << CD_MAX_LOG_B) + 1];
  __shared__ unsigned short fine[CD_FINE];
  const int B = 1 << log_b, nb = B + 1, t = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  for (int f = t; f < CD_FINE; f += CD_LANE_T) fine[f] = fine_bucket[f];
  // this block's offset of every bucket: the lanes of all buckets before
  // it plus those of this bucket in the blocks before this one. A warp
  // takes a bucket at a time, its G (<= 64) counts two a lane.
  const int lane = t & 31;
#pragma unroll 4
  for (int b = t >> 5; b < nb; b += CD_LANE_T / 32) {
    const int c0 = lane < G ? cnt[b * G + lane] : 0;
    const int c1 = lane + 32 < G ? cnt[b * G + lane + 32] : 0;
    int tot = c0 + c1, col = (lane < g ? c0 : 0) + (lane + 32 < g ? c1 : 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
      col += __shfl_xor_sync(0xffffffffu, col, o);
    }
    if (lane == 0) {
      off[b] = col;
      tot_s[b] = tot;
    }
  }
  __syncthreads();
  // the bucket starts: a scan over the buckets, q consecutive a thread
  const int q = (nb + CD_LANE_T - 1) / CD_LANE_T;
  const int b0 = min(nb, t * q), b1 = min(nb, b0 + q);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += tot_s[b];
  int all;
  int before = rt_block_exclusive_scan<int, CD_LANE_T>(mine, &all);
  for (int b = b0; b < b1; ++b) {
    off[b] += before;
    if (g == 0) bstart[b] = before;
    before += tot_s[b];
  }
  if (g == 0) {
    if (t == 0) {
      bstart[nb] = n;
      *ticket = 0u;
    }
    for (int b = t; b < B; b += CD_LANE_T) status[b] = 0ull;
  }
  __syncthreads();
  const int lo = g * L, hi = min(n, lo + L);
  for (int base = lo; base < hi; base += CD_LANE_T) {
    const int i = base + t;
    const bool active = i < hi;
    const uint64_t u = active ? (uint64_t)fps[i] ^ RT_SIGN : 0;
    const bool sent = active && u == ~0ull;
    int n_sent;
    const int r = rt_block_exclusive_scan<int, CD_LANE_T>(sent ? 1 : 0, &n_sent);
    if (sent) {  // the sentinel bucket in lane order: never new
      new_out[i] = false;
      if (order) order[off[B] + r] = i;
    }
    if (active && !sent) {
      const int p = atomicAdd(&off[fine[cd_fine(u)]], 1);
      ka[p] = u;
      la[p] = i;
    }
    __syncthreads();
    if (t == 0) off[B] += n_sent;
    __syncthreads();
  }
}

// Bitonic sort of the first P (a power of two, at most E * CD_T) of the
// pairs held E a thread (element e * CD_T + t), ascending by (key, lane);
// each aligned group of P elements past them is sorted on its own. sk/si:
// E * CD_T entries of shared staging.
template <int E>
__device__ __forceinline__ void cd_bitonic(uint64_t (&k)[E], int (&l)[E], int P, uint64_t* sk,
                                           int* si) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= CD_T) {  // the partner is this thread's element e ^ es
#pragma unroll
        for (int es = 1; es < E; es <<= 1) {  // unrolled: k and l stay in registers
          if (es * CD_T != stride) continue;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int f = e ^ es;
            if (f < e) continue;
            const bool up = ((e * CD_T + t) & size) == 0;
            if (cd_less(k[f], l[f], k[e], l[e]) == up) {
              const uint64_t tk = k[e];
              k[e] = k[f];
              k[f] = tk;
              const int tl = l[e];
              l[e] = l[f];
              l[f] = tl;
            }
          }
        }
      } else if (stride >= 32) {  // another warp's: through shared memory
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sk[e * CD_T + t] = k[e];
          si[e * CD_T + t] = l[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * CD_T + t, j = i ^ stride;
          const uint64_t pk = sk[j];
          const int pl = si[j];
          const bool keep_min = (i < j) == ((i & size) == 0);
          const bool pless = cd_less(pk, pl, k[e], l[e]);
          if (keep_min == pless) {
            k[e] = pk;
            l[e] = pl;
          }
        }
        __syncthreads();
      } else {  // this warp's: shuffles
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * CD_T + t, j = i ^ stride;
          const uint64_t pk = __shfl_xor_sync(0xffffffffu, k[e], stride);
          const int pl = __shfl_xor_sync(0xffffffffu, l[e], stride);
          const bool keep_min = (i < j) == ((i & size) == 0);
          const bool pless = cd_less(pk, pl, k[e], l[e]);
          if (keep_min == pless) {
            k[e] = pk;
            l[e] = pl;
          }
        }
      }
    }
  }
}

// Sort the m <= E * CD_T pairs at (gk, gl) into sk/si (positions past m
// hold the padding pair, which sorts last): a network over the least power
// of two P >= m.
template <int E>
__device__ __forceinline__ void cd_sort_piece(const uint64_t* gk, const int* gl, int m,
                                              uint64_t* sk, int* si) {
  int P = 2;
  while (P < m) P <<= 1;
  uint64_t k[E];
  int l[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * CD_T + threadIdx.x;
    k[e] = i < m ? gk[i] : ~0ull;
    l[e] = i < m ? gl[i] : 0x7fffffff;
  }
  cd_bitonic<E>(k, l, P, sk, si);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sk[e * CD_T + threadIdx.x] = k[e];
    si[e * CD_T + threadIdx.x] = l[e];
  }
  __syncthreads();
}

// Membership in the runs of the keys q[e] (enc) of the positions with
// cand[e] set, every thread of the block calling; [slo[r], shi[r]) is the
// slice of run r that holds every key of the bucket. fresh[e] = cand[e]
// and q[e] is in no run. The runs go in groups: one run whose slice is too
// long for the pool (sampled every step-th entry; a key finishes between
// two samples by at most CD_SCAN independent loads), or the following runs
// whose slices fit the pool together (staged whole in one pass).
__device__ __forceinline__ void cd_probe(const bool (&cand)[CD_E], const long long (&q)[CD_E],
                                         bool (&fresh)[CD_E], int n_runs,
                                         const long long* const* rptr, long long* pool,
                                         const long long* slo, const long long* shi) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < CD_E; ++e) fresh[e] = cand[e];
  for (int r = 0; r < n_runs;) {
    bool any = false;
#pragma unroll
    for (int e = 0; e < CD_E; ++e) any |= fresh[e];
    // every key found: stop (this also orders the last group's pool reads
    // before the pool is restaged)
    const int nf = __syncthreads_count(any);
    if (!nf) break;
    long long step = 1, total = shi[r] - slo[r];
    int r1 = r + 1;
    if (total > CD_POOL) {  // CD_SPK samples a thread with a fresh key, within the pool
      const long long want = min((long long)CD_POOL, max((long long)CD_MIN_SAMPLES,
                                                         (long long)CD_SPK * nf));
      step = (total + want - 1) / want;
    } else {
      while (r1 < n_runs && total + (shi[r1] - slo[r1]) <= CD_POOL) {
        total += shi[r1] - slo[r1];
        ++r1;
      }
    }
    // stage the group: pool entry j is sample j - (entries of the runs
    // before u) of the run u it falls in; every load of a thread is issued
    // before its first store
    int gtot = 0;
    for (int u = r; u < r1; ++u) gtot += (int)((shi[u] - slo[u] + step - 1) / step);
    long long v[CD_POOL / CD_T];
#pragma unroll
    for (int i = 0; i < CD_POOL / CD_T; ++i) {
      int j = i * CD_T + t, u = r;
      if (j < gtot) {
        for (;; ++u) {
          const int ns = (int)((shi[u] - slo[u] + step - 1) / step);
          if (j < ns) break;
          j -= ns;
        }
        v[i] = rptr[u][slo[u] + j * step];
      }
    }
#pragma unroll
    for (int i = 0; i < CD_POOL / CD_T; ++i)
      if (i * CD_T + t < gtot) pool[i * CD_T + t] = v[i];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < CD_E; ++e) {
      int at = 0;
      for (int u = r; u < r1 && fresh[e]; ++u) {
        const long long lo = slo[u], hi = shi[u];
        const int ns = (int)((hi - lo + step - 1) / step);
        const long long* seg = pool + at;
        at += ns;
        int plo = 0, phi = ns;  // the first sample >= q
        while (plo < phi) {
          const int mid = (plo + phi) >> 1;
          if (seg[mid] < q[e]) plo = mid + 1; else phi = mid;
        }
        bool hit = plo < ns && seg[plo] == q[e];
        if (!hit && step > 1 && plo > 0) {  // between samples plo - 1 and plo
          const long long* a = rptr[u];
          long long glo = lo + (long long)(plo - 1) * step + 1;
          long long ghi = min(lo + (long long)plo * step, hi);
          while (ghi - glo > CD_SCAN) {  // keep the lower bound of q in [glo, ghi)
            const long long mid = (glo + ghi) >> 1;
            if (a[mid] < q[e]) glo = mid + 1; else ghi = mid + 1;
          }
#pragma unroll
          for (int i = 0; i < CD_SCAN; ++i) hit |= glo + i < ghi && a[glo + i] == q[e];
        }
        if (hit) fresh[e] = false;
      }
    }
    r = r1;
  }
  __syncthreads();  // the pool serves the next tile
}

__global__ void __launch_bounds__(CD_T)
cd_sort_probe(CdRuns runs, int log_b, const long long* __restrict__ bounds,
              const int* __restrict__ bstart, unsigned* __restrict__ ticket,
              unsigned long long* __restrict__ status, uint64_t* __restrict__ ka,
              int* __restrict__ la, uint64_t* __restrict__ kb, int* __restrict__ lb,
              bool* __restrict__ new_out, int* __restrict__ order, long long* __restrict__ run) {
  __shared__ uint64_t sk[CD_CAP];
  __shared__ int si[CD_CAP];
  __shared__ long long pool[CD_POOL];
  __shared__ long long slo[MAX_RUNS], shi[MAX_RUNS];
  __shared__ const long long* rptr[MAX_RUNS];
  __shared__ unsigned s_b;
  __shared__ int s_excl;
  const int t = threadIdx.x, nb = (1 << log_b) + 1;
  if (t == 0) s_b = atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = (int)s_b;
  if (t < runs.n) {
    rptr[t] = runs.ptr[t];
    slo[t] = bounds[t * nb + b];
    shi[t] = bounds[t * nb + b + 1];
  }
  const int base = bstart[b], m = bstart[b + 1] - base;

  // ---- sort the bucket (its syncs also order the slices' writes) ----
  const uint64_t* K;
  int* I;
  if (m <= CD_CAP) {
    if (m <= CD_T) cd_sort_piece<1>(ka + base, la + base, m, sk, si);
    else if (m <= 2 * CD_T) cd_sort_piece<2>(ka + base, la + base, m, sk, si);
    else if (m <= 4 * CD_T) cd_sort_piece<4>(ka + base, la + base, m, sk, si);
    else cd_sort_piece<CD_E>(ka + base, la + base, m, sk, si);
    K = sk;
    I = si;
  } else {  // pieces of CD_CAP sorted in place, then merged in global scratch
    uint64_t *srck = ka + base, *dstk = kb + base;
    int *srcl = la + base, *dstl = lb + base;
    for (int c0 = 0; c0 < m; c0 += CD_CAP) {
      const int c = min(CD_CAP, m - c0);
      cd_sort_piece<CD_E>(srck + c0, srcl + c0, c, sk, si);
      for (int i = t; i < c; i += CD_T) {
        srck[c0 + i] = sk[i];
        srcl[c0 + i] = si[i];
      }
      __syncthreads();
    }
    for (int w = CD_CAP; w < m; w <<= 1) {
      for (int p = t; p < m; p += CD_T) {
        const int rn = p / w, pos = p - rn * w;
        const int pair0 = (rn & ~1) * w;
        const int other0 = (rn & 1) ? pair0 : pair0 + w;
        const int olen = max(0, min(w, m - other0));
        const uint64_t key = srck[p];
        const int lane = srcl[p];
        int lo = 0, hi = olen;  // pairs of the other run below (key, lane)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cd_less(srck[other0 + mid], srcl[other0 + mid], key, lane)) lo = mid + 1;
          else hi = mid;
        }
        dstk[pair0 + pos + lo] = key;
        dstl[pair0 + pos + lo] = lane;
      }
      __syncthreads();
      uint64_t* tk = srck;
      srck = dstk;
      dstk = tk;
      int* tl = srcl;
      srcl = dstl;
      dstl = tl;
    }
    K = srck;
    I = srcl;
  }

  // ---- first occurrences probe the runs, a tile of CD_CAP positions at a
  // time (one tile unless the bucket is wide), CD_E a thread ----
  int n_new = 0;
  for (int s0 = 0; s0 < m; s0 += CD_CAP) {
    const int end = min(s0 + CD_CAP, m);
    bool cand[CD_E], fresh[CD_E];
    long long q[CD_E];
#pragma unroll
    for (int e = 0; e < CD_E; ++e) {
      const int p = s0 + e * CD_T + t;
      const uint64_t key = p < end ? K[p] : 0;
      cand[e] = p < end && (p == 0 || K[p - 1] != key);
      q[e] = (long long)(key ^ RT_SIGN);
    }
    cd_probe(cand, q, fresh, runs.n, rptr, pool, slo, shi);
    int mine = 0;
#pragma unroll
    for (int e = 0; e < CD_E; ++e) {
      const int p = s0 + e * CD_T + t;
      if (p < end) {
        const int lane = I[p];
        new_out[lane] = fresh[e];
        if (order) order[base + p] = lane;
        if (fresh[e]) I[p] = (int)((unsigned)lane | CD_NEW_BIT);
      }
      mine += fresh[e];
    }
    int tile_new;
    rt_block_exclusive_scan<int, CD_T>(mine, &tile_new);
    n_new += tile_new;
  }

  // ---- the bucket's offset into the run: decoupled look-back ----
  // Warp 0 publishes the bucket's count, then reads the 32 buckets before
  // a window's top at once (lane i bucket top - i; before bucket 0 a prefix
  // of 0): the nearest published prefix ends the walk, else the window's
  // counts are added and the window moves 32 buckets back.
  if (t < 32) {
    int excl = 0;
    if (t == 0) atomicExch(&status[b], (b ? CD_FLAG_AGG : CD_FLAG_PREFIX) | (unsigned)n_new);
    const volatile unsigned long long* st = status;
    for (int top = b - 1; b > 0;) {
      const int j = top - t;
      const unsigned long long s = j >= 0 ? st[j] : CD_FLAG_PREFIX;
      const unsigned long long f = s & ~0xffffffffull;
      const unsigned pre = __ballot_sync(0xffffffffu, f == CD_FLAG_PREFIX);
      const unsigned unready = __ballot_sync(0xffffffffu, f == 0);
      const int last = pre ? __ffs(pre) - 1 : 31;  // the lanes that count: 0..last
      const unsigned need = last == 31 ? 0xffffffffu : (2u << last) - 1u;
      if (unready & need) continue;  // a bucket in the window has not published yet
      int v = t <= last ? (int)(unsigned)s : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      excl += v;
      if (pre) break;
      top -= 32;
    }
    if (t == 0) {
      if (b) atomicExch(&status[b], CD_FLAG_PREFIX | (unsigned)(excl + n_new));
      s_excl = excl;
    }
  }
  __syncthreads();

  // ---- emit the bucket's new keys ----
  int at = s_excl;
  for (int s0 = 0; s0 < m; s0 += CD_T) {
    const int p = s0 + t;
    const bool is_new = p < m && ((unsigned)I[p] & CD_NEW_BIT);
    int tile_new;
    const int r = rt_block_exclusive_scan<int, CD_T>(is_new ? 1 : 0, &tile_new);
    if (is_new) run[at + r] = (long long)(K[p] ^ RT_SIGN);
    at += tile_new;
  }
}

// Scratch the call needs for n lanes, in 8-byte words.
extern "C" int chunk_dedup_scratch(int n) {
  const CdGeom g = cd_geom(n);
  return (int)(cd_scratch_layout(n, g, nullptr, nullptr) / 8);
}

// run_spec: n_runs sorted enc runs (a host array of their n_runs device
// pointers, then their lengths; at most MAX_RUNS, each non-empty); order
// may be null; scratch holds chunk_dedup_scratch(n) words; R >= n.
extern "C" int chunk_dedup(const long long* run_spec, int n_runs, const long long* fps, int n,
                           bool* new_out, long long* run, int R, int* order, long long* scratch,
                           long long scratch_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_runs < 0 || n_runs > MAX_RUNS || n < 0 || R < n) return (int)cudaErrorInvalidValue;
  const CdGeom g = cd_geom(n);
  CdScratch sc;
  if (cd_scratch_layout(n, g, (char*)scratch, &sc) > 8 * scratch_words)
    return (int)cudaErrorInvalidValue;
  if (n == 0 && R == 0) return 0;
  CdRuns runs;
  runs.n = n == 0 ? 0 : n_runs;
  for (int r = 0; r < MAX_RUNS; ++r) {
    runs.ptr[r] = r < n_runs ? (const long long*)run_spec[r] : nullptr;
    runs.len[r] = r < n_runs ? run_spec[n_runs + r] : 0;
  }
  cd_count<<<g.G, CD_LANE_T, 0, s>>>(fps, n, g.log_b, g.L, sc.cnt, run, R, runs, sc.bounds,
                                     sc.fine_bucket);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return (int)e;
  cd_scatter<<<g.G, CD_LANE_T, 0, s>>>(fps, n, g.log_b, g.L, sc.fine_bucket, sc.cnt, sc.bstart,
                                       sc.status, sc.ticket, sc.ka, sc.la, new_out, order);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cd_sort_probe<<<g.B, CD_T, 0, s>>>(runs, g.log_b, sc.bounds, sc.bstart, sc.ticket, sc.status,
                                     sc.ka, sc.la, sc.kb, sc.lb, new_out, order, run);
  return (int)cudaGetLastError();
}

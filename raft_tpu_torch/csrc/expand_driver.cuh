// expand_driver.cuh — the guard-first expand's two kernels, written once
// around a spec family's device code (a Family type: RaftFamily of
// raft_actions.cuh, PullFamily of pull_actions.cuh).
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// each family's actions behind its _expand1), as the sparse branch of
// raft_tpu/checker/device_bfs.py:346-376 calls them, and the enabled/fired
// coverage of device_bfs.py:436-452.
//
//   guard  over the [C, A] grid of (state, candidate) lanes: valid (masked
//          by live = state < n_live), rank and ovf, with no successor row
//          built; plus the chunk scalars (n_gen, terminal, expand_ovf) and,
//          per rank, the enabled (states with a valid lane of that rank)
//          and fired (valid lanes) coverage counts, added into cov[:, 0]
//          and cov[:, 1].
//   apply  over the [VC] worklist of flat candidate ids sel[j] = state * A
//          + candidate: the successor row of each lane into flatc, a zeros
//          row for drop lanes (sel[j] >= C * A).
//
// Design. guard: a block owns whole states (SPB = max(1, 256 / A) of them,
// fewer where shared memory runs short), so the per-state enabled mask and
// the terminal count need no cross-block step; it stages its states' rows,
// the spec and each state's guard scratch (Family::scratch_slots(S) slots
// of Family::BAG_WORDS * M ints: the key-word copies on which a lane that
// puts a chain of messages replays its puts — 2 words for the (hi, lo)
// bags, the most an N-word family takes for its WidePacker bags;
// Family::scratch_slot(cd) is a lane's slot, or -1) in shared memory and
// runs one thread per lane; per-block counts go to
// global memory with one atomic each. apply (apply_body, the pull
// family's; the others take the group apply below): a block owns up to 64
// worklist lanes (fewer where a row is too wide for 64 in shared memory);
// it copies the lanes' source rows into shared memory (coalesced), each
// thread applies its action to its row in place (the actions write only
// the lanes they change), and the block writes the rows out coalesced. A
// per-lane switch on the group; sorting the worklist by group is later
// work. Both size their shared memory from the model (W, S, M), so the
// message slots have no fixed cap: only a row too wide for one state per
// block (guard) or one lane per block (apply) is refused.
//
// A family's source instantiates both with EXPAND_KERNELS(prefix, Family),
// which defines the kernels prefix_guard_kernel and prefix_apply_kernel
// and their C launchers prefix_guard and prefix_apply (the pull family's).
// The others take the group apply below, a tile of threads a worklist lane:
// Raft (both builds), KRaft and KRaftWithReconfig with the same guard
// (EXPAND_KERNELS_GROUP_APPLY), the reconfiguration pair with the group
// guard below too, a tile of threads a state (EXPAND_KERNELS_GROUP).
#pragma once

#include <cooperative_groups.h>

#include "actions_common.cuh"

#define GUARD_STATES_TARGET 256
#define APPLY_LANES 64

// the most dynamic shared memory a block of the current device may opt in to
static int max_smem_optin() {
  int dev = 0, v = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// lets `kernel` take `smem` bytes of dynamic shared memory (once per size)
static cudaError_t opt_in(const void* kernel, size_t smem, size_t* opted_in) {
  if (smem <= *opted_in) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) *opted_in = smem;
  return e;
}

template <class F>
__device__ __forceinline__ void guard_body(const int* __restrict__ states, int C, int n_live,
                                           const int* __restrict__ spec,
                                           const int* __restrict__ cand, int SPB,
                                           bool* __restrict__ valid, int* __restrict__ rank,
                                           bool* __restrict__ ovf,
                                           unsigned long long* __restrict__ scal,
                                           unsigned long long* __restrict__ cov) {
  extern __shared__ int smem[];
  int* sp = smem;
  const int W = spec[F::I_W], A = spec[F::I_A], K = spec[F::I_K];
  const int S = spec[F::I_S], M = spec[F::I_M];
  const int slots = F::scratch_slots(S);
  int* rows = smem + F::SPEC_LEN;                    // SPB x W state rows
  int* bags = rows + SPB * W;  // SPB x slots x BAG_WORDS * M guard scratch
  unsigned* en_mask = (unsigned*)(bags + SPB * slots * F::BAG_WORDS * M);  // SPB rank masks
  int* anyv = (int*)(en_mask + SPB);                 // SPB "has a valid lane"
  int* fired = anyv + SPB;                           // K fired counts
  __shared__ int n_gen, any_ovf;

  const int c0 = blockIdx.x * SPB;
  const int nst = min(SPB, C - c0);
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  for (int t = threadIdx.x; t < nst * W; t += blockDim.x)
    rows[t] = states[(long long)c0 * W + t];
  for (int t = threadIdx.x; t < SPB; t += blockDim.x) {
    en_mask[t] = 0;
    anyv[t] = 0;
  }
  for (int t = threadIdx.x; t < K; t += blockDim.x) fired[t] = 0;
  if (threadIdx.x == 0) {
    n_gen = 0;
    any_ovf = 0;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nst * A; t += blockDim.x) {
    const int c = t / A, a = t - c * A;
    const int* cd = cand + 4 * a;
    const int slot = F::scratch_slot(cd);
    int* bag = slot >= 0 ? bags + (c * slots + slot) * F::BAG_WORDS * M : nullptr;
    const Guard g = F::template action<false>(sp, rows + c * W, nullptr, cd, bag);
    const bool v = g.valid && c0 + c < n_live;
    const long long lane = (long long)(c0 + c) * A + a;
    valid[lane] = v;
    rank[lane] = g.rank;
    ovf[lane] = g.ovf;
    if (v) {
      atomicAdd(&n_gen, 1);
      anyv[c] = 1;
      if (g.ovf) any_ovf = 1;
      if (g.rank >= 0 && g.rank < K) {
        atomicAdd(&fired[g.rank], 1);
        atomicOr(&en_mask[c], 1u << g.rank);
      }
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int en = 0;
    for (int c = 0; c < nst; ++c) en += (en_mask[c] >> k) & 1;
    if (en) atomicAdd(&cov[3 * k + 0], (unsigned long long)en);
    if (fired[k]) atomicAdd(&cov[3 * k + 1], (unsigned long long)fired[k]);
  }
  if (threadIdx.x == 0) {
    int term = 0;
    for (int c = 0; c < nst; ++c) term += (c0 + c < n_live) && !anyv[c];
    if (n_gen) atomicAdd(&scal[0], (unsigned long long)n_gen);
    if (term) atomicAdd(&scal[1], (unsigned long long)term);
    if (any_ovf) atomicOr(&scal[2], 1ull);
  }
}

typedef void (*GuardKernel)(const int*, int, int, const int*, const int*, int, bool*, int*,
                            bool*, unsigned long long*, unsigned long long*);

// states [C, W] int32; valid/ovf [C, A] bool; rank [C, A] int32; scal [3]
// int64 (n_gen, terminal, expand_ovf), zeroed here; cov [K, 3] int64, added
// into. S and M (servers, message slots) size the shared memory. Returns a
// cudaError_t.
template <class F>
static int launch_guard(GuardKernel kernel, size_t* opted_in, const int* states, int C,
                        int n_live, const int* spec, int spec_len, const int* cand, int A, int W,
                        int K, int S, int M, bool* valid, int* rank, bool* ovf, long long* scal,
                        long long* cov, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (spec_len != F::SPEC_LEN || K > RA_MAX_K || A <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scal, 0, 3 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (C <= 0) return 0;
  const size_t scr = (size_t)F::scratch_slots(S) * F::BAG_WORDS * M;
  auto smem_of = [&](int spb) {
    return sizeof(int) * (F::SPEC_LEN + (size_t)spb * (W + scr + 2) + K);
  };
  const size_t limit = (size_t)max_smem_optin();
  int SPB = max(1, GUARD_STATES_TARGET / A);
  while (SPB > 1 && smem_of(SPB) > limit) --SPB;
  const size_t smem = smem_of(SPB);
  e = opt_in((const void*)kernel, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(256, ((SPB * A + 31) / 32) * 32);
  const int blocks = (C + SPB - 1) / SPB;
  kernel<<<blocks, threads, smem, s>>>(states, C, n_live, spec, cand, SPB, valid, rank, ovf,
                                       (unsigned long long*)scal, (unsigned long long*)cov);
  return (int)cudaGetLastError();
}

template <class F>
__device__ __forceinline__ void apply_body(const int* __restrict__ states, int C,
                                           const int* __restrict__ sel, int VC,
                                           const int* __restrict__ spec,
                                           const int* __restrict__ cand,
                                           int* __restrict__ flatc) {
  extern __shared__ int smem[];
  const int LANES = blockDim.x;
  int* sp = smem;
  int* lane_sel = smem + F::SPEC_LEN;  // LANES flat ids (-1 = drop)
  int* rows = lane_sel + LANES;        // LANES x W successor rows
  const int W = spec[F::I_W], A = spec[F::I_A];
  const long long j0 = (long long)blockIdx.x * LANES;
  const int nl = (int)min((long long)LANES, VC - j0);
  const long long n_flat = (long long)C * A;

  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  for (int t = threadIdx.x; t < nl; t += blockDim.x) {
    const int f = sel[j0 + t];
    lane_sel[t] = (f >= 0 && f < n_flat) ? f : -1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nl * W; t += blockDim.x) {
    const int r = t / W, col = t - r * W;
    const int f = lane_sel[r];
    rows[t] = f >= 0 ? states[(long long)(f / A) * W + col] : 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nl; r += blockDim.x) {
    const int f = lane_sel[r];
    if (f >= 0) {
      const int c = f / A, a = f - c * A;
      F::template action<true>(sp, states + (long long)c * W, rows + r * W, cand + 4 * a,
                               nullptr);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nl * W; t += blockDim.x) flatc[j0 * W + t] = rows[t];
}

typedef void (*ApplyKernel)(const int*, int, const int*, int, const int*, const int*, int*);

// states [C, W] int32; sel [VC] int32; flatc [VC, W] int32. Returns a
// cudaError_t.
template <class F>
static int launch_apply(ApplyKernel kernel, size_t* opted_in, const int* states, int C,
                        const int* sel, int VC, const int* spec, int spec_len, const int* cand,
                        int W, int* flatc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (spec_len != F::SPEC_LEN) return (int)cudaErrorInvalidValue;
  if (VC <= 0) return 0;
  auto smem_of = [&](int lanes) {
    return sizeof(int) * (F::SPEC_LEN + (size_t)lanes * (1 + W));
  };
  const size_t limit = (size_t)max_smem_optin();
  int lanes = APPLY_LANES;
  while (lanes > 1 && smem_of(lanes) > limit) lanes /= 2;
  const size_t smem = smem_of(lanes);
  cudaError_t e = opt_in((const void*)kernel, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (VC + lanes - 1) / lanes;
  kernel<<<blocks, lanes, smem, s>>>(states, C, sel, VC, spec, cand, flatc);
  return (int)cudaGetLastError();
}

// ---- the group apply: a tile of threads a worklist lane ----
//
// For every family but the pull family (a Family with apply(g, sp, s, o, cd)
// over actions_common.cuh's group helpers). A block of APPLY_GROUP_THREADS
// threads holds APPLY_GROUP_THREADS / G lanes and stages only the spec
// vector, so the resident warps an SM depend on the registers alone, not
// on W. The group of lane j copies its source row straight into flatc row
// j (16-byte loads and stores where the two rows share their alignment,
// else 4-byte; coalesced either way, no division an element), or zeros
// there for a drop lane, then the action edits the row in place in global
// memory, with the tile's barrier (__syncwarp over its mask) between a
// member's write and another member's read. The tile (G threads a lane)
// and the resident blocks an SM asked of the register allocator are the
// family's (F::APPLY_G, F::APPLY_BLOCKS), chosen on the card from timed
// tables of G 4 to 32 at 2 to 4 blocks (PERF.md's tile tables).

#define APPLY_GROUP_THREADS 256

namespace cg = cooperative_groups;

// a tile of G threads of one warp as actions_common.cuh's group type
template <int G>
struct GrpTile {
  mutable cg::thread_block_tile<G> tile;
  __device__ __forceinline__ int lo() const { return (int)tile.thread_rank(); }
  __device__ __forceinline__ int hi() const { return (int)tile.thread_rank() + 1; }
  __device__ __forceinline__ int size() const { return G; }
  __device__ __forceinline__ int sum(int x) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x += tile.shfl_xor(x, o);
    return x;
  }
  __device__ __forceinline__ bool any(bool b) const { return tile.any(b); }
  __device__ __forceinline__ void sync() const { tile.sync(); }
  __device__ __forceinline__ bool lead() const { return tile.thread_rank() == 0; }
  // the group guard's (actions_common.cuh guard_state): a thread is one
  // member, in slot 0
  static constexpr int NM = 1;
  __device__ __forceinline__ unsigned ballot(unsigned bits) const { return tile.ballot(bits != 0); }
  __device__ __forceinline__ unsigned orr(unsigned x) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x |= tile.shfl_xor(x, o);
    return x;
  }
  __device__ __forceinline__ int own(int u) const { return u == (int)tile.thread_rank() ? 0 : -1; }
  template <int MAXW>
  __device__ __forceinline__ IKey pick_key(const PutReq* rq, int u, int nw) const {
    IKey k;
#pragma unroll
    for (int w = 0; w < MAXW; ++w) k.w[w] = w < nw ? tile.shfl(rq[0].k.w[w], u) : 0;
    return k;
  }
};

// dst[0, W) = src[0, W) (src null: zeros) by member t of G
template <int G>
__device__ __forceinline__ void grp_copy_row(int* __restrict__ dst,
                                             const int* __restrict__ src, int W, int t) {
  const int dmis = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int smis = src ? (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3) : dmis;
  int head = W, body = 0;  // a scalar head, then int4 quads, then a scalar tail
  if (smis == dmis) {
    head = min(W, (4 - dmis) & 3);
    body = (W - head) >> 2;
  }
  for (int i = t; i < head; i += G) dst[i] = src ? src[i] : 0;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4* s4 = src ? reinterpret_cast<const int4*>(src + head) : nullptr;
#pragma unroll 4
  for (int i = t; i < body; i += G) d4[i] = s4 ? s4[i] : make_int4(0, 0, 0, 0);
  for (int i = head + 4 * body + t; i < W; i += G) dst[i] = src ? src[i] : 0;
}

template <class F>
__device__ __forceinline__ void apply_group_body(const int* __restrict__ states, int C,
                                                 const int* __restrict__ sel, int VC,
                                                 const int* __restrict__ spec,
                                                 const int* __restrict__ cand,
                                                 int* __restrict__ flatc) {
  constexpr int G = F::APPLY_G;
  __shared__ int sp[F::SPEC_LEN];
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  __syncthreads();
  const GrpTile<G> g{cg::tiled_partition<G>(cg::this_thread_block())};
  const long long j = (long long)blockIdx.x * (APPLY_GROUP_THREADS / G) + threadIdx.x / G;
  if (j >= VC) return;  // the whole group
  const int W = sp[F::I_W], A = sp[F::I_A];
  const int f = sel[j];
  const bool live = f >= 0 && f < (long long)C * A;
  const int c = live ? f / A : 0, a = live ? f - c * A : 0;
  const int* src = states + (long long)c * W;
  int* o = flatc + j * W;
  grp_copy_row<G>(o, live ? src : nullptr, W, (int)g.tile.thread_rank());
  if (!live) return;
  g.sync();
  F::apply(g, sp, src, o, cand + 4 * a);
}

// states [C, W] int32; sel [VC] int32; flatc [VC, W] int32. Returns a
// cudaError_t.
template <class F>
static int launch_apply_group(ApplyKernel kernel, const int* states, int C, const int* sel,
                              int VC, const int* spec, int spec_len, const int* cand, int W,
                              int* flatc, void* stream) {
  if (spec_len != F::SPEC_LEN) return (int)cudaErrorInvalidValue;
  if (VC <= 0) return 0;
  constexpr int lanes = APPLY_GROUP_THREADS / F::APPLY_G;
  const int blocks = (VC + lanes - 1) / lanes;
  kernel<<<blocks, APPLY_GROUP_THREADS, 0, (cudaStream_t)stream>>>(states, C, sel, VC, spec,
                                                                   cand, flatc);
  return (int)cudaGetLastError();
}

// What the group apply's build reaches: out = {G, threads a block, resident
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), warps an
// SM, registers a thread, local (stack) bytes a thread}. The shared memory
// is the spec vector alone, so the figures hold at every W.
template <class F>
static int apply_group_occupancy(ApplyKernel kernel, int* out) {
  int nb;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, (const void*)kernel,
                                                                APPLY_GROUP_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = F::APPLY_G;
  out[1] = APPLY_GROUP_THREADS;
  out[2] = nb;
  out[3] = nb * APPLY_GROUP_THREADS / 32;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

// the group apply's kernel and its launchers P_apply and P_apply_occupancy
#define EXPAND_APPLY_GROUP(P, F)                                                              \
  __global__ void __launch_bounds__(APPLY_GROUP_THREADS, F::APPLY_BLOCKS)                     \
      P##_apply_kernel(const int* __restrict__ states, int C, const int* __restrict__ sel,    \
                       int VC, const int* __restrict__ spec, const int* __restrict__ cand,    \
                       int* __restrict__ flatc) {                                             \
    apply_group_body<F>(states, C, sel, VC, spec, cand, flatc);                               \
  }                                                                                           \
  extern "C" int P##_apply(const int* states, int C, const int* sel, int VC, const int* spec, \
                           int spec_len, const int* cand, int W, int* flatc, void* stream) {  \
    return launch_apply_group<F>(P##_apply_kernel, states, C, sel, VC, spec, spec_len, cand,  \
                                 W, flatc, stream);                                           \
  }                                                                                           \
  extern "C" int P##_apply_occupancy(int* out) {                                              \
    return apply_group_occupancy<F>(P##_apply_kernel, out);                                   \
  }

// EXPAND_KERNELS with the group apply in place of apply_body (the guard is
// the same)
#define EXPAND_KERNELS_GROUP_APPLY(P, F) \
  EXPAND_GUARD(P, F)                     \
  EXPAND_APPLY_GROUP(P, F)

// ---- the group guard: a tile of threads a state ----
//
// For the reconfiguration pair (a Family with lane(sp, s, cd, rq) and
// chain(g, sp, s, cd, scratch, gd), the spec indices guard_state reads and
// MAX_WORDS). A block of GUARD_GROUP_THREADS threads (fewer where its
// shared memory would overrun the card's) holds a tile of GUARD_GROUP_G
// threads for each of its states, and stages in shared memory the spec
// vector and, a tile, its state's row (copied once, coalesced) and one
// chain scratch (MAX_WORDS * M ints: the launcher's arguments do not carry
// the spec's NW, so a copy of NW * M ints is made in a slot sized for the
// most words). The tile runs actions_common.cuh's guard_state: member t the
// candidate lanes t, t + G, ... (the candidate table holds each action
// group as one run, so a round's members mostly share an arm), each bag
// probe split over the tile (M / G slots a member), RequestVote's chains
// one after another on the tile's copy; the state's valid lanes, enabled
// ranks and terminal flag by ballots and shuffles, one shared atomic a tile
// for each, and the block's sums to cov and scal with one atomic each. A
// warp a state, the row staged and three resident blocks asked of the
// register allocator (80 registers a thread, 24 warps an SM) were the
// fastest on the card of tiles of 8 to 32 threads at 2 to 4 blocks, the row
// staged or read through the cache (PERF.md's tile table).

#define GUARD_GROUP_THREADS 256
#define GUARD_GROUP_G 32
#define GUARD_GROUP_BLOCKS 3

template <class F>
__device__ __forceinline__ void guard_group_body(const int* __restrict__ states, int C,
                                                 int n_live, const int* __restrict__ spec,
                                                 const int* __restrict__ cand,
                                                 bool* __restrict__ valid, int* __restrict__ rank,
                                                 bool* __restrict__ ovf,
                                                 unsigned long long* __restrict__ scal,
                                                 unsigned long long* __restrict__ cov) {
  constexpr int G = GUARD_GROUP_G;
  const int T = blockDim.x / G;
  extern __shared__ int smem[];
  int* sp = smem;
  int* scratch = smem + F::SPEC_LEN;  // T x MAX_WORDS * M chain copies, then T x W rows
  __shared__ int en_n[RA_MAX_K], fired[RA_MAX_K];
  __shared__ int n_gen, term, any_ovf;
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  for (int t = threadIdx.x; t < RA_MAX_K; t += blockDim.x) en_n[t] = fired[t] = 0;
  if (threadIdx.x == 0) n_gen = term = any_ovf = 0;
  __syncthreads();
  const int W = sp[F::I_W], A = sp[F::I_A], M = sp[F::I_M], K = sp[F::I_K];
  const GrpTile<G> g{cg::tiled_partition<G>(cg::this_thread_block())};
  const int tl = threadIdx.x / G;
  const int c = blockIdx.x * T + tl;
  if (c < C) {  // the whole tile
    const long long lane0 = (long long)c * A;
    const bool live = c < n_live;
    int* row = scratch + T * F::MAX_WORDS * M + tl * W;
    grp_copy_row<G>(row, states + (long long)c * W, W, (int)g.tile.thread_rank());
    g.sync();
    const GuardSums r = guard_state<F>(
        g, sp, row, cand, live, scratch + tl * F::MAX_WORDS * M,
        valid + lane0, rank + lane0, ovf + lane0, [&](int k, int n) { atomicAdd(&fired[k], n); });
    if (g.lead()) {
      if (r.n_valid) atomicAdd(&n_gen, r.n_valid);
      if (live && !r.n_valid) atomicAdd(&term, 1);
      if (r.ovf) any_ovf = 1;
      for (unsigned e = r.en; e; e &= e - 1) atomicAdd(&en_n[__ffs(e) - 1], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (en_n[k]) atomicAdd(&cov[3 * k + 0], (unsigned long long)en_n[k]);
    if (fired[k]) atomicAdd(&cov[3 * k + 1], (unsigned long long)fired[k]);
  }
  if (threadIdx.x == 0) {
    if (n_gen) atomicAdd(&scal[0], (unsigned long long)n_gen);
    if (term) atomicAdd(&scal[1], (unsigned long long)term);
    if (any_ovf) atomicOr(&scal[2], 1ull);
  }
}

// the group guard's block at M message slots and W lanes: its threads
// (GUARD_GROUP_THREADS, halved while its dynamic shared memory exceeds the
// card's opt-in limit) and that shared memory
template <class F>
static void guard_group_shape(int M, int W, int* threads, size_t* smem) {
  auto smem_of = [&](int t) {
    return sizeof(int) * (F::SPEC_LEN + (size_t)(t / GUARD_GROUP_G) * (F::MAX_WORDS * M + W));
  };
  const size_t limit = (size_t)max_smem_optin();
  int t = GUARD_GROUP_THREADS;
  while (t > GUARD_GROUP_G && smem_of(t) > limit) t /= 2;
  *threads = t;
  *smem = smem_of(t);
}

// launch_guard's contract (the same arguments; S unused)
template <class F>
static int launch_guard_group(GuardKernel kernel, size_t* opted_in, const int* states, int C,
                              int n_live, const int* spec, int spec_len, const int* cand, int A,
                              int W, int K, int M, bool* valid, int* rank, bool* ovf, long long* scal,
                              long long* cov, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (spec_len != F::SPEC_LEN || K > RA_MAX_K || A <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scal, 0, 3 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (C <= 0) return 0;
  int threads;
  size_t smem;
  guard_group_shape<F>(M, W, &threads, &smem);
  e = opt_in((const void*)kernel, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int T = threads / GUARD_GROUP_G;
  kernel<<<(C + T - 1) / T, threads, smem, s>>>(
      states, C, n_live, spec, cand, T, valid, rank, ovf, (unsigned long long*)scal,
      (unsigned long long*)cov);
  return (int)cudaGetLastError();
}

// What the group guard's build reaches at M message slots and W lanes: out = {G,
// threads a block, resident blocks an SM, warps an SM, registers a thread,
// local (stack) bytes a thread}.
template <class F>
static int guard_group_occupancy(GuardKernel kernel, size_t* opted_in, int M, int W, int* out) {
  int threads;
  size_t smem;
  guard_group_shape<F>(M, W, &threads, &smem);
  cudaError_t e = opt_in((const void*)kernel, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  int nb;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, (const void*)kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = GUARD_GROUP_G;
  out[1] = threads;
  out[2] = nb;
  out[3] = nb * threads / 32;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

// The group guard and the group apply, with the launchers P_guard,
// P_guard_occupancy(M, W, out), P_apply and P_apply_occupancy.
#define EXPAND_KERNELS_GROUP(P, F)                                                            \
  __global__ void __launch_bounds__(GUARD_GROUP_THREADS, GUARD_GROUP_BLOCKS)                  \
      P##_guard_kernel(const int* __restrict__ states, int C, int n_live,                     \
                       const int* __restrict__ spec, const int* __restrict__ cand, int,       \
                       bool* __restrict__ valid, int* __restrict__ rank,                      \
                       bool* __restrict__ ovf, unsigned long long* __restrict__ scal,         \
                       unsigned long long* __restrict__ cov) {                                \
    guard_group_body<F>(states, C, n_live, spec, cand, valid, rank, ovf, scal, cov);          \
  }                                                                                           \
  static size_t P##_guard_opted_in = 48 * 1024; /* dynamic shared memory allowed so far */    \
  extern "C" int P##_guard(const int* states, int C, int n_live, const int* spec,             \
                           int spec_len, const int* cand, int A, int W, int K, int, int M,    \
                           bool* valid, int* rank, bool* ovf, long long* scal, long long* cov, \
                           void* stream) {                                                    \
    return launch_guard_group<F>(P##_guard_kernel, &P##_guard_opted_in, states, C, n_live,    \
                                 spec, spec_len, cand, A, W, K, M, valid, rank, ovf, scal,    \
                                 cov, stream);                                                \
  }                                                                                           \
  extern "C" int P##_guard_occupancy(int M, int W, int* out) {                                \
    return guard_group_occupancy<F>(P##_guard_kernel, &P##_guard_opted_in, M, W, out);       \
  }                                                                                           \
  EXPAND_APPLY_GROUP(P, F)

#define EXPAND_GUARD(P, F)                                                                    \
  __global__ void P##_guard_kernel(const int* __restrict__ states, int C, int n_live,         \
                                   const int* __restrict__ spec,                              \
                                   const int* __restrict__ cand, int SPB,                     \
                                   bool* __restrict__ valid, int* __restrict__ rank,          \
                                   bool* __restrict__ ovf,                                    \
                                   unsigned long long* __restrict__ scal,                     \
                                   unsigned long long* __restrict__ cov) {                    \
    guard_body<F>(states, C, n_live, spec, cand, SPB, valid, rank, ovf, scal, cov);           \
  }                                                                                           \
  extern "C" int P##_guard(const int* states, int C, int n_live, const int* spec,             \
                           int spec_len, const int* cand, int A, int W, int K, int S, int M,  \
                           bool* valid, int* rank, bool* ovf, long long* scal, long long* cov, \
                           void* stream) {                                                    \
    static size_t opted_in = 48 * 1024; /* dynamic shared memory allowed so far */            \
    return launch_guard<F>(P##_guard_kernel, &opted_in, states, C, n_live, spec, spec_len,    \
                           cand, A, W, K, S, M, valid, rank, ovf, scal, cov, stream);         \
  }

#define EXPAND_KERNELS(P, F)                                                                  \
  EXPAND_GUARD(P, F)                                                                          \
  __global__ void P##_apply_kernel(const int* __restrict__ states, int C,                     \
                                   const int* __restrict__ sel, int VC,                       \
                                   const int* __restrict__ spec,                              \
                                   const int* __restrict__ cand, int* __restrict__ flatc) {   \
    apply_body<F>(states, C, sel, VC, spec, cand, flatc);                                     \
  }                                                                                           \
  extern "C" int P##_apply(const int* states, int C, const int* sel, int VC, const int* spec, \
                           int spec_len, const int* cand, int W, int* flatc, void* stream) {  \
    static size_t opted_in = 48 * 1024;                                                       \
    return launch_apply<F>(P##_apply_kernel, &opted_in, states, C, sel, VC, spec, spec_len,   \
                           cand, W, flatc, stream);                                           \
  }

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
// of 2 * M ints: the bag copies on which a lane that puts a chain of
// messages replays its puts; Family::scratch_slot(cd) is a lane's slot, or
// -1) in shared memory and runs one thread per lane; per-block counts go to
// global memory with one atomic each. apply: a block owns up to 64
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
// and their C launchers prefix_guard and prefix_apply.
#pragma once

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
  int* bags = rows + SPB * W;                        // SPB x slots x 2M guard scratch
  unsigned* en_mask = (unsigned*)(bags + SPB * slots * 2 * M);  // SPB enabled-rank masks
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
    int* bag = slot >= 0 ? bags + (c * slots + slot) * 2 * M : nullptr;
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
  const size_t scr = (size_t)F::scratch_slots(S) * 2 * M;
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

#define EXPAND_KERNELS(P, F)                                                                  \
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
  }                                                                                           \
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

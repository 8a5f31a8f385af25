// predicates_driver.cuh — a spec family's state predicates over rows, and
// the simulate step's check and settle, written once around the family's
// predicates (a Family type of a *_actions.cuh).
//
// Replaces the batched predicate calls of raft_tpu/checker/liveness.py:254
// _eval_kernel (and simulate's initial-state check,
// raft_tpu/checker/simulate.py:142) and the invariant check and restart of
// raft_tpu/checker/simulate.py:88-103.
//
//   predicates  out[p, n] = predicate ids[p] holds on row n (an invariant
//               id, or a liveness predicate id of the family).
//   sim_check   per walk w of one simulate step, after the apply wrote the
//               moved walks' successors into nxt: inv_bad[w] = the first of
//               the run's invariants that nxt[w] breaks (-1 if none or if
//               w did not move); then the settle: the walk's journal gets
//               its chosen candidate, its depth advances, done[w] = (!moved
//               || depth >= max_depth) && inv_bad < 0, and a done walk
//               restarts from init_pool[ridx[w]] (journal [ridx], depth 0).
//               nxt becomes the walks' next rows: a walk that did not move
//               keeps its row of states. stats[2] = done walks, stats[3] =
//               the lowest walk with inv_bad >= 0 (0x7F7F7F7F7F7F7F7F when
//               none).
//
// Design: one thread per row (walk) evaluates its predicates on the row in
// device memory (they read a few fields, each once); the spec is staged in
// shared memory. sim_check then copies only the rows that change (walks
// that did not move or that restart), each block over its own walks with
// all its threads, coalesced.
//
// Bound: bytes — the predicates' fields of each row read once, the outputs
// written once; sim_check also writes the restarted and kept rows.
//
// A family's source instantiates it with PREDICATE_KERNELS(prefix,
// Family): the kernels prefix_predicates_kernel and
// prefix_sim_check_kernel and their launchers prefix_predicates and
// prefix_sim_check.
#pragma once

#include "actions_common.cuh"

#define PRED_THREADS 128

template <class F>
__device__ __forceinline__ void predicates_body(const int* __restrict__ rows, long long N,
                                                const int* __restrict__ spec,
                                                const int* __restrict__ ids, int P,
                                                bool* __restrict__ out) {
  __shared__ int sp[F::SPEC_LEN];
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int* row = rows + n * sp[F::I_W];
  for (int p = 0; p < P; ++p) out[p * N + n] = F::predicate(sp, row, ids[p]);
}

typedef void (*PredicatesKernel)(const int*, long long, const int*, const int*, int, bool*);

// rows [N, W] int32; ids [P] int32; out [P, N] bool. Returns a cudaError_t.
template <class F>
static int launch_predicates(PredicatesKernel kernel, const int* rows, long long N,
                             const int* spec, int spec_len, const int* ids, int P, bool* out,
                             void* stream) {
  if (spec_len != F::SPEC_LEN) return (int)cudaErrorInvalidValue;
  if (N <= 0 || P <= 0) return 0;
  const long long blocks = (N + PRED_THREADS - 1) / PRED_THREADS;
  kernel<<<(unsigned)blocks, PRED_THREADS, 0, (cudaStream_t)stream>>>(rows, N, spec, ids, P,
                                                                      out);
  return (int)cudaGetLastError();
}

template <class F>
__device__ __forceinline__ void sim_check_body(
    const int* __restrict__ states, int* __restrict__ nxt, int R, const bool* __restrict__ moved,
    const int* __restrict__ chosen, const int* __restrict__ ridx,
    const int* __restrict__ init_pool, int* __restrict__ depth, int max_depth,
    int* __restrict__ journal, int J, int* __restrict__ jlen, const int* __restrict__ spec,
    const int* __restrict__ inv_ids, int n_inv, int* __restrict__ inv_bad,
    bool* __restrict__ done, unsigned long long* __restrict__ stats) {
  __shared__ int sp[F::SPEC_LEN];
  __shared__ const int* src[PRED_THREADS];  // the row each copied walk takes
  __shared__ int dst[PRED_THREADS];         // its walk
  __shared__ int n_copy, n_done;
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  if (threadIdx.x == 0) n_copy = n_done = 0;
  __syncthreads();
  const int W = sp[F::I_W];
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < R) {
    const bool m = moved[w];
    int bad = -1;
    if (m)
      for (int k = 0; k < n_inv && bad < 0; ++k)
        if (!F::invariant(sp, nxt + (long long)w * W, inv_ids[k])) bad = k;
    inv_bad[w] = bad;
    const int nd = depth[w] + m;
    const bool d = (!m || nd >= max_depth) && bad < 0;
    done[w] = d;
    depth[w] = d ? 0 : nd;
    int jl = jlen[w];
    if (m && jl < J) journal[(long long)w * J + jl++] = chosen[w];
    if (d) {
      journal[(long long)w * J] = ridx[w];
      jl = 1;
    }
    jlen[w] = jl;
    if (bad >= 0) atomicMin(&stats[3], (unsigned long long)w);
    if (d) atomicAdd(&n_done, 1);
    if (d || !m) {
      const int slot = atomicAdd(&n_copy, 1);
      src[slot] = d ? init_pool + (long long)ridx[w] * W : states + (long long)w * W;
      dst[slot] = w;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_copy * W; t += blockDim.x) {
    const int r = t / W, c = t - r * W;
    nxt[(long long)dst[r] * W + c] = src[r][c];
  }
  if (threadIdx.x == 0 && n_done) atomicAdd(&stats[2], (unsigned long long)n_done);
}

typedef void (*SimCheckKernel)(const int*, int*, int, const bool*, const int*, const int*,
                               const int*, int*, int, int*, int, int*, const int*, const int*,
                               int, int*, bool*, unsigned long long*);

// states, nxt [R, W] int32 (nxt updated in place); moved [R] bool; chosen,
// ridx, depth (in place), jlen (in place), inv_bad [R] int32; init_pool
// [n_init, W] int32; journal [R, J] int32 (in place); inv_ids [n_inv]
// int32; done [R] bool; stats [4] int64, of which [2] and [3] are set
// here. Returns a cudaError_t.
template <class F>
static int launch_sim_check(SimCheckKernel kernel, const int* states, int* nxt, int R,
                            const bool* moved, const int* chosen, const int* ridx,
                            const int* init_pool, int* depth, int max_depth, int* journal, int J,
                            int* jlen, const int* spec, int spec_len, const int* inv_ids,
                            int n_inv, int* inv_bad, bool* done, long long* stats,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (spec_len != F::SPEC_LEN || J < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(stats + 2, 0, sizeof(long long), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(stats + 3, 0x7F, sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (R <= 0) return 0;
  kernel<<<(R + PRED_THREADS - 1) / PRED_THREADS, PRED_THREADS, 0, s>>>(
      states, nxt, R, moved, chosen, ridx, init_pool, depth, max_depth, journal, J, jlen, spec,
      inv_ids, n_inv, inv_bad, done, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

#define PREDICATE_KERNELS(P, F)                                                               \
  __global__ void P##_predicates_kernel(const int* __restrict__ rows, long long N,             \
                                        const int* __restrict__ spec,                         \
                                        const int* __restrict__ ids, int n_pred,              \
                                        bool* __restrict__ out) {                             \
    predicates_body<F>(rows, N, spec, ids, n_pred, out);                                      \
  }                                                                                           \
  extern "C" int P##_predicates(const int* rows, long long N, const int* spec, int spec_len,   \
                                const int* ids, int n_pred, bool* out, void* stream) {        \
    return launch_predicates<F>(P##_predicates_kernel, rows, N, spec, spec_len, ids, n_pred,  \
                                out, stream);                                                 \
  }                                                                                           \
  __global__ void P##_sim_check_kernel(                                                       \
      const int* __restrict__ states, int* __restrict__ nxt, int R,                           \
      const bool* __restrict__ moved, const int* __restrict__ chosen,                         \
      const int* __restrict__ ridx, const int* __restrict__ init_pool,                        \
      int* __restrict__ depth, int max_depth, int* __restrict__ journal, int J,               \
      int* __restrict__ jlen, const int* __restrict__ spec, const int* __restrict__ inv_ids,  \
      int n_inv, int* __restrict__ inv_bad, bool* __restrict__ done,                          \
      unsigned long long* __restrict__ stats) {                                               \
    sim_check_body<F>(states, nxt, R, moved, chosen, ridx, init_pool, depth, max_depth,       \
                      journal, J, jlen, spec, inv_ids, n_inv, inv_bad, done, stats);          \
  }                                                                                           \
  extern "C" int P##_sim_check(const int* states, int* nxt, int R, const bool* moved,         \
                               const int* chosen, const int* ridx, const int* init_pool,      \
                               int* depth, int max_depth, int* journal, int J, int* jlen,     \
                               const int* spec, int spec_len, const int* inv_ids, int n_inv,  \
                               int* inv_bad, bool* done, long long* stats, void* stream) {    \
    return launch_sim_check<F>(P##_sim_check_kernel, states, nxt, R, moved, chosen, ridx,     \
                               init_pool, depth, max_depth, journal, J, jlen, spec, spec_len, \
                               inv_ids, n_inv, inv_bad, done, stats, stream);                 \
  }

// fold_driver.cuh — the new-state coverage and the invariant fold of a
// chunk, written once around a spec family's invariants (a Family type of
// a *_actions.cuh).
//
// Replaces the new-distinct coverage of raft_tpu/checker/device_bfs.py:
// 453-460 and the invariant fold of :501-506 (each family's invariants).
// Over the [VC] worklist:
//
//   coverage   for each new lane j whose candidate sel[j] is a valid lane of
//              the [C, A] grid, cov[rank[sel[j]], 2] += 1;
//   invariants for each invariant k of the run, the first new lane whose
//              row of flatc violates it; its journal index jcount + (new
//              lanes before it) is folded into viol[k] with a min. The
//              sentinel is I32_MAX, as in the reference.
//
// Design: pass 1, one thread per lane, evaluates the invariants on new
// lanes only and records the first bad lane of each invariant with
// atomicMin; pass 2, one block, counts the new lanes before each first bad
// lane (a block reduction) and folds the journal index into viol. With
// cov null (the initial-state check) no coverage is counted.
//
// Bound: bytes — the new and sel lanes read, and the rows of the new lanes
// (the only rows the predicates read).
//
// A family's source instantiates it with FOLD_KERNELS(prefix, Family): the
// kernels prefix_fold_lanes and prefix_fold_viol and the launcher
// prefix_fold.
#pragma once

#include "actions_common.cuh"

#define FOLD_THREADS 256

template <class F>
__device__ __forceinline__ void fold_lanes_body(const int* __restrict__ flatc, int VC,
                                                const bool* __restrict__ newm,
                                                const int* __restrict__ sel,
                                                const bool* __restrict__ valid,
                                                const int* __restrict__ rank, long long n_flat,
                                                const int* __restrict__ spec,
                                                const int* __restrict__ inv_ids, int n_inv,
                                                int* __restrict__ first_bad,
                                                unsigned long long* __restrict__ cov) {
  __shared__ int sp[F::SPEC_LEN];
  for (int t = threadIdx.x; t < F::SPEC_LEN; t += blockDim.x) sp[t] = spec[t];
  __syncthreads();
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= VC || !newm[j]) return;
  if (cov) {
    const int f = sel[j];
    if (f >= 0 && f < n_flat && valid[f]) {
      const int k = rank[f];
      if (k >= 0 && k < sp[F::I_K]) atomicAdd(&cov[3 * k + 2], 1ull);
    }
  }
  const int* row = flatc + j * sp[F::I_W];
  for (int k = 0; k < n_inv; ++k)
    if (!F::invariant(sp, row, inv_ids[k])) atomicMin(&first_bad[k], (int)j);
}

__device__ __forceinline__ void fold_viol_body(const bool* __restrict__ newm, int VC,
                                               const int* __restrict__ first_bad, int n_inv,
                                               const long long* __restrict__ jcount,
                                               long long* __restrict__ viol) {
  __shared__ int part[FOLD_THREADS];
  for (int k = 0; k < n_inv; ++k) {
    const int f = first_bad[k];
    if (f >= VC) continue;  // no bad lane (the memset sentinel is larger)
    int c = 0;
    for (int j = threadIdx.x; j < f; j += blockDim.x) c += newm[j];
    part[threadIdx.x] = c;
    __syncthreads();
    for (int w = FOLD_THREADS / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const long long jidx = *jcount + part[0];
      if (jidx < viol[k]) viol[k] = jidx;
    }
    __syncthreads();
  }
}

typedef void (*FoldLanesKernel)(const int*, int, const bool*, const int*, const bool*,
                                const int*, long long, const int*, const int*, int, int*,
                                unsigned long long*);
typedef void (*FoldViolKernel)(const bool*, int, const int*, int, const long long*, long long*);

// flatc [VC, W] int32; newm [VC] bool; sel [VC] int32, valid [n_flat] bool
// and rank [n_flat] int32 (all three null when cov is null); inv_ids
// [n_inv] int32; first_bad [n_inv] int32 scratch; jcount one int64 (the
// journal cursor); viol [n_inv] int64 and cov [K, 3] int64, updated in
// place. Returns a cudaError_t.
template <class F>
static int launch_fold(FoldLanesKernel lanes, FoldViolKernel fold_viol, const int* flatc, int VC,
                       const bool* newm, const int* sel, const bool* valid, const int* rank,
                       long long n_flat, const int* spec, int spec_len, const int* inv_ids,
                       int n_inv, int* first_bad, const long long* jcount, long long* viol,
                       long long* cov, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (spec_len != F::SPEC_LEN) return (int)cudaErrorInvalidValue;
  if (VC <= 0 || (n_inv == 0 && !cov)) return 0;
  if (n_inv) {
    cudaError_t e = cudaMemsetAsync(first_bad, 0x7F, n_inv * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  lanes<<<(VC + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, s>>>(
      flatc, VC, newm, sel, valid, rank, n_flat, spec, inv_ids, n_inv, first_bad,
      (unsigned long long*)cov);
  if (n_inv) fold_viol<<<1, FOLD_THREADS, 0, s>>>(newm, VC, first_bad, n_inv, jcount, viol);
  return (int)cudaGetLastError();
}

#define FOLD_KERNELS(P, F)                                                                    \
  __global__ void P##_fold_lanes(const int* __restrict__ flatc, int VC,                       \
                                 const bool* __restrict__ newm, const int* __restrict__ sel,  \
                                 const bool* __restrict__ valid,                              \
                                 const int* __restrict__ rank, long long n_flat,              \
                                 const int* __restrict__ spec,                                \
                                 const int* __restrict__ inv_ids, int n_inv,                  \
                                 int* __restrict__ first_bad,                                 \
                                 unsigned long long* __restrict__ cov) {                      \
    fold_lanes_body<F>(flatc, VC, newm, sel, valid, rank, n_flat, spec, inv_ids, n_inv,       \
                       first_bad, cov);                                                       \
  }                                                                                           \
  __global__ void P##_fold_viol(const bool* __restrict__ newm, int VC,                        \
                                const int* __restrict__ first_bad, int n_inv,                 \
                                const long long* __restrict__ jcount,                         \
                                long long* __restrict__ viol) {                               \
    fold_viol_body(newm, VC, first_bad, n_inv, jcount, viol);                                 \
  }                                                                                           \
  extern "C" int P##_fold(const int* flatc, int VC, const bool* newm, const int* sel,         \
                          const bool* valid, const int* rank, long long n_flat,               \
                          const int* spec, int spec_len, const int* inv_ids, int n_inv,       \
                          int* first_bad, const long long* jcount, long long* viol,           \
                          long long* cov, void* stream) {                                     \
    return launch_fold<F>(P##_fold_lanes, P##_fold_viol, flatc, VC, newm, sel, valid, rank,   \
                          n_flat, spec, spec_len, inv_ids, n_inv, first_bad, jcount, viol,    \
                          cov, stream);                                                       \
  }

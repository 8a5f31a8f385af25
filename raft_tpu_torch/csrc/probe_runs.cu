// probe_runs — dedup probe of the chunk's fingerprints against sorted runs.
//
// Replaces raft_tpu/checker/util.py:21 probe_sorted as used by
// raft_tpu/checker/device_bfs.py:401 _st_dedup: membership of every
// fingerprint in the sorted seen run and in every occupied ladder run,
// folded with "fresh" (the lane holds a real fingerprint).
//
// Design: one thread per query runs a lower-bound binary search in each
// run (at most MAX_RUNS, passed by value as kernel parameters) and stops
// at the first hit. Runs are sorted enc int64 values (u64 ^ 2^63), so a
// signed compare orders them as the u64 values; the INT64_MAX padding of
// a level never matches a real fingerprint, and the host passes only
// occupied runs (an empty level answers "absent").
//
// Bound: bytes — each query read once and one bool written; the runs are
// touched at log2(len) probes per query, far below reading them whole.
// The searches are latency bound (dependent loads); L2 (50 MB) holds the
// top levels of every search tree.
#include "common.cuh"

#define MAX_RUNS 32
#define PROBE_THREADS 256

struct Runs {
  const long long* ptr[MAX_RUNS];
  long long len[MAX_RUNS];
  int n;
};

__global__ void probe_runs_kernel(Runs runs, const long long* __restrict__ fps,
                                  bool* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = fps[i];
  bool fresh = v != RT_ENC_MAX;
  for (int r = 0; r < runs.n && fresh; ++r) {
    const long long* a = runs.ptr[r];
    long long lo = 0, hi = runs.len[r];
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (a[mid] < v) lo = mid + 1; else hi = mid;
    }
    if (lo < runs.len[r] && a[lo] == v) fresh = false;
  }
  out[i] = fresh;
}

extern "C" int probe_runs(const long long* run_ptrs, int n_runs,
                          const long long* run_lens, const long long* fps,
                          bool* out, int n, void* stream) {
  if (n_runs < 0 || n_runs > MAX_RUNS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Runs runs;
  runs.n = n_runs;
  for (int r = 0; r < MAX_RUNS; ++r) {
    runs.ptr[r] = r < n_runs ? (const long long*)run_ptrs[r] : nullptr;
    runs.len[r] = r < n_runs ? run_lens[r] : 0;
  }
  int grid = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  probe_runs_kernel<<<grid, PROBE_THREADS, 0, (cudaStream_t)stream>>>(runs, fps, out, n);
  return (int)cudaGetLastError();
}

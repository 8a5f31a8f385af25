// merge_runs — merge of two sorted fingerprint runs, truncated or padded.
//
// Replaces the sort-concat merges of raft_tpu/checker/device_bfs.py:598-630
// (the wave's binary-counter ladder cascade), :285 _seen_merge_spec (the
// once-per-wave seen merge) and raft_tpu/checker/lsm.py:159 RunLSM._merge:
// out = sort(concat(a, b))[:target], padded with the U64_MAX sentinel
// (INT64_MAX in the enc encoding) when a and b hold fewer than target.
// A cascade of several runs is a chain of these pairwise merges.
//
// Design: merge path. Each thread owns ITEMS consecutive outputs, finds
// where its first output's diagonal crosses the two runs with one binary
// search (ties take a first; the output holds values only, so any tie
// order gives the same lanes), then merges ITEMS elements sequentially.
// Outputs past len(a) + len(b) are INT64_MAX; outputs past target are not
// produced.
//
// Bound: bytes — read a and b once, write target lanes (8 bytes each).
#include "common.cuh"

#define MERGE_THREADS 256
#define MERGE_ITEMS 8

__device__ __forceinline__ long long merge_path(const long long* __restrict__ a, long long na,
                                                const long long* __restrict__ b, long long nb,
                                                long long diag) {
  long long lo = diag > nb ? diag - nb : 0;
  long long hi = diag < na ? diag : na;
  while (lo < hi) {  // number of a-elements among the first diag outputs
    long long i = (lo + hi) >> 1;
    if (a[i] <= b[diag - i - 1]) lo = i + 1; else hi = i;
  }
  return lo;
}

__global__ void merge_runs_kernel(const long long* __restrict__ a, long long na,
                                  const long long* __restrict__ b, long long nb,
                                  long long* __restrict__ out, long long target) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = t * MERGE_ITEMS;
  if (start >= target) return;
  long long end = start + MERGE_ITEMS < target ? start + MERGE_ITEMS : target;
  long long total = na + nb;
  long long k = start;
  if (start < total) {
    long long i = merge_path(a, na, b, nb, start);
    long long j = start - i;
    long long real_end = end < total ? end : total;
    for (; k < real_end; ++k) {
      bool take_a = i < na && (j >= nb || a[i] <= b[j]);
      out[k] = take_a ? a[i++] : b[j++];
    }
  }
  for (; k < end; ++k) out[k] = RT_ENC_MAX;
}

extern "C" int merge_runs(const long long* a, long long na, const long long* b,
                          long long nb, long long* out, long long target,
                          void* stream) {
  if (target <= 0) return 0;
  long long threads = (target + MERGE_ITEMS - 1) / MERGE_ITEMS;
  long long grid = (threads + MERGE_THREADS - 1) / MERGE_THREADS;
  merge_runs_kernel<<<(unsigned)grid, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      a, na, b, nb, out, target);
  return (int)cudaGetLastError();
}

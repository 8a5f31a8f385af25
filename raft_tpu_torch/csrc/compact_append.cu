// compact_append — stream compaction and the cursor-append emit.
//
// Replaces raft_tpu/checker/device_bfs.py:358-372 (valid-lane compaction of
// the [chunk, A] candidate grid into the [VC] worklist),
// raft_tpu/checker/util.py:30 dense_prefix_sel and :48 emit_append, as used
// by the emit of device_bfs.py:462-485. Two entry points:
//
//   compact_indices  mask [n] -> sel [n_out]: sel[j] = index of the j-th
//                    set lane for j < min(count, n_out), `fill` past that
//                    (set lanes beyond n_out are dropped), and count.
//                    Lane order is preserved: gid numbering depends on it.
//   append_rows      buf[min(*count, cap) + j] = src[esel[j]] for every
//                    j < len(esel), a zero row where esel[j] >= n_src. The
//                    cursor *count is read on the device; rows past cap are
//                    the buffer's drop region, so the result is bit-identical
//                    to emit_append at every cursor (exactly full and one
//                    past full included). Source rows lie src_stride words
//                    apart: W for a contiguous source, more for a column
//                    range of wider rows (the sharded engine's received
//                    payload, raft_tpu/parallel/sharded.py:_cs_post
//                    :661-684).
//
// Design of compact_indices: a two-pass block scan. Pass 1 counts the set
// lanes of each TILE; pass 2 (one block) scans the tile counts and stores
// the total; pass 3 rescans each tile locally and writes its set lanes at
// tile offset + local rank; pass 4 writes `fill` past the count.
//
// Bound: bytes — compact_indices reads the mask once and writes n_out
// int32; append_rows reads len(esel) int32 and the selected rows and writes
// len(esel) rows.
#include "common.cuh"

#define CT_THREADS 256
#define CT_ITEMS 8
#define CT_TILE (CT_THREADS * CT_ITEMS)  // 2048 lanes per block

__global__ void ct_count(const bool* __restrict__ mask, int n, long long* __restrict__ tile_count) {
  long long base = (long long)blockIdx.x * CT_TILE + (long long)threadIdx.x * CT_ITEMS;
  int c = 0;
#pragma unroll
  for (int r = 0; r < CT_ITEMS; ++r) {
    long long i = base + r;
    c += (i < n && mask[i]) ? 1 : 0;
  }
  int total;
  rt_block_exclusive_scan<int, CT_THREADS>(c, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

__global__ void ct_scan(long long* __restrict__ tile_count, int ntiles, long long* __restrict__ count) {
  long long carry = 0;
  for (int off = 0; off < ntiles; off += CT_THREADS) {
    int i = off + threadIdx.x;
    long long v = i < ntiles ? tile_count[i] : 0;
    long long total;
    long long e = rt_block_exclusive_scan<long long, CT_THREADS>(v, &total);
    if (i < ntiles) tile_count[i] = carry + e;  // now the tile's offset
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void ct_scatter(const bool* __restrict__ mask, int n,
                           const long long* __restrict__ tile_offset,
                           int* __restrict__ sel, int n_out) {
  long long base = (long long)blockIdx.x * CT_TILE + (long long)threadIdx.x * CT_ITEMS;
  bool m[CT_ITEMS];
  int c = 0;
#pragma unroll
  for (int r = 0; r < CT_ITEMS; ++r) {
    long long i = base + r;
    m[r] = i < n && mask[i];
    c += m[r] ? 1 : 0;
  }
  int total;
  int excl = rt_block_exclusive_scan<int, CT_THREADS>(c, &total);
  long long pos = tile_offset[blockIdx.x] + excl;
#pragma unroll
  for (int r = 0; r < CT_ITEMS; ++r) {
    if (m[r]) {
      if (pos < n_out) sel[pos] = (int)(base + r);
      ++pos;
    }
  }
}

__global__ void ct_fill(int* __restrict__ sel, int n_out, const long long* __restrict__ count, int fill) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n_out && j >= *count) sel[j] = fill;
}

extern "C" int compact_indices(const bool* mask, int n, int* sel, int n_out, int fill,
                               long long* tile_count, long long* count, int ntiles,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ntiles != (n + CT_TILE - 1) / CT_TILE) return (int)cudaErrorInvalidValue;
  if (ntiles == 0) {
    cudaError_t e = cudaMemsetAsync(count, 0, sizeof(long long), s);
    if (e != cudaSuccess) return (int)e;
  } else {
    ct_count<<<ntiles, CT_THREADS, 0, s>>>(mask, n, tile_count);
    ct_scan<<<1, CT_THREADS, 0, s>>>(tile_count, ntiles, count);
    ct_scatter<<<ntiles, CT_THREADS, 0, s>>>(mask, n, tile_count, sel, n_out);
  }
  if (n_out > 0) {
    ct_fill<<<(n_out + 255) / 256, 256, 0, s>>>(sel, n_out, count, fill);
  }
  return (int)cudaGetLastError();
}

__global__ void append_rows_kernel(int* __restrict__ buf, const int* __restrict__ src, int n_src,
                                   int src_stride, const int* __restrict__ esel, int B, int W,
                                   const long long* __restrict__ count, long long cap) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * W) return;
  long long j = e / W, c = e - j * W;
  long long cur = *count;
  long long start = cur < cap ? cur : cap;
  int s = esel[j];
  int v = (s >= 0 && s < n_src) ? src[(long long)s * src_stride + c] : 0;
  buf[(start + j) * W + c] = v;
}

extern "C" int append_rows(int* buf, const int* src, int n_src, int src_stride, const int* esel,
                           int B, int W, const long long* count, long long cap, void* stream) {
  long long n = (long long)B * W;
  if (n == 0) return 0;
  if (src_stride < W) return (int)cudaErrorInvalidValue;
  long long grid = (n + 255) / 256;
  append_rows_kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
      buf, src, n_src, src_stride, esel, B, W, count, cap);
  return (int)cudaGetLastError();
}

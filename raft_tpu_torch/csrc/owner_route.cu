// owner_route — route a chunk's compacted successor lanes to their owner shards.
//
// Replaces the owner routing of raft_tpu/parallel/sharded.py:_cs_pre
// (:576-606, with the route-overflow bit and the routed-lane count of
// pre_stats, :608-615). For each of the VC compacted lanes j:
//
//   owner[j]  = fp[j] mod D on the u64 fingerprint (the enc int64 with its
//               sign bit flipped back); an invalid lane (fp = U64_MAX, enc
//               INT64_MAX) gets owner D and is dropped. The reference's u32
//               pieces ((hi % D) * (2^32 % D) + lo % D) % D equal the u64
//               modulus for every D <= 2^16.
//   position  = the number of lanes before j with the same owner: a STABLE
//               partition, so lanes of one owner keep lane order (the
//               reference's stable argsort by owner).
//   slot      = owner * RC + position, when position < RC; a lane past RC
//               is dropped and raises the route-overflow bit (4).
//   payload   send_pay[slot] = [flatc[j] (W words), base_lgid + cursor +
//               sel[j] / A, sel[j] % A, rank[sel[j]]] (int32, W + 3 words),
//               zeros in unfilled slots; send_fps[slot] = fp[j], U64_MAX
//               (enc INT64_MAX) in unfilled slots. This fuses the
//               reference's concatenate of the payload columns and its
//               scatter into the send blocks.
//   stats     route_stats[0] |= 4 on overflow; route_stats[1] = the routed
//               lanes, sum over owners of min(count, RC).
//
// Design, five launches: or_hist counts each block's lanes per owner in
// shared memory (owner-major [D + 1, nblk] counts); or_scan, one thread per
// owner, turns them into exclusive offsets over the blocks and folds the
// owner's routed count and overflow into route_stats; a memset clears the
// slot -> lane map; or_rank ranks each lane among its block's lanes of the
// same owner in lane order (warps in turn: __match_any_sync groups a warp's
// lanes by owner, a shared running count per owner carries across warps)
// and writes the slot -> lane map; or_fill writes the D * RC * (W + 3)
// payload words and D * RC fingerprints slot-major, each from its lane's
// row or zero. D is bounded by OR_MAX_OWNERS (the shared count arrays).
//
// Bound: bytes — the VC fingerprints (8 B) and sel lanes (4 B) and the
// routed lanes' W row words read once, the D * RC * (W + 3) payload words
// and D * RC fingerprints written once.
#include "common.cuh"

#define OR_THREADS 256
#define OR_MAX_OWNERS 1024

__device__ __forceinline__ int or_owner(long long fp, int D) {
  if (fp == RT_ENC_MAX) return D;
  const uint64_t u = (uint64_t)fp ^ RT_SIGN;
  return (int)(u % (uint64_t)D);
}

__global__ void __launch_bounds__(OR_THREADS)
or_hist(const long long* __restrict__ fps, int VC, int D, int* __restrict__ hist, int nblk) {
  __shared__ int cnt[OR_MAX_OWNERS + 1];
  for (int o = threadIdx.x; o <= D; o += blockDim.x) cnt[o] = 0;
  __syncthreads();
  const int j = blockIdx.x * OR_THREADS + threadIdx.x;
  if (j < VC) atomicAdd(&cnt[or_owner(fps[j], D)], 1);
  __syncthreads();
  for (int o = threadIdx.x; o <= D; o += blockDim.x) hist[o * nblk + blockIdx.x] = cnt[o];
}

__global__ void or_scan(int* __restrict__ hist, int nblk, int D, int RC,
                        unsigned long long* __restrict__ route_stats) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o > D) return;
  int run = 0;
  int* h = hist + (long long)o * nblk;
  for (int b = 0; b < nblk; ++b) {
    const int v = h[b];
    h[b] = run;
    run += v;
  }
  if (o < D) {
    if (run > RC) atomicOr(&route_stats[0], 4ull);
    atomicAdd(&route_stats[1], (unsigned long long)(run < RC ? run : RC));
  }
}

__global__ void __launch_bounds__(OR_THREADS)
or_rank(const long long* __restrict__ fps, int VC, int D, int RC,
        const int* __restrict__ hist, int nblk, int* __restrict__ lane_of_slot) {
  __shared__ int cnt[OR_MAX_OWNERS + 1];
  for (int o = threadIdx.x; o <= D; o += blockDim.x) cnt[o] = 0;
  __syncthreads();
  const int j = blockIdx.x * OR_THREADS + threadIdx.x;
  // lanes past VC take a key of their own, so they match no real lane
  const int o = j < VC ? or_owner(fps[j], D) : D + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int r = 0;
  for (int w = 0; w < OR_THREADS / 32; ++w) {
    if (warp == w) {
      const unsigned m = __match_any_sync(0xffffffffu, o);
      const int before = o <= D ? cnt[o] : 0;
      __syncwarp();  // every lane has read its owner's count before a leader adds to it
      if (o <= D) {
        r = before + __popc(m & ((1u << lane) - 1u));
        if (lane == __ffs(m) - 1) cnt[o] += __popc(m);
      }
    }
    __syncthreads();
  }
  if (o < D) {
    const int pos = hist[o * nblk + blockIdx.x] + r;
    if (pos < RC) lane_of_slot[(long long)o * RC + pos] = j;
  }
}

__global__ void or_fill(const long long* __restrict__ fps, const int* __restrict__ flatc, int W,
                        const int* __restrict__ sel, const int* __restrict__ rank, int n_flat,
                        int A, long long lgid0, const int* __restrict__ lane_of_slot,
                        long long n_slots, int* __restrict__ send_pay,
                        long long* __restrict__ send_fps) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int WP = W + 3;
  if (e >= n_slots * WP) return;
  const long long slot = e / WP;
  const int c = (int)(e - slot * WP);
  const int j = lane_of_slot[slot];
  int v = 0;
  if (j >= 0) {
    if (c < W) {
      v = flatc[(long long)j * W + c];
    } else {
      const int s = sel[j];
      if (c == W) v = (int)(lgid0 + s / A);
      else if (c == W + 1) v = s % A;
      else v = (s >= 0 && s < n_flat) ? rank[s] : -1;
    }
  }
  send_pay[e] = v;
  if (c == 0) send_fps[slot] = j >= 0 ? fps[j] : RT_ENC_MAX;
}

// fps [VC] enc int64; flatc [VC, W] int32; sel [VC] int32 (flat lanes of the
// [C, A] grid, n_flat = C * A past the compacted prefix); rank [n_flat]
// int32; hist [(D + 1) * nblk] int32 and lane_of_slot [D * RC] int32
// scratch, nblk = ceil(VC / OR_THREADS); send_pay [D * RC, W + 3] int32,
// send_fps [D * RC] int64 and route_stats [2] int64 written.
extern "C" int owner_route(const long long* fps, int VC, const int* flatc, int W, const int* sel,
                           const int* rank, int n_flat, int A, long long lgid0, int D, int RC,
                           int* hist, int nblk, int* lane_of_slot, int* send_pay,
                           long long* send_fps, long long* route_stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > OR_MAX_OWNERS || RC < 1 || A < 1 || nblk != (VC + OR_THREADS - 1) / OR_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_slots = (long long)D * RC;
  cudaError_t e = cudaMemsetAsync(route_stats, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(lane_of_slot, 0xFF, n_slots * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (nblk > 0) {
    or_hist<<<nblk, OR_THREADS, 0, s>>>(fps, VC, D, hist, nblk);
    or_scan<<<(D + 1 + 127) / 128, 128, 0, s>>>(hist, nblk, D, RC,
                                                 (unsigned long long*)route_stats);
    or_rank<<<nblk, OR_THREADS, 0, s>>>(fps, VC, D, RC, hist, nblk, lane_of_slot);
  }
  const long long n = n_slots * (W + 3);
  or_fill<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(fps, flatc, W, sel, rank, n_flat, A,
                                                      lgid0, lane_of_slot, n_slots, send_pay,
                                                      send_fps);
  return (int)cudaGetLastError();
}

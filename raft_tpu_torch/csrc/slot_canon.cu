// slot_canon — KRaftWithReconfig's canonical fingerprints: slot_canon.
//
// Replaces raft_tpu/models/kraft_reconfig.py:2059-2147 SlotCanonicalizer
// (_fp1 over _canon_hash, with ops/bag.py:27 wide_bag_sort and
// ops/hashing.py:135 hash_lanes); the plain version is
// raft_tpu_torch/ops/slot_canon.py, whose docstring lists the steps, and
// the device code is slot_canon.cuh. For each row n: for every (sigma, tau)
// pair of host and value permutations, the canonical view's hash (formula
// v4 with the seed's salts); out[n] = the minimum over the pairs as u64, as
// enc (u64 ^ 2^63); INT64_MAX where valid[n] is false.
//
// Design. A row is canonicalized by a tile of SC_G threads, SC_BLOCK / SC_G
// rows a block:
//   1. only valid rows work: an invalid row's tile writes RT_ENC_MAX and
//      reads nothing of its row; a block with no valid row (past the BFS
//      worklist's valid prefix) returns before it stages anything;
//   2. the block stages the spec vector, the sigmas and taus packed one a
//      register, and the lane table (slot_canon.cuh) once; the tile stages
//      its row's VL view lanes once, coalesced, at an odd stride;
//   3. the tile ranks the row's occupied message slots and hashes the unused
//      ones at their positions, once a row;
//   4. the tile splits into SC_G / SC_GS sub-tiles of SC_GS threads, sub-tile
//      q taking sigmas q, q + SC_G / SC_GS, ...; for each it ranks the slot
//      order across S threads, hashes the 280 lanes that tau leaves alone,
//      then for each tau the log values, acked and the occupied keys
//      (remapped, ranked among each other in shared memory), each pair's
//      hash combined by __shfl_xor_sync butterflies;
//   5. a min across the tile by shuffles.
// Nothing of the view is materialized: each element is hashed at the
// position the pair moves it to. Tiles of 16 in sub-tiles of 8 (two rows a
// warp, 3 of the 6 sigmas a sub-tile at the full cfg), 64 registers for 4
// blocks an SM (52 KB of shared memory a block at the full cfg, 32 warps):
// the fastest of the tiles timed by scripts/canon_groups.py --slot (the
// table in PERF.md). The register cap spills 16 bytes to the stack; no array
// is indexed at run time (at 80 registers, uncapped, the stack is empty).
//
// Bound: bytes (each valid row's view lanes and the mask read once, 8 bytes
// written a row) against the INT32 operations of P hashes of VL lanes a row
// and a bag sort a pair (chip_smoke.py counts them); PERF.md says which is
// larger.
#include "canon_tile.cuh"
#include "slot_canon.cuh"

#ifndef SC_G
#define SC_G 16
#endif
#ifndef SC_GS
#define SC_GS 8
#endif
#ifndef SC_MINB
#define SC_MINB 4  // resident blocks an SM asked of ptxas (__launch_bounds__)
#endif
#define SC_BLOCK 256
static_assert(SC_G <= 32 && SC_GS <= SC_G && SC_G % SC_GS == 0, "tiles of a warp at most");

// Shared-memory layout (ints): the spec, the packed sigmas and taus, the
// lane table's two columns, then a stride of `tile` a tile: the row's VL
// lanes, the ranked slots' list [M], and each sub-tile's scratch (the order
// keys [KC_MAX_S], the ranked keys [NW * M])
struct ScLayout {
  int sig, tau, taba, tabb, fixed, list, sub, tile;
};
__host__ __device__ __forceinline__ ScLayout sc_layout(const int* sp, int nsig, int ntau) {
  ScLayout l;
  l.sig = KC_LEN;
  l.tau = l.sig + nsig;
  l.taba = l.tau + ntau;
  l.tabb = l.taba + sc_n_lanes(sp);
  l.fixed = l.tabb + sc_n_lanes(sp);
  l.list = sp[KC_VL];
  l.sub = KC_MAX_S + sp[KC_NW] * sp[KC_M];
  l.tile = (l.list + sp[KC_M] + (SC_G / SC_GS) * l.sub) | 1;
  return l;
}

__global__ void __launch_bounds__(SC_BLOCK, SC_MINB)
slot_canon_kernel(const int* __restrict__ gspec, const int* __restrict__ states, long long N,
                  int W, const bool* __restrict__ valid, const int* __restrict__ sig, int nsig,
                  const int* __restrict__ tau, int ntau, uint32_t sa, uint32_t sb, int seeded,
                  long long* __restrict__ out) {
  extern __shared__ int smem[];
  cg::thread_block_tile<SC_G> tile = cg::tiled_partition<SC_G>(cg::this_thread_block());
  const int t = (int)tile.thread_rank();
  const long long n = (long long)blockIdx.x * (blockDim.x / SC_G) + threadIdx.x / SC_G;
  const bool ok = n < N && (!valid || valid[n]);
  if (n < N && !ok && t == 0) out[n] = RT_ENC_MAX;
  if (!__syncthreads_or(ok)) return;  // no valid row in the block
  for (int e = threadIdx.x; e < KC_LEN; e += blockDim.x) smem[e] = gspec[e];
  __syncthreads();
  const int* sp = smem;
  const ScLayout l = sc_layout(sp, nsig, ntau);
  sc_tables(sp, sig, nsig, tau, ntau, smem + l.sig, smem + l.tau, smem + l.taba, smem + l.tabb,
            threadIdx.x, blockDim.x);
  __syncthreads();
  if (!ok) return;
  int* v = smem + l.fixed + (int)(threadIdx.x / SC_G) * l.tile;
  const int* src = states + n * W;
  for (int c = t; c < sp[KC_VL]; c += SC_G) v[c] = src[c];
  tile.sync();
  CtTile<SC_G> gt{tile};
  int* list = v + l.list;
  const ScRow row = sc_row(sp, v, list, sa, sb, seeded, gt);
  const int q = t / SC_GS;
  int* okeys = list + sp[KC_M] + q * l.sub;
  CtTile<SC_GS> gs{cg::tiled_partition<SC_GS>(cg::this_thread_block())};  // within the tile
  const uint64_t best =
      gt.min64(sc_sigmas(sp, v, smem + l.taba, smem + l.tabb, smem + l.sig, nsig, smem + l.tau,
                         ntau, row, list, okeys, okeys + KC_MAX_S, q, SC_G / SC_GS, sa, sb,
                         seeded, gs));
  if (t == 0) out[n] = rt_enc(best);
}

// the spec vector (in host memory) checked against the kernel's limits
static bool sc_spec_ok(const int* hspec, int spec_len, int nsig, int ntau) {
  return spec_len == KC_LEN && hspec[KC_S] >= 1 && hspec[KC_S] <= KC_MAX_S &&
         hspec[KC_L] >= 1 && hspec[KC_L] <= KC_MAX_L && hspec[KC_NW] >= 1 &&
         hspec[KC_NW] <= KC_MAX_WORDS && hspec[KC_N_HOSTS] >= 1 &&
         hspec[KC_N_HOSTS] <= SC_MAX_PERM && hspec[KC_V] >= 1 && hspec[KC_V] <= SC_MAX_PERM &&
         hspec[KC_VL] < (1 << 16) && nsig >= 1 && ntau >= 1;
}

// Threads a block: SC_BLOCK, halved (down to one tile) until the tables and
// a tile's stride each fit the device's opt-in shared memory. Sets the
// kernel's dynamic shared-memory limit to *smem.
static cudaError_t sc_block(const int* hspec, int nsig, int ntau, int* threads, size_t* smem) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const ScLayout l = sc_layout(hspec, nsig, ntau);
  int nt = SC_BLOCK;
  while (nt > SC_G && sizeof(int) * (size_t)(l.fixed + nt / SC_G * l.tile) > (size_t)optin)
    nt >>= 1;
  *threads = nt;
  *smem = sizeof(int) * (size_t)(l.fixed + nt / SC_G * l.tile);
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(slot_canon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// hspec: the model's spec vector in host memory, spec: the same on the
// device; states [N, W] int32; valid [N] bool or null; sig [nsig, H] and
// tau [ntau, V] int32 the host and value permutations (the pairs are their
// product); (sa, sb, seeded) the fingerprint seed's salts (ops/hashing.py
// seed_salts); out [N] int64. Returns a cudaError_t.
extern "C" int slot_canon(const int* hspec, const int* spec, int spec_len, const int* states,
                          long long N, int W, const bool* valid, const int* sig, int nsig,
                          const int* tau, int ntau, unsigned sa, unsigned sb, int seeded,
                          long long* out, void* stream) {
  if (!sc_spec_ok(hspec, spec_len, nsig, ntau) || W < hspec[KC_VL])
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  int nt;
  size_t smem;
  cudaError_t e = sc_block(hspec, nsig, ntau, &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  const long long per = nt / SC_G, blocks = (N + per - 1) / per;
  slot_canon_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      spec, states, N, W, valid, sig, nsig, tau, ntau, sa, sb, seeded, out);
  return (int)cudaGetLastError();
}

// The launch shape slot_canon takes for this spec and what it reaches:
// out = {threads a tile, threads a block, dynamic shared bytes a block,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// warps an SM, threads a sub-tile}
extern "C" int slot_canon_occupancy(const int* hspec, int spec_len, int nsig, int ntau,
                                    int* out) {
  if (!sc_spec_ok(hspec, spec_len, nsig, ntau)) return (int)cudaErrorInvalidValue;
  int nt, nb;
  size_t smem;
  cudaError_t e = sc_block(hspec, nsig, ntau, &nt, &smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, slot_canon_kernel, nt, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = SC_G;
  out[1] = nt;
  out[2] = (int)smem;
  out[3] = nb;
  out[4] = nb * nt / 32;
  out[5] = SC_GS;
  return 0;
}

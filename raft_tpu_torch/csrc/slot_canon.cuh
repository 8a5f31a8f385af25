// slot_canon.cuh — the device code of KRaftWithReconfig's slot
// canonicalizer (slot_canon.cu's kernel; raft_tpu_torch/ops/slot_canon.py is
// its plain version, whose docstring lists the steps).
//
// Replaces raft_tpu/models/kraft_reconfig.py:2065-2146 _canon_hash for one
// (row, sigma, tau): the slot order, the canonical view (every per-slot row
// gathered by the order, the slot references, bitmasks, endOffset's axes,
// values and acked remapped), the remapped bag scattered to its sorted
// positions, and the view's hash (ops/hashing.py:135 hash_lanes, formula
// v4, as hash_rows.cu). Each piece strides over its elements as lane
// `lane` of `nl` lanes, so a warp runs it with nl = 32 (a __syncwarp
// between the view and the bag scatter, a shuffle reduction after the
// hash) and a host test with nl = 1.
#pragma once

#include "kreconfig_actions.cuh"

__device__ __forceinline__ int sc_refmap(int x, const int* inv, int S) {
  return x > 0 ? inv[ra_clamp(x - 1, 0, S - 1)] + 1 : 0;
}
__device__ __forceinline__ int sc_maskmap(int mask, const int* order, int S) {
  int out = 0;
  for (int r = 0; r < S; ++r) out |= ((mask >> order[r]) & 1) << r;
  return out;
}
__device__ __forceinline__ int sc_valmap(int v, int cmd, const int* tu, int V) {
  return (cmd == KC_C_APPEND && v > 0) ? tu[ra_clamp(v - 1, 0, V - 1)] + 1 : v;
}
// a message field of the key words kw replaced by val (WidePacker.replace)
__device__ __forceinline__ void sc_replace(const int* sp, int* kw, int f, int val) {
  const int* q = sp + KC_MSG + 3 * f;
  kw[q[0]] = (kw[q[0]] & ~(q[2] << q[1])) | (val << q[1]);
}

// The stable slot order of row s under host permutation sg: new row r <-
// old slot order[r], inv its inverse; used slots by (sg[host], diskId),
// unused ones last in slot order (every lane computes it: NS <= 8 keys).
__device__ __forceinline__ void sc_order(const int* sp, const int* s, const int* sg,
                                         int* order, int* inv) {
  const int S = sp[KC_S], H = sp[KC_N_HOSTS];
  const int big = (S > H ? S : H) + 2;
  int key[KC_MAX_S];
  for (int k = 0; k < S; ++k) {
    const int h2 = sg[ra_clamp(s[sp[KC_HOST] + k], 0, H - 1)];
    key[k] = s[sp[KC_USED] + k] > 0 ? h2 * big + s[sp[KC_DISK] + k] : big * big + k;
  }
  for (int k = 0; k < S; ++k) {
    int r = 0;
    for (int t = 0; t < S; ++t) r += key[t] < key[k] || (key[t] == key[k] && t < k);
    order[r] = k;
    inv[k] = r;
  }
}

// The canonical view cr[VL] but for the bag lanes, and the remapped keys of
// the bag's slots into keys (NW x M words, then M counts).
__device__ void sc_build_view(const int* sp, const int* s, const int* sg, const int* tu,
                              const int* order, const int* inv, int* cr, int* keys, int lane,
                              int nl) {
  const int S = sp[KC_S], L = sp[KC_L], V = sp[KC_V], M = sp[KC_M], NW = sp[KC_NW];
  const int H = sp[KC_N_HOSTS];
  const int plain[] = {KC_DISK, KC_USED, KC_ROLE, KC_ST, KC_EP, KC_PF_ACT, KC_PF_EP, KC_PF_OFF,
                       KC_PF_LE, KC_PF_OBS, KC_CID, KC_CCOMM, KC_LL, KC_HWM};
  const int refs[] = {KC_LED, KC_VF, KC_PF_DEST};
  const int masks[] = {KC_VG, KC_CM, KC_EODOM};
  for (int r = lane; r < S; r += nl) {
    const int k = order[r];
    cr[sp[KC_HOST] + r] = s[sp[KC_USED] + k] > 0 ? sg[ra_clamp(s[sp[KC_HOST] + k], 0, H - 1)] : 0;
    for (int f : plain) cr[sp[f] + r] = s[sp[f] + k];
    for (int f : refs) cr[sp[f] + r] = sc_refmap(s[sp[f] + k], inv, S);
    for (int f : masks) cr[sp[f] + r] = sc_maskmap(s[sp[f] + k], order, S);
  }
  for (int t = lane; t < S * L; t += nl) {
    const int r = t / L, l = t - r * L, src = order[r] * L + l;
    const int cmd = s[sp[KC_LOG + KE_CMD] + src];
    cr[sp[KC_LOG + KE_CMD] + t] = cmd;
    cr[sp[KC_LOG + KE_EPOCH] + t] = s[sp[KC_LOG + KE_EPOCH] + src];
    cr[sp[KC_LOG + KE_CFGID] + t] = s[sp[KC_LOG + KE_CFGID] + src];
    cr[sp[KC_LOG + KE_VAL] + t] = sc_valmap(s[sp[KC_LOG + KE_VAL] + src], cmd, tu, V);
    cr[sp[KC_LOG + KE_WHO] + t] = sc_refmap(s[sp[KC_LOG + KE_WHO] + src], inv, S);
    cr[sp[KC_LOG + KE_MEMBERS] + t] = sc_maskmap(s[sp[KC_LOG + KE_MEMBERS] + src], order, S);
  }
  for (int t = lane; t < S * S; t += nl) {
    const int r = t / S, c = t - r * S;
    cr[sp[KC_EO] + t] = s[sp[KC_EO] + order[r] * S + order[c]];
  }
  for (int v = lane; v < V; v += nl) cr[sp[KC_ACK] + tu[v]] = s[sp[KC_ACK] + v];
  for (int m = lane; m < M; m += nl) {
    int kw[KC_MAX_WORDS] = {0, 0, 0};
    for (int w = 0; w < NW; ++w) kw[w] = s[sp[KC_W0] + w * M + m];
    if (kw[0] != RA_EMPTY) {  // only an occupied slot's fields are remapped
      const int src = kc_unpack(sp, kw, KM_MSOURCE), dst = kc_unpack(sp, kw, KM_MDEST);
      const int mlead = kc_unpack(sp, kw, KM_MLEADER), who = kc_unpack(sp, kw, KM_E + KE_WHO);
      const int mem = kc_unpack(sp, kw, KM_E + KE_MEMBERS);
      const int val = kc_unpack(sp, kw, KM_E + KE_VAL), cmd = kc_unpack(sp, kw, KM_E + KE_CMD);
      sc_replace(sp, kw, KM_MSOURCE, inv[ra_clamp(src, 0, S - 1)]);
      sc_replace(sp, kw, KM_MDEST, inv[ra_clamp(dst, 0, S - 1)]);
      sc_replace(sp, kw, KM_MLEADER, sc_refmap(mlead, inv, S));
      sc_replace(sp, kw, KM_E + KE_WHO, sc_refmap(who, inv, S));
      sc_replace(sp, kw, KM_E + KE_MEMBERS, sc_maskmap(mem, order, S));
      sc_replace(sp, kw, KM_E + KE_VAL, sc_valmap(val, cmd, tu, V));
    }
    for (int w = 0; w < NW; ++w) keys[w * M + m] = kw[w];
    keys[NW * M + m] = s[sp[KC_CNT] + m];
  }
}

// The bag lanes of cr: each remapped key and count at its rank among the
// keys (a bag's keys are unique; its unused slots are equal, so any order
// among them is the sorted one) — ops/bag.py wide_bag_sort.
__device__ void sc_scatter_bag(const int* sp, const int* keys, int* cr, int lane, int nl) {
  const int M = sp[KC_M], NW = sp[KC_NW];
  for (int m = lane; m < M; m += nl) {
    int r = 0;
    for (int t = 0; t < M; ++t) {
      bool less = false, tie = true;
      for (int w = 0; w < NW; ++w) {
        const int a = keys[w * M + t], b = keys[w * M + m];
        less = less || (tie && a < b);
        tie = tie && a == b;
      }
      r += less || (tie && t < m);
    }
    for (int w = 0; w < NW; ++w) cr[sp[KC_W0] + w * M + r] = keys[w * M + m];
    cr[sp[KC_CNT] + r] = keys[NW * M + m];
  }
}

// This lane's XOR share of hash_lanes' two streams over cr[0, VL) (the
// caller XOR-reduces the lanes, then rt_combine(ha ^ VL * KA, hb ^ VL * KB))
__device__ __forceinline__ void sc_hash_part(const int* sp, const int* cr, int lane, int nl,
                                             uint32_t sa, uint32_t sb, int seeded, uint32_t* ha,
                                             uint32_t* hb) {
  for (int j = lane; j < sp[KC_VL]; j += nl) {
    const uint32_t x = (uint32_t)cr[j];
    const uint32_t pa = (uint32_t)j * 0x9E3779B9u, pb = (uint32_t)j * 0x85EBCA77u;
    uint32_t xa = x, xb = x;
    if (seeded) {
      xa ^= rt_mix32(pa + sa);
      xb ^= rt_mix32(pb + sb);
    }
    *ha ^= rt_mix32(xa * RT_KA + pa);
    *hb ^= rt_mix32(xb * RT_KB + pb);
  }
}

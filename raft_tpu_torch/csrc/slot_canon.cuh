// slot_canon.cuh — the device code of KRaftWithReconfig's slot
// canonicalizer (slot_canon.cu's kernel; raft_tpu_torch/ops/slot_canon.py is
// its plain version, whose docstring lists the steps).
//
// Replaces raft_tpu/models/kraft_reconfig.py:2065-2146 _canon_hash and
// :2059 _fp1 for one row: the min over the (sigma, tau) pairs of the hash
// of the canonical view (ops/hashing.py:135 hash_lanes, formula v4). The
// view is never built. hash_lanes is an XOR of one term a lane, whose
// positional salt comes from the lane's position, so each element of the
// row is hashed at the position the canon moves it to, and the hash is
// split by what each element depends on (exact in any order of the terms):
//   - sigma alone: the per-slot fields, the log but log_val, endOffset (280
//     of 472 lanes at the full cfg) through the slot order of sigma, hashed
//     once per sigma (sc_sigma_part);
//   - the pair: log_val and acked, and the occupied message keys, remapped
//     and ranked among each other only (sc_pair_part);
//   - neither: the unused bag slots. A key's words lie below 2^30 (the
//     packer's 30-bit words) and a remapped field fits its mask, so the
//     occupied keys sort before every unused slot (EMPTY = 2^30 in word 0)
//     under every pair, and the unused slots keep positions c..M-1 in their
//     own order: hashed once per row (sc_row). A row with a word 0 above
//     EMPTY (which no packer makes) ranks all M slots under each pair.
// The slot order of a sigma (order: new row r <- old slot; inv its inverse)
// is ranked once a sigma across S members and packed 3 bits a slot into
// two registers (ScPerm), sigma and tau 4 bits an entry into one each: no
// array indexed at run time. A lane table built once a block
// (sc_lane_entry) gives every non-bag element its field, slot, entry and
// kind, ordered by kind so that the lanes of a warp mostly take one branch.
//
// Every piece runs over a group (canon_tiers.cuh): member t of G takes
// elements t, t + G, ...; each() runs a member's share (a tile of the card)
// or all G shares in turn (CtSerial, the host build), sync() is the group's
// barrier between a write to shared scratch and its reads, sum() and xor2()
// combine the members' partials. Everything is plain C++ once CUDA's
// qualifiers are defined away (tests/test_torch_slot_canon_host.py).
#pragma once

#include "canon_tiers.cuh"
#include "kreconfig_actions.cuh"

#define SC_MAX_PERM 8  // hosts and values a packed permutation holds (4 bits each)

// lane-table kinds: how an element's value and position follow the pair
enum { SC_PLAIN, SC_EO, SC_REF, SC_MASK, SC_HOST, SC_VAL };
// shapes: a lane a slot, L lanes a slot (the log), S x S (endOffset)
enum { SC_SLOT, SC_LOG, SC_SQ };

// The view's non-bag fields in lane-table order: {spec index, kind, shape}.
// Every kind but SC_VAL depends on sigma alone; log_val comes last.
#define SC_NF 28
__device__ const unsigned char sc_fields[SC_NF][3] = {
    {KC_DISK, SC_PLAIN, SC_SLOT},   {KC_USED, SC_PLAIN, SC_SLOT},
    {KC_ROLE, SC_PLAIN, SC_SLOT},   {KC_ST, SC_PLAIN, SC_SLOT},
    {KC_EP, SC_PLAIN, SC_SLOT},     {KC_PF_ACT, SC_PLAIN, SC_SLOT},
    {KC_PF_EP, SC_PLAIN, SC_SLOT},  {KC_PF_OFF, SC_PLAIN, SC_SLOT},
    {KC_PF_LE, SC_PLAIN, SC_SLOT},  {KC_PF_OBS, SC_PLAIN, SC_SLOT},
    {KC_CID, SC_PLAIN, SC_SLOT},    {KC_CCOMM, SC_PLAIN, SC_SLOT},
    {KC_LL, SC_PLAIN, SC_SLOT},     {KC_HWM, SC_PLAIN, SC_SLOT},
    {KC_LOG + KE_CMD, SC_PLAIN, SC_LOG}, {KC_LOG + KE_EPOCH, SC_PLAIN, SC_LOG},
    {KC_LOG + KE_CFGID, SC_PLAIN, SC_LOG}, {KC_EO, SC_EO, SC_SQ},
    {KC_LED, SC_REF, SC_SLOT},      {KC_VF, SC_REF, SC_SLOT},
    {KC_PF_DEST, SC_REF, SC_SLOT},  {KC_LOG + KE_WHO, SC_REF, SC_LOG},
    {KC_VG, SC_MASK, SC_SLOT},      {KC_CM, SC_MASK, SC_SLOT},
    {KC_EODOM, SC_MASK, SC_SLOT},   {KC_LOG + KE_MEMBERS, SC_MASK, SC_LOG},
    {KC_HOST, SC_HOST, SC_SLOT},    {KC_LOG + KE_VAL, SC_VAL, SC_LOG}};

// the elements of sigma's lanes (every field but log_val) and of the table
__host__ __device__ __forceinline__ int sc_n_sigma(const int* sp) {
  const int S = sp[KC_S], L = sp[KC_L];
  return 21 * S + 5 * S * L + S * S;
}
__host__ __device__ __forceinline__ int sc_n_lanes(const int* sp) {
  return sc_n_sigma(sp) + sp[KC_S] * sp[KC_L];
}

// Entry e of the lane table: a = field offset | lanes a slot << 16 (1, L or
// S); b = slot k | entry l << 4 | kind << 8 (l: the log entry, or
// endOffset's column slot). The element is v[off + k * mult + l]; under a
// pair it moves to off + inv[k] * mult + l (endOffset: + inv[l]).
__device__ __forceinline__ void sc_lane_entry(const int* sp, int e, int* a, int* b) {
  const int S = sp[KC_S], L = sp[KC_L];
  for (int i = 0; i < SC_NF; ++i) {
    const int shape = sc_fields[i][2];
    const int mult = shape == SC_SLOT ? 1 : shape == SC_LOG ? L : S;
    const int n = S * mult;
    if (e >= n) {
      e -= n;
      continue;
    }
    const int k = e / mult, l = e - k * mult;
    *a = sp[sc_fields[i][0]] | mult << 16;
    *b = k | l << 4 | sc_fields[i][1] << 8;
    return;
  }
}

// a permutation of at most SC_MAX_PERM entries, 4 bits an entry
__device__ __forceinline__ uint32_t sc_pack_perm(const int* p, int n) {
  uint32_t x = 0;
  for (int i = 0; i < n; ++i) x |= (uint32_t)(p[i] & 15) << (4 * i);
  return x;
}
__device__ __forceinline__ int sc_at(uint32_t perm, int i) { return (int)(perm >> (4 * i)) & 15; }

// A sigma's slot order, 3 bits a slot: ord (new row r <- old slot) and inv
// (old slot -> new row)
struct ScPerm {
  uint32_t ord, inv;
  __device__ __forceinline__ int o(int r) const { return (int)(ord >> (3 * r)) & 7; }
  __device__ __forceinline__ int i(int k) const { return (int)(inv >> (3 * k)) & 7; }
};

__device__ __forceinline__ int sc_ref(int x, ScPerm pm, int S) {
  return x > 0 ? pm.i(ra_clamp(x - 1, 0, S - 1)) + 1 : 0;
}
// a slot bitmask: new bit inv[k] = old bit k (new bit r = old bit order[r])
__device__ __forceinline__ int sc_mask(int x, ScPerm pm, int S) {
  int out = 0;
  for (int k = 0; k < S; ++k) out |= ((x >> k) & 1) << pm.i(k);
  return out;
}
__device__ __forceinline__ int sc_val(int x, int cmd, uint32_t tu, int V) {
  return (cmd == KC_C_APPEND && x > 0) ? sc_at(tu, ra_clamp(x - 1, 0, V - 1)) + 1 : x;
}

// hash_lanes' term of value x at view position j, XORed into (ha, hb)
__device__ __forceinline__ void sc_term(int j, int x, uint32_t sa, uint32_t sb, int seeded,
                                        uint32_t& ha, uint32_t& hb) {
  const uint32_t pa = (uint32_t)j * CT_PA, pb = (uint32_t)j * CT_PB;
  uint32_t xa = (uint32_t)x, xb = (uint32_t)x;
  if (seeded) {
    xa ^= rt_mix32(pa + sa);
    xb ^= rt_mix32(pb + sb);
  }
  ha ^= rt_mix32(xa * RT_KA + pa);
  hb ^= rt_mix32(xb * RT_KB + pb);
}

// a message key's words; indexed by unrolled loops only (a run-time index
// would put it in local memory)
struct ScKey {
  int w[KC_MAX_WORDS];
};
__device__ __forceinline__ int sc_get(const int* q, const ScKey& k) {
  int x = k.w[0];
#pragma unroll
  for (int w = 1; w < KC_MAX_WORDS; ++w) x = q[0] == w ? k.w[w] : x;
  return (x >> q[1]) & q[2];
}
// WidePacker.replace: the field at q = (word, shift, mask) set to val
__device__ __forceinline__ void sc_put(const int* q, ScKey& k, int val) {
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w)
    if (q[0] == w) k.w[w] = (k.w[w] & ~(q[2] << q[1])) | (val << q[1]);
}
__device__ __forceinline__ bool sc_less(const ScKey& a, const ScKey& b, int NW) {
  bool less = false, tie = true;
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w)
    if (w < NW) {
      less = less || (tie && a.w[w] < b.w[w]);
      tie = tie && a.w[w] == b.w[w];
    }
  return less;
}
__device__ __forceinline__ bool sc_equal(const ScKey& a, const ScKey& b, int NW) {
  bool eq = true;
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w) eq = eq && (w >= NW || a.w[w] == b.w[w]);
  return eq;
}
__device__ __forceinline__ bool sc_all_empty(const ScKey& k, int NW) {
  bool e = true;
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w) e = e && (w >= NW || k.w[w] == RA_EMPTY);
  return e;
}
// word w of slot m of a bag stored word-major (M slots a word)
__device__ __forceinline__ ScKey sc_load(const int* words, int M, int m, int NW) {
  ScKey k;
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w) k.w[w] = w < NW ? words[w * M + m] : 0;
  return k;
}

// An occupied key's fields remapped under the pair (pm, tu)
__device__ __forceinline__ void sc_remap(const int* sp, ScKey& k, ScPerm pm, uint32_t tu) {
  const int S = sp[KC_S], V = sp[KC_V];
  const int* q = sp + KC_MSG;
  const int src = sc_get(q + 3 * KM_MSOURCE, k), dst = sc_get(q + 3 * KM_MDEST, k);
  const int mlead = sc_get(q + 3 * KM_MLEADER, k), who = sc_get(q + 3 * (KM_E + KE_WHO), k);
  const int mem = sc_get(q + 3 * (KM_E + KE_MEMBERS), k);
  const int val = sc_get(q + 3 * (KM_E + KE_VAL), k), cmd = sc_get(q + 3 * (KM_E + KE_CMD), k);
  sc_put(q + 3 * KM_MSOURCE, k, pm.i(ra_clamp(src, 0, S - 1)));
  sc_put(q + 3 * KM_MDEST, k, pm.i(ra_clamp(dst, 0, S - 1)));
  sc_put(q + 3 * KM_MLEADER, k, sc_ref(mlead, pm, S));
  sc_put(q + 3 * (KM_E + KE_WHO), k, sc_ref(who, pm, S));
  sc_put(q + 3 * (KM_E + KE_MEMBERS), k, sc_mask(mem, pm, S));
  sc_put(q + 3 * (KM_E + KE_VAL), k, sc_val(val, cmd, tu, V));
}

// The block's tables, member t of nt: sigma i and tau j packed (sigp[i],
// taup[j]) and the lane table (taba, tabb: sc_n_lanes entries)
__device__ __forceinline__ void sc_tables(const int* sp, const int* sig, int nsig, const int* tau,
                                          int ntau, int* sigp, int* taup, int* taba, int* tabb,
                                          int t, int nt) {
  const int H = sp[KC_N_HOSTS], V = sp[KC_V];
  for (int i = t; i < nsig; i += nt) sigp[i] = (int)sc_pack_perm(sig + i * H, H);
  for (int j = t; j < ntau; j += nt) taup[j] = (int)sc_pack_perm(tau + j * V, V);
  for (int e = t; e < sc_n_lanes(sp); e += nt) sc_lane_entry(sp, e, taba + e, tabb + e);
}

// What a row gives every pair: the slots it ranks (list[0, n): the occupied
// ones in slot order; every slot where a word 0 lies above EMPTY) and the
// unused slots' share of the hash (ta, tb; 0 where all M are ranked)
struct ScRow {
  int n;
  uint32_t ta, tb;
};

// The row's pair-independent part (v: the row's view lanes), over the group
// g; list[M] is the group's scratch, read by every pair after g.sync().
template <class Grp>
__device__ ScRow sc_row(const int* sp, const int* v, int* list, uint32_t sa, uint32_t sb,
                        int seeded, Grp& g) {
  const int M = sp[KC_M], NW = sp[KC_NW], w0 = sp[KC_W0], cnt = sp[KC_CNT];
  // occupied slots; slots with a word 0 above EMPTY, and unused ones whose
  // other words are not all EMPTY (each count 1 << 16)
  uint32_t occ[1] = {0}, odd[1] = {0};
  g.each([&](int t, int G) {
    for (int m = t; m < M; m += G) {
      const ScKey k = sc_load(v + w0, M, m, NW);
      occ[0] += k.w[0] != RA_EMPTY;
      odd[0] += (k.w[0] > RA_EMPTY) + (k.w[0] == RA_EMPTY && !sc_all_empty(k, NW) ? 1u << 16 : 0u);
    }
  });
  g.sum(occ, odd, 1);
  const bool all = (odd[0] & 0xffff) != 0, ordered = odd[0] == 0;
  const int c = all ? M : (int)occ[0];
  uint32_t ta = 0, tb = 0;
  g.each([&](int t, int G) {
    for (int m = t; m < M; m += G) {
      if (all) {
        list[m] = m;
        continue;
      }
      int pos = 0;  // occupied slots before m
      for (int u = 0; u < m; ++u) pos += v[w0 + u] != RA_EMPTY;
      if (v[w0 + m] != RA_EMPTY) {
        list[pos] = m;
        continue;
      }
      // an unused slot: its rank among the unused ones, by slot where they
      // are all EMPTY words, else by their words (word 0 ties)
      const ScKey km = sc_load(v + w0, M, m, NW);
      int r = c + m - pos;
      if (!ordered) {
        r = c;
        for (int u = 0; u < M; ++u) {
          if (v[w0 + u] != RA_EMPTY) continue;
          const ScKey ku = sc_load(v + w0, M, u, NW);
          r += sc_less(ku, km, NW) || (u < m && sc_equal(ku, km, NW));
        }
      }
#pragma unroll
      for (int w = 0; w < KC_MAX_WORDS; ++w)
        if (w < NW) sc_term(w0 + w * M + r, km.w[w], sa, sb, seeded, ta, tb);
      sc_term(cnt + r, v[cnt + m], sa, sb, seeded, ta, tb);
    }
  });
  g.xor2(ta, tb);
  g.sync();
  return ScRow{c, ta, tb};
}

// sigma's slot order on row v (sg: sigma packed), ranked across S members
// (okeys[S]: the group's scratch)
template <class Grp>
__device__ ScPerm sc_order(const int* sp, const int* v, uint32_t sg, int* okeys, Grp& g) {
  const int S = sp[KC_S], H = sp[KC_N_HOSTS];
  const int big = (S > H ? S : H) + 2;
  g.each([&](int t, int G) {
    for (int k = t; k < S; k += G) {
      const int h2 = sc_at(sg, ra_clamp(v[sp[KC_HOST] + k], 0, H - 1));
      okeys[k] = v[sp[KC_USED] + k] > 0 ? h2 * big + v[sp[KC_DISK] + k] : big * big + k;
    }
  });
  g.sync();
  uint32_t ord[1] = {0}, inv[1] = {0};
  g.each([&](int t, int G) {
    for (int k = t; k < S; k += G) {
      int r = 0;
      for (int u = 0; u < S; ++u) r += okeys[u] < okeys[k] || (okeys[u] == okeys[k] && u < k);
      inv[0] += (uint32_t)r << (3 * k);
      ord[0] += (uint32_t)k << (3 * r);
    }
  });
  g.sum(ord, inv, 1);
  return ScPerm{ord[0], inv[0]};
}

// This member's share of sigma's lanes (taba/tabb[0, sc_n_sigma)), XORed
// into (ha, hb)
template <class Grp>
__device__ void sc_sigma_part(const int* sp, const int* v, const int* taba, const int* tabb,
                              ScPerm pm, uint32_t sg, uint32_t sa, uint32_t sb, int seeded,
                              uint32_t& ha, uint32_t& hb, Grp& g) {
  const int S = sp[KC_S], H = sp[KC_N_HOSTS], ne = sc_n_sigma(sp);
  g.each([&](int t, int G) {
    for (int e = t; e < ne; e += G) {
      const int a = taba[e], b = tabb[e];
      const int off = a & 0xffff, mult = a >> 16, k = b & 15, l = (b >> 4) & 15;
      int x = v[off + k * mult + l], dl = l;
      switch (b >> 8) {
        case SC_EO:
          dl = pm.i(l);
          break;
        case SC_REF:
          x = sc_ref(x, pm, S);
          break;
        case SC_MASK:
          x = sc_mask(x, pm, S);
          break;
        case SC_HOST:
          x = v[sp[KC_USED] + k] > 0 ? sc_at(sg, ra_clamp(x, 0, H - 1)) : 0;
          break;
        default:
          break;
      }
      sc_term(off + pm.i(k) * mult + dl, x, sa, sb, seeded, ha, hb);
    }
  });
}

// The pair's own share (log_val, acked, the ranked bag slots list[0, n))
// XORed into (ha, hb); buf[NW * M] is the group's scratch, free again after
// the caller's g.sync()
template <class Grp>
__device__ void sc_pair_part(const int* sp, const int* v, const int* taba, const int* tabb,
                             const int* list, int n, ScPerm pm, uint32_t tu, int* buf,
                             uint32_t sa, uint32_t sb, int seeded, uint32_t& ha, uint32_t& hb,
                             Grp& g) {
  const int V = sp[KC_V], M = sp[KC_M], NW = sp[KC_NW], w0 = sp[KC_W0], cnt = sp[KC_CNT];
  const int e0 = sc_n_sigma(sp), nv = sc_n_lanes(sp) - e0;
  const int dcmd = sp[KC_LOG + KE_CMD] - sp[KC_LOG + KE_VAL];
  g.each([&](int t, int G) {
    for (int e = t; e < nv + V; e += G) {
      if (e >= nv) {  // acked'[tau[u]] = acked[u]
        const int u = e - nv;
        sc_term(sp[KC_ACK] + sc_at(tu, u), v[sp[KC_ACK] + u], sa, sb, seeded, ha, hb);
        continue;
      }
      const int a = taba[e0 + e], b = tabb[e0 + e];
      const int off = a & 0xffff, mult = a >> 16, k = b & 15, l = (b >> 4) & 15;
      const int src = off + k * mult + l;
      sc_term(off + pm.i(k) * mult + l, sc_val(v[src], v[src + dcmd], tu, V), sa, sb, seeded,
              ha, hb);
    }
    for (int i = t; i < n; i += G) {
      ScKey k = sc_load(v + w0, M, list[i], NW);
      if (k.w[0] != RA_EMPTY) sc_remap(sp, k, pm, tu);
#pragma unroll
      for (int w = 0; w < KC_MAX_WORDS; ++w)
        if (w < NW) buf[w * M + i] = k.w[w];
    }
  });
  g.sync();
  g.each([&](int t, int G) {
    for (int i = t; i < n; i += G) {  // the rank among the ranked slots, ties by slot
      const ScKey k = sc_load(buf, M, i, NW);
      int r = 0;
      for (int u = 0; u < n; ++u) {
        const ScKey ku = sc_load(buf, M, u, NW);
        r += sc_less(ku, k, NW) || (u < i && sc_equal(ku, k, NW));
      }
#pragma unroll
      for (int w = 0; w < KC_MAX_WORDS; ++w)
        if (w < NW) sc_term(w0 + w * M + r, k.w[w], sa, sb, seeded, ha, hb);
      sc_term(cnt + r, v[cnt + list[i]], sa, sb, seeded, ha, hb);
    }
  });
}

// The least pair hash of sigmas q, q + Q, ... (< nsig) with every tau, over
// the group g (one of Q sub-groups of the row's group); okeys[KC_MAX_S] and
// buf[NW * M] are its scratch
template <class Grp>
__device__ uint64_t sc_sigmas(const int* sp, const int* v, const int* taba, const int* tabb,
                              const int* sigp, int nsig, const int* taup, int ntau, ScRow row,
                              const int* list, int* okeys, int* buf, int q, int Q, uint32_t sa,
                              uint32_t sb, int seeded, Grp& g) {
  const uint32_t VL = (uint32_t)sp[KC_VL];
  uint64_t best = ~0ull;
  for (int i = q; i < nsig; i += Q) {
    const uint32_t sg = (uint32_t)sigp[i];
    const ScPerm pm = sc_order(sp, v, sg, okeys, g);
    uint32_t sha = 0, shb = 0;  // this member's share of sigma's lanes
    sc_sigma_part(sp, v, taba, tabb, pm, sg, sa, sb, seeded, sha, shb, g);
    for (int j = 0; j < ntau; ++j) {
      uint32_t ha = sha, hb = shb;
      sc_pair_part(sp, v, taba, tabb, list, row.n, pm, (uint32_t)taup[j], buf, sa, sb, seeded,
                   ha, hb, g);
      g.xor2(ha, hb);
      const uint64_t h = rt_combine(ha ^ row.ta ^ VL * RT_KA, hb ^ row.tb ^ VL * RT_KB);
      best = h < best ? h : best;
      g.sync();  // the next pair rewrites buf
    }
  }
  return best;
}

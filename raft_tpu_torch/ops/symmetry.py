"""VIEW projection + SYMMETRY reduction + fingerprinting, layout-driven.

Counterpart of ``raft_tpu/ops/symmetry.py`` (fingerprint formula v5,
hashv=5, refine_rounds 3). The canonical fingerprint is a min of the
permuted view's hash over a set of server permutations, and the set is
fixed per layout as in the reference (``prune``, :393):

  - S <= 4: all S! permutations (``_masked_min(view, None)``, :1017);
  - S >= 5: the signature-ADMISSIBLE permutations only — those that sort
    the permutation-equivariant 1-WL server signatures (``_signatures``,
    :581) ascending as unsigned u64 (``_masked_min(view, sig)``; the
    reference's tiers ``_tier_pre``/``_tier3_local``/``_tier3_full`` are
    three routes to that one set, :1081-1228).

The hash of a permuted view is never materialized: non-bag lanes hash
positionally, so a permutation moves positional salts (``_build_direct``
tables, :490, or ``_dyn_outpos`` arithmetic, :914) and remaps
server-valued lanes and bitmasks; the message bag hashes as a multiset
whose server fields are remapped in place (``_bag_streams``, :823): XOR
over the non-bag lanes, ADDITION mod 2^32 over the occupied bag slots.

``fingerprints_memo`` is the main path. On a CUDA tensor it launches
``canon_memo`` (csrc/canon_memo.cu) for S <= 4 and ``canon_tiered``
(csrc/canon_tiered.cu over the device code of csrc/canon_tiers.cuh) for
S >= 5; on a CPU tensor it runs the plain PyTorch version below. Both
probe and fill the same direct-mapped memo table and return bit-identical
fingerprints. ``signatures`` exposes the S >= 5 signatures (the
``canon_signatures`` launcher on CUDA tensors).
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from .. import kernels
from .hashing import (
    INT64_MAX,
    KA,
    KB,
    M32,
    PA,
    PB,
    combine_pair,
    hash_lanes_pair,
    memo_slot,
    mix32,
    mul32,
    np_mix32,
    seed_salts,
    sum32,
    u32,
    xor_reduce,
)
from .packing import EMPTY

_MASK64 = (1 << 64) - 1
_C2 = 0xC2B2AE3D27D4EB4F
BAG_WORDS = 3  # hi, lo, count
REFINE_ROUNDS = 3  # 1-WL refinement depth of the signatures (wl=3)
PRUNE_FROM = 5  # layouts with this many servers take the admissible min
# the server fields of a message key and how each remaps under a
# permutation (the reference's msg_perm_spec, raft_tpu/ops/symmetry.py:
# 333-343): "server" is a plain index (msource, mdest), "server_nil" is
# 0 = Nil or i + 1 = server i (KRaft's mleader). The field order is part of
# the fingerprint (the signatures salt field k by k). "server_bitmask" is
# not ported yet (the reconfiguration specs are its only users).
MSG_SERVER_FIELDS = ("msource", "mdest")
DEFAULT_SPEC = tuple((f, "server") for f in MSG_SERVER_FIELDS)
MSG_KINDS = {"server": 0, "server_nil": 1}  # codes shared with csrc/canon_*
# codes shared with csrc/canon_tiers.cuh
SIG_KINDS = {"per_server": 0, "per_server_val": 1, "server_bitmask": 2,
             "per_server_pair": 3}
TIER_HEADER = ("S", "VL", "K", "n_plain", "n_val", "n_bm", "hi_off", "lo_off",
               "cnt_off", "M", "n_fields", "n_sig", "rounds", "ka", "kb", "seeded",
               "seed_a", "seed_b", "sx0", "sx1", "sx2", "off_fields", "off_sig",
               "off_lanes", "len")
MAX_TIER_SERVERS = 8  # csrc/canon_tiers.cuh CT_MAX_S


def _host_mix64(z: int) -> int:
    """splitmix64 finalizer on python ints (for setup-time salts)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _salt(field_offset: int, role: int) -> tuple[int, int]:
    """The reference's per-(field, role) u32 salt pair."""
    z = _host_mix64(field_offset * 0x100 + role + 0x5A17)
    return z >> 32, z & M32


def mul32t(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2**32 for u32 values held in int64 tensors, without
    leaving the signed 64-bit range."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & M32


def _pmix(x: torch.Tensor, salt) -> tuple[torch.Tensor, torch.Tensor]:
    """int tensor -> (u32, u32) mixed stream pair under a salt pair."""
    xx = u32(x)
    return (mix32((mul32(xx, KA) + salt[0]) & M32),
            mix32((mul32(xx, KB) + salt[1]) & M32))


def _pfold(p, salt):
    """Re-avalanche a stream pair under a salt pair."""
    return mix32((p[0] + salt[0]) & M32), mix32((p[1] + salt[1]) & M32)


def _pxmix(p, salt):
    """(mix32(a ^ sa), mix32(b ^ sb)) of a stream pair."""
    return mix32(p[0] ^ salt[0]), mix32(p[1] ^ salt[1])


def _padd(p, q):
    return (p[0] + q[0]) & M32, (p[1] + q[1]) & M32


def _pwhere(cond, p):
    return torch.where(cond, p[0], 0), torch.where(cond, p[1], 0)


def _psum(p, dim=-1):
    return sum32(p[0], dim), sum32(p[1], dim)


def _checked_spec(spec) -> tuple[tuple[str, str], ...]:
    spec = tuple((str(f), str(k)) for f, k in spec)
    for _f, kind in spec:
        if kind not in MSG_KINDS:
            raise NotImplementedError(f"message remap kind {kind!r} is not ported yet")
    return spec


def msg_perm_spec(model) -> tuple[tuple[str, str], ...]:
    """The (field, kind) remap pairs of a model's message keys, as the
    reference's ``Canonicalizer.for_model`` reads them: the model's
    ``msg_perm_spec``, else its ``msg_server_fields`` (default msource and
    mdest) as "server", then its ``msg_server_nil_fields`` as
    "server_nil"."""
    spec = getattr(model, "msg_perm_spec", None)
    if spec is None:
        spec = tuple((f, "server") for f in getattr(model, "msg_server_fields",
                                                     MSG_SERVER_FIELDS)) + tuple(
            (f, "server_nil") for f in getattr(model, "msg_server_nil_fields", ()))
    return _checked_spec(spec)


def _remap_np(val, kind, sigma, S):
    """Message field values under sigma (numpy): a value naming no server
    maps to 0, as the reference's one-hot sums give."""
    if kind == "server":
        return np.where((val >= 0) & (val < S), sigma[np.clip(val, 0, S - 1)], 0)
    return np.where((val >= 1) & (val <= S), sigma[np.clip(val - 1, 0, S - 1)] + 1, 0)


def permute_states(layout, packer, states: np.ndarray, sigma, spec=DEFAULT_SPEC) -> np.ndarray:
    """Apply the server permutation ``sigma`` (old server i -> new index
    sigma[i]) to a [B, W] numpy state batch: server rows move, server
    values and bitmasks remap, the message fields of ``spec`` ((field,
    kind) pairs, ``msg_perm_spec``) remap and the bag slots re-sort. A
    symmetric canonicalization gives the result the same fingerprint as
    the input."""
    S = layout.n_servers
    sigma = np.asarray(sigma)
    inv = np.argsort(sigma)
    out = states.copy()
    for f in layout.fields.values():
        sl = layout.sl(f.name)
        seg = states[:, sl]
        if f.kind in ("per_server", "per_server_val", "server_bitmask"):
            rows = seg.reshape(len(states), S, -1)[:, inv]
            if f.kind == "per_server_val":
                rows = np.where(rows > 0, sigma[np.clip(rows - 1, 0, S - 1)] + 1, 0)
            elif f.kind == "server_bitmask":
                rows = sum(((rows >> j) & 1) << sigma[j] for j in range(S))
            out[:, sl] = rows.reshape(len(states), -1)
        elif f.kind == "per_server_pair":
            mat = seg.reshape(len(states), S, S)[:, inv][:, :, inv]
            out[:, sl] = mat.reshape(len(states), -1)
    hi = layout.get(out, "msg_hi").copy()
    lo = layout.get(out, "msg_lo").copy()
    cnt = layout.get(out, "msg_cnt").copy()
    occ = hi != EMPTY
    for name, kind in _checked_spec(spec):
        val = packer.unpack(hi, lo, name)
        hi2, lo2 = packer.replace(hi, lo, name, _remap_np(val, kind, sigma, S))
        hi = np.where(occ, hi2, hi)
        lo = np.where(occ, lo2, lo)
    order = np.lexsort((lo, hi), axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    out[:, layout.sl("msg_hi")] = take(hi)
    out[:, layout.sl("msg_lo")] = take(lo)
    out[:, layout.sl("msg_cnt")] = take(cnt)
    return out


class Canonicalizer:
    """Canonical (VIEW + SYMMETRY) fingerprints of packed Raft states.

    ``fingerprints_memo(states, valid, memo)`` is the engine's call; see
    the module docstring. ``fingerprints`` (no memo) serves the initial
    states and the tests. A message key's server fields and their kinds
    are ``spec`` (``msg_perm_spec``)."""

    @classmethod
    def for_model(cls, model, symmetry: bool = True, seed: int = 0):
        return cls(model.layout, model.packer, symmetry=symmetry, seed=seed,
                   spec=msg_perm_spec(model))

    def __init__(self, layout, packer, symmetry: bool = True, seed: int = 0,
                 spec=DEFAULT_SPEC):
        S = layout.n_servers
        VL = layout.view_len
        self.layout, self.packer = layout, packer
        self.symmetry, self.seed = symmetry, seed
        self.S, self.VL = S, VL
        self.spec = _checked_spec(spec)
        # the permutation set is fixed per layout (the reference's prune)
        self.prune = symmetry and S >= PRUNE_FROM
        if self.prune and S > MAX_TIER_SERVERS:
            raise NotImplementedError(
                f"symmetry reduction is built for at most {MAX_TIER_SERVERS} servers")
        perms = (
            np.array(list(itertools.permutations(range(S))), np.int64)
            if symmetry else np.arange(S, dtype=np.int64)[None, :]
        )
        self.P = perms.shape[0]

        view_fields = sorted(
            (f for f in layout.fields.values() if f.offset < VL),
            key=lambda f: f.offset,
        )
        bag_kinds = ("msg_hi", "msg_lo", "msg_cnt")
        bag_lanes = set()
        val_lanes, bm_lanes = set(), set()
        for f in view_fields:
            lanes = range(f.offset, f.offset + f.size)
            if f.kind in bag_kinds:
                bag_lanes |= set(lanes)
            elif f.kind == "msg_word":
                raise NotImplementedError("N-word message bags are not ported yet")
            elif f.kind == "per_server_val":
                val_lanes |= set(lanes)
            elif f.kind == "server_bitmask":
                bm_lanes |= set(lanes)
        nb = np.array([i for i in range(VL) if i not in bag_lanes], np.int64)
        K = len(nb)
        nb_inv = np.full(VL, -1, np.int64)
        nb_inv[nb] = np.arange(K)
        ln_plain = [l for l in nb if l not in val_lanes and l not in bm_lanes]
        ln_val = [l for l in nb if l in val_lanes]
        ln_bm = [l for l in nb if l in bm_lanes]
        # group order (plain, val, bm): the kernel loops over each group
        lanes = np.array(ln_plain + ln_val + ln_bm, np.int64)
        self._K = K
        self._groups = (len(ln_plain), len(ln_val), len(ln_bm))
        self._view_fields = view_fields
        # hash position of each non-bag lane under a permutation sigma:
        # c0 + sigma[s1] * m1 + sigma[s2] * m2 (s = -1: no term), affine in
        # sigma because permutations move whole server blocks (_dyn_outpos)
        desc = {}
        for f in view_fields:
            if f.kind in bag_kinds:
                continue
            base = int(nb_inv[f.offset])
            for x in range(f.size):
                if f.kind in ("per_server", "per_server_val", "server_bitmask"):
                    i, c = divmod(x, f.size // S)
                    desc[f.offset + x] = (base + c, i, f.size // S, -1, 0)
                elif f.kind == "per_server_pair":
                    i, j = divmod(x, S)
                    desc[f.offset + x] = (base, i, S, j, 1)
                else:
                    desc[f.offset + x] = (base + x, -1, 0, -1, 0)
        self._lane_desc = np.array([(l, *desc[l]) for l in lanes], np.int64).reshape(-1, 6)

        # permuted positional salts: the hash position of each non-bag lane
        # (group order) under every permutation, and under the identity
        # (the raw key's positions); the reference's _build_direct tables
        d = self._lane_desc

        def positions(p):  # [T, S] permutations -> [T, K] positions
            def term(srv, mul):
                return np.where(srv >= 0, p[:, np.maximum(srv, 0)] * mul, 0)
            return d[:, 1] + term(d[:, 2], d[:, 3]) + term(d[:, 4], d[:, 5])

        op = positions(perms)
        rp = positions(np.arange(S)[None])
        sa, sb = seed_salts(seed)

        def salts(pos):
            pa = (pos * PA) & M32
            pb = (pos * PB) & M32
            if seed:
                xa = np_mix32((pa + sa).astype(np.uint64))
                xb = np_mix32((pb + sb).astype(np.uint64))
            else:
                xa = xb = np.zeros_like(pa)
            return pa, pb, xa, xb

        valmap = np.zeros((self.P, S + 1), np.int64)
        valmap[:, 1:] = perms + 1
        wa, wb, sx = [], [], []
        for w_i in range(BAG_WORDS):
            a, b = _salt(w_i, 20)
            wa.append(a)
            wb.append(b)
            sx.append(_host_mix64(w_i * _C2 + seed) & M32 if seed else 0)
        hi_sl, lo_sl, cnt_sl = (layout.sl(n) for n in ("msg_hi", "msg_lo", "msg_cnt"))
        # (word, shift, mask, kind code) of each message server field
        fields = [(*packer.locate(name), MSG_KINDS[kind]) for name, kind in self.spec]
        self._host = dict(
            lanes=lanes, perms=perms, valmap=valmap,
            pow2=(1 << perms), inv=np.argsort(perms, axis=1),
            perm=np.stack(salts(op)), raw=np.stack(salts(rp)),
            wa=wa, wb=wb, sx=sx, fields=fields,
            seed_salts=(sa, sb),
            hi_off=hi_sl.start, lo_off=lo_sl.start, cnt_off=cnt_sl.start,
            M=hi_sl.stop - hi_sl.start,
            ka=(K * KA) & M32, kb=(K * KB) & M32,
        )
        self._dev: dict = {}  # per-device tensors (plain path + kernel tables)
        self._claims: dict = {}  # per-(device, MCAP) kernel claim arrays

    def _tensors(self, dev: torch.device) -> dict:
        key = str(dev)
        t = self._dev.get(key)
        if t is None:
            h = self._host
            t = {k: torch.as_tensor(h[k], dtype=torch.int64, device=dev)
                 for k in ("lanes", "perms", "valmap", "pow2", "inv", "perm", "raw")}
            self._dev[key] = t
        return t

    # ---------------- plain PyTorch version ----------------

    def _tables(self, dev, remap: bool, tsel):
        """The hash tables with a leading [T, 1] (every static permutation,
        or the raw identity when not ``remap``) or [T, B] (``tsel``: T
        permutation indices per lane) pair of axes."""
        t = self._tensors(dev)
        names = ("perm", "valmap", "pow2", "perms")
        if tsel is not None:
            return {"perm": t["perm"][:, tsel], **{n: t[n][tsel] for n in names[1:]}}
        salts = t["perm"] if remap else t["raw"]
        return {"perm": salts[:, :, None], **{n: t[n][:, None] for n in names[1:]}}

    def _hash(self, view: torch.Tensor, remap: bool, tsel=None) -> torch.Tensor:
        """enc fingerprints [T, B] of a [B, VL] view batch under every
        permutation (remap=True), under T permutation indices per lane
        (``tsel`` [T, B]) or the raw identity hash (remap=False, T = 1: no
        value remaps — ``_perm_hash`` of the reference)."""
        h = self._host
        tb = self._tables(view.device, remap, tsel)
        S = self.S
        n_plain, n_val, _ = self._groups
        x = view[:, self._tensors(view.device)["lanes"]].to(torch.int64)  # [B, K]
        pa, pb, xa, xb = tb["perm"]  # [T, 1|B, K] each
        if remap:
            T, B = pa.shape[0], x.shape[0]
            xp = x[:, :n_plain].expand(T, -1, -1)
            v = x[:, n_plain:n_plain + n_val]
            vidx = torch.where((v >= 1) & (v <= S), v, 0)
            valmap = tb["valmap"].expand(T, B, -1)
            xv = valmap.gather(2, vidx.expand(T, -1, -1))
            bm = x[:, n_plain + n_val:]
            xm = sum(((bm >> j) & 1) * tb["pow2"][..., j, None] for j in range(S))
            X = torch.cat([xp, xv, xm.expand(T, -1, -1)], dim=-1)
        else:
            X = x.unsqueeze(0)
        X = X & M32
        ha = mix32((mul32(X ^ xa, KA) + pa) & M32)
        hb = mix32((mul32(X ^ xb, KB) + pb) & M32)
        na = xor_reduce(ha) ^ h["ka"]
        nb = xor_reduce(hb) ^ h["kb"]
        ba, bb = self._bag(view, tb if remap else None)
        return combine_pair(na ^ ba, nb ^ bb)

    def _bag(self, view, tb):
        """Multiset stream pair [T, B] of the message bag, server fields
        remapped through the tables ``tb`` of ``_tables`` (None: raw)."""
        h = self._host
        M = h["M"]
        hi = view[:, h["hi_off"]:h["hi_off"] + M].to(torch.int64)
        lo = view[:, h["lo_off"]:h["lo_off"] + M].to(torch.int64)
        cnt = view[:, h["cnt_off"]:h["cnt_off"] + M].to(torch.int64)
        occ = hi != EMPTY
        words = [lo, hi]  # packer word order: 0 = lo, 1 = hi
        nwords = [lo.unsqueeze(0), hi.unsqueeze(0)]
        if tb is not None:
            S = self.S
            T = tb["perms"].shape[0]
            perms = tb["perms"].expand(T, hi.shape[0], -1)  # [T, B, S]
            for word, shift, mask, kind in h["fields"]:
                val = (words[word] >> shift) & mask
                if kind == MSG_KINDS["server"]:
                    new = torch.where(val < S, perms.gather(
                        2, val.clamp(max=S - 1).expand(T, -1, -1)), 0)
                else:  # server_nil: 0 stays Nil, u maps to sigma[u - 1] + 1
                    new = torch.where((val >= 1) & (val <= S), perms.gather(
                        2, (val - 1).clamp(0, S - 1).expand(T, -1, -1)) + 1, 0)
                nwords[word] = (nwords[word] & ~(mask << shift)) | (new << shift)
        ha = hb = 0
        for w_i, w in enumerate([nwords[1], nwords[0], cnt.unsqueeze(0)]):
            xw = u32(w) ^ h["sx"][w_i]
            ha = ha ^ mix32((mul32(xw, KA) + h["wa"][w_i]) & M32)
            hb = hb ^ mix32((mul32(xw, KB) + h["wb"][w_i]) & M32)
        ha = mix32((ha + KB) & M32)
        hb = mix32((hb + KA) & M32)
        return sum32(torch.where(occ, ha, 0)), sum32(torch.where(occ, hb, 0))

    def raw_fingerprints(self, states: torch.Tensor) -> torch.Tensor:
        """enc [B] identity-permutation view hashes — the memo's raw key
        (and the canonical fingerprint when symmetry is off)."""
        return self._hash(states[:, : self.VL], remap=False)[0]

    def canon_plain(self, states: torch.Tensor) -> torch.Tensor:
        """enc [B] canonical fingerprints: the min over all S! permutations
        (S <= 4) or over the signature-admissible ones (S >= 5)."""
        if not self.symmetry:
            return self.raw_fingerprints(states)
        view = states[:, : self.VL]
        if not self.prune:
            return self._hash(view, remap=True).min(dim=0).values
        # the reference's _masked_min(view, sig), enumerated: each lane
        # hashes under its admissible permutations only (the static tables
        # of those that sort its signatures), lanes grouped by how many they
        # have, in blocks that keep the [c, b, K] temporaries near 2^24 lanes
        ssig = self.signatures_plain(view)[:, self._tensors(view.device)["inv"]]
        adm = (ssig[..., 1:] >= ssig[..., :-1]).all(dim=-1)  # [B, P]
        n_adm = adm.sum(dim=1)
        out = torch.empty(view.shape[0], dtype=torch.int64, device=view.device)
        for c in torch.unique(n_adm).tolist():
            lanes = torch.nonzero(n_adm == c).flatten()
            tsel = torch.nonzero(adm[lanes])[:, 1].reshape(-1, c).T  # [c, b]
            blk = max(1, (1 << 24) // (c * (self._K + self._host["M"])))
            for i in range(0, len(lanes), blk):
                part = lanes[i:i + blk]
                out[part] = self._hash(view[part], True, tsel[:, i:i + blk]).min(dim=0).values
        return out

    # ---------------- signatures (S >= 5) ----------------

    def signatures_plain(self, states: torch.Tensor) -> torch.Tensor:
        """enc [B, S] permutation-equivariant server signatures of a [B, W]
        (or [B, VL]) batch: ``_signatures`` of the reference (:581) with
        REFINE_ROUNDS 1-WL rounds. sig(perm(x))[sigma(i)] == sig(x)[i]."""
        view = states[:, : self.VL].to(torch.int64)
        S, B, dev = self.S, view.shape[0], view.device
        sr = torch.arange(S, device=dev)
        zero = torch.zeros((B, S), dtype=torch.int64, device=dev)
        acc = (zero, zero)

        # ---- round 0: each server's invariant content ----
        val_f, bm_f, pair_f = [], [], []
        for f in self._view_fields:
            off, size = f.offset, f.size
            seg = view[:, off:off + size]
            if f.kind == "per_server":
                rows = seg.reshape(B, S, size // S)
                acc = _padd(acc, _pfold(hash_lanes_pair(rows), _salt(off, 0)))
            elif f.kind == "per_server_val":  # 0 = Nil, i + 1 = server i
                cat = torch.where(seg == 0, 0, torch.where(seg - 1 == sr, 1, 2))
                acc = _padd(acc, _pmix(cat, _salt(off, 1)))
                indeg = ((seg[:, :, None] - 1 == sr) & (seg[:, :, None] > 0)).sum(1)
                acc = _padd(acc, _pmix(indeg, _salt(off, 2)))
                val_f.append((off, seg))
            elif f.kind == "server_bitmask":
                bits = (seg[:, :, None] >> sr) & 1  # [B, i, j]: j in set i
                acc = _padd(acc, _pmix(bits.sum(2) * 2 + ((seg >> sr) & 1), _salt(off, 3)))
                acc = _padd(acc, _pmix(bits.sum(1), _salt(off, 4)))
                bm_f.append((off, bits == 1))
            elif f.kind == "per_server_pair":
                mat = seg.reshape(B, S, S)
                offd = ~torch.eye(S, dtype=torch.bool, device=dev)
                acc = _padd(acc, _pmix(mat.diagonal(dim1=1, dim2=2), _salt(off, 5)))
                acc = _padd(acc, _psum(_pwhere(offd, _pmix(mat, _salt(off, 6)))))
                acc = _padd(acc, _psum(_pwhere(offd, _pmix(mat.transpose(1, 2), _salt(off, 7)))))
                pair_f.append((off, mat))

        # messages, round 0: each record with its server fields zeroed,
        # folded into the servers it references
        h = self._host
        M = h["M"]
        lo = view[:, h["lo_off"]:h["lo_off"] + M]
        hi = view[:, h["hi_off"]:h["hi_off"] + M]
        cnt = view[:, h["cnt_off"]:h["cnt_off"] + M]
        occ = hi != EMPTY
        zw = [lo, hi]  # packer word order: 0 = lo, 1 = hi
        for word, shift, mask, _kind in h["fields"]:
            zw[word] = zw[word] & ~(mask << shift)
        ra = rb = 0
        for w_i, w in enumerate((zw[1], zw[0], cnt)):
            sa, sb = _salt(w_i, 21)
            ra = ra ^ mix32((mul32(u32(w), KA) + sa) & M32)
            rb = rb ^ mix32((mul32(u32(w), KB) + sb) & M32)
        rec0 = (mix32(ra), mix32(rb))
        cnt32 = torch.where(occ, u32(cnt), 0)
        svals = [((lo, hi)[word] >> shift) & mask for word, shift, mask, _k in h["fields"]]
        kinds = [f[3] for f in h["fields"]]
        for k, val in enumerate(svals):
            ck = _pfold(rec0, _salt(k, 8))
            c = (mul32t(cnt32, ck[0]), mul32t(cnt32, ck[1]))
            acc = _padd(acc, self._scatter_by_server(c, val, kinds[k], occ))
        sig = (mix32(acc[0]), mix32(acc[1]))

        # ---- refinement: fold the neighbours' signatures, round by round
        # (every fold salt of round r >= 1 is offset by 32 * r) ----
        for r in range(REFINE_ROUNDS):
            rr = 32 * r
            acc = (zero, zero)
            for off, vals in val_f:
                tgt = (vals - 1).clamp(0, S - 1)
                nsig = (sig[0].gather(1, tgt), sig[1].gather(1, tgt))
                ok = (vals > 0) & (vals - 1 != sr)
                acc = _padd(acc, _pwhere(ok, _pxmix(nsig, _salt(off, 9 + rr))))
            for off, bits in bm_f:
                e = _pxmix(sig, _salt(off, 10 + rr))
                acc = _padd(acc, _psum(_pwhere(bits, (e[0][:, None, :], e[1][:, None, :]))))
            for off, mat in pair_f:
                for m, role in ((u32(mat), 11), (u32(mat.transpose(1, 2)), 12)):
                    sa, sb = _salt(off, role + rr)
                    ea = mix32((mul32(m, KA) + (sig[0] ^ sa)[:, None, :]) & M32)
                    eb = mix32((mul32(m, KB) + (sig[1] ^ sb)[:, None, :]) & M32)
                    acc = _padd(acc, _psum((ea, eb)))
            # per record: fold every referenced server's signature, then
            # give each endpoint the fold over the OTHER endpoints
            folds = [self._gather_sig_fold(sig, val, kinds[k], _salt(k, 13 + rr))
                     for k, val in enumerate(svals)]
            osum = (0, 0)
            for fo in folds:
                osum = _padd(osum, fo)
            for k, val in enumerate(svals):
                sa, sb = _salt(k, 14 + rr)
                c = (mul32t(cnt32, mix32((rec0[0] + osum[0] - folds[k][0] + sa) & M32)),
                     mul32t(cnt32, mix32((rec0[1] + osum[1] - folds[k][1] + sb) & M32)))
                acc = _padd(acc, self._scatter_by_server(c, val, kinds[k], occ))
            sig = (mix32((sig[0] + mix32(acc[0])) & M32),
                   mix32((sig[1] + mix32(acc[1])) & M32))
        return combine_pair(*sig)

    def _scatter_by_server(self, c, val, kind, occ):
        """Sum [B, M] stream-pair contributions of the occupied slots onto
        the server a message field names (by its kind) -> [B, S] pair."""
        srv = torch.arange(self.S, device=val.device)[None, :, None]
        if kind == MSG_KINDS["server"]:
            hit = val[:, None, :] == srv
        else:  # server_nil: u > 0 names server u - 1
            hit = (val[:, None, :] - 1 == srv) & (val[:, None, :] > 0)
        hit = hit & occ[:, None, :]
        return _psum(_pwhere(hit, (c[0][:, None, :], c[1][:, None, :])))

    def _gather_sig_fold(self, sig, val, kind, salt):
        """The signature of the server a [B, M] message field names, folded
        under ``salt`` into a per-slot stream pair (0 for a Nil
        server_nil field)."""
        idx = val if kind == MSG_KINDS["server"] else val - 1
        idx = idx.clamp(0, self.S - 1)
        fold = _pxmix((sig[0].gather(1, idx), sig[1].gather(1, idx)), salt)
        return fold if kind == MSG_KINDS["server"] else _pwhere(val > 0, fold)

    def signatures(self, states: torch.Tensor) -> torch.Tensor:
        """enc [B, S] server signatures of a [B, W] int32 batch: the
        ``canon_signatures`` launcher on CUDA tensors, ``signatures_plain``
        on CPU tensors."""
        if kernels.route(states) == "cpu":
            return self.signatures_plain(states)
        k = kernels.CANON_SIGNATURES
        kernels.require(states, torch.int32, "states", ndim=2)
        B, W = states.shape
        hspec, spec = self._tier_table(states.device)
        out = torch.empty((B, self.S), dtype=torch.int64, device=states.device)
        rc = k.lib.canon_signatures(ctypes.cast(hspec, ctypes.c_void_p), spec.data_ptr(),
                                    spec.numel(), states.data_ptr(), B, W, out.data_ptr(),
                                    kernels.stream(states.device))
        k.launched(rc)
        return out

    def fingerprints(self, states: torch.Tensor) -> torch.Tensor:
        """Canonical enc fingerprints of a [B, W] batch (no memo)."""
        if states.device.type == "cuda":
            memo = torch.full((1, 2), INT64_MAX, dtype=torch.int64,
                              device=states.device)
            valid = torch.ones(states.shape[0], dtype=torch.bool,
                               device=states.device)
            return self.fingerprints_memo(states, valid, memo)[0]
        return self.canon_plain(states)

    def fingerprints_memo_plain(self, states, valid, memo):
        """Plain PyTorch version of the ``canon_memo`` and ``canon_tiered``
        kernels.

        ``memo`` is an int64 [MCAP, 2] direct-mapped table of (raw key,
        canonical fingerprint) enc rows, empty rows keyed INT64_MAX; it
        is updated IN PLACE. A lane hits when its row's key equals its
        raw key; a missed valid lane computes its canonical fingerprint
        and claims its slot, the highest lane index winning, and only
        the winner writes its whole row (so no row is ever torn).
        Returns (fps [B] with invalid lanes INT64_MAX, n_hit 0-d)."""
        raw = self.raw_fingerprints(states)
        if not self.symmetry:
            return (torch.where(valid, raw, INT64_MAX),
                    torch.zeros((), dtype=torch.int64, device=states.device))
        B = states.shape[0]
        MCAP = memo.shape[0]
        slot = memo_slot(raw, MCAP)
        row = memo[slot]
        hit = valid & (row[:, 0] == raw) & (raw != INT64_MAX)
        need = valid & ~hit
        idx = torch.nonzero(need).flatten()
        canon = torch.full((B,), INT64_MAX, dtype=torch.int64, device=states.device)
        if len(idx):
            canon[idx] = self.canon_plain(states[idx])
        fps = torch.where(hit, row[:, 1], canon)
        lane = torch.arange(B, device=states.device)
        claim = torch.full((MCAP,), -1, dtype=torch.int64, device=states.device)
        claim.scatter_reduce_(0, slot[idx], lane[idx], reduce="amax")
        win = need & (claim[slot] == lane)
        memo[slot[win]] = torch.stack([raw, fps], dim=1)[win]
        return fps, hit.sum()

    # ---------------- the CUDA kernel ----------------

    def _kernel_tables(self, dev: torch.device):
        """(host int32 params, device int32 table buffer) of the kernel:
        see csrc/canon_memo.cu for the layout."""
        key = ("kernel", str(dev))
        got = self._dev.get(key)
        if got is None:
            h = self._host
            S, P, K = self.S, self.P, self._K
            params = [S, P, K, *self._groups, h["hi_off"], h["lo_off"],
                      h["cnt_off"], h["M"], int(self.symmetry), len(h["fields"]),
                      h["ka"], h["kb"], *h["wa"], *h["wb"], *h["sx"], self.VL]
            for f in h["fields"]:
                params += list(f)
            pa, pb, xa, xb = h["perm"]
            rpa, rpb, rxa, rxb = h["raw"]
            buf = np.concatenate([
                h["lanes"], pa.ravel(), pb.ravel(), xa.ravel(), xb.ravel(),
                rpa.ravel(), rpb.ravel(), rxa.ravel(), rxb.ravel(),
                h["valmap"].ravel(), h["pow2"].ravel(), h["perms"].ravel(),
            ]).astype(np.uint32).view(np.int32)
            hp = (ctypes.c_int * len(params))(
                *np.asarray(params, np.uint32).view(np.int32).tolist())
            got = (hp, torch.as_tensor(buf, device=dev))
            self._dev[key] = got
        return got

    def tier_spec(self) -> np.ndarray:
        """The int32 spec vector of csrc/canon_tiers.cuh: the TIER_HEADER
        scalars, then per message server field (word, shift, mask, kind), per
        signature field (kind, offset, size) and per non-bag lane (view
        lane, c0, s1, m1, s2, m2) in group order (plain, val, bm)."""
        h = self._host
        S = self.S
        sig = [(SIG_KINDS[f.kind], f.offset, f.size) for f in self._view_fields
               if f.kind in SIG_KINDS]
        fields = h["fields"]
        off_fields = len(TIER_HEADER)
        off_sig = off_fields + 4 * len(fields)
        off_lanes = off_sig + 3 * len(sig)
        total = off_lanes + 6 * self._K
        hdr = dict(
            S=S, VL=self.VL, K=self._K, n_plain=self._groups[0], n_val=self._groups[1],
            n_bm=self._groups[2], hi_off=h["hi_off"], lo_off=h["lo_off"],
            cnt_off=h["cnt_off"], M=h["M"], n_fields=len(fields), n_sig=len(sig),
            rounds=REFINE_ROUNDS, ka=h["ka"], kb=h["kb"], seeded=int(bool(self.seed)),
            seed_a=h["seed_salts"][0], seed_b=h["seed_salts"][1], sx0=h["sx"][0],
            sx1=h["sx"][1], sx2=h["sx"][2], off_fields=off_fields, off_sig=off_sig,
            off_lanes=off_lanes, len=total)
        vec = np.concatenate([
            np.array([hdr[n] for n in TIER_HEADER], np.int64),
            np.array(fields, np.int64).reshape(-1), np.array(sig, np.int64).reshape(-1),
            self._lane_desc.reshape(-1)])
        assert len(vec) == total
        return (vec & M32).astype(np.uint32).view(np.int32)

    def _tier_table(self, dev: torch.device):
        """(host ctypes copy, device tensor) of the spec vector."""
        key = ("tier", str(dev))
        got = self._dev.get(key)
        if got is None:
            spec = self.tier_spec()
            got = ((ctypes.c_int * len(spec))(*spec.tolist()),
                   torch.as_tensor(spec, device=dev))
            self._dev[key] = got
        return got

    def fingerprints_memo_cuda(self, states, valid, memo):
        """Launch ``canon_memo`` (csrc/canon_memo.cu; S <= 4 or no
        symmetry) or ``canon_tiered`` (csrc/canon_tiered.cu; S >= 5) on
        CUDA tensors: the same contract as ``fingerprints_memo_plain``."""
        k = kernels.CANON_TIERED if self.prune else kernels.CANON_MEMO
        B, W = states.shape
        kernels.require(states, torch.int32, "states", ndim=2)
        kernels.require(valid, torch.bool, "valid", shape=(B,))
        kernels.require(memo, torch.int64, "memo", ndim=2)
        MCAP = memo.shape[0]
        if memo.shape[1] != 2 or MCAP & (MCAP - 1):
            raise ValueError("memo must be [MCAP, 2] with MCAP a power of two")
        dev = states.device
        ck = (str(dev), MCAP)
        claim = self._claims.get(ck)
        if claim is None:
            claim = torch.full((MCAP,), -1, dtype=torch.int32, device=dev)
            self._claims[ck] = claim
        fps = torch.empty(B, dtype=torch.int64, device=dev)
        raw = torch.empty(B, dtype=torch.int64, device=dev)
        slot = torch.empty(B, dtype=torch.int32, device=dev)
        n_hit = torch.zeros((), dtype=torch.int64, device=dev)
        args = (states.data_ptr(), B, W, valid.data_ptr(), memo.data_ptr(), MCAP,
                claim.data_ptr(), fps.data_ptr(), raw.data_ptr(), slot.data_ptr(),
                n_hit.data_ptr(), kernels.stream(dev))
        if self.prune:
            hspec, spec = self._tier_table(dev)
            rc = k.lib.canon_tiered(ctypes.cast(hspec, ctypes.c_void_p), spec.data_ptr(),
                                    spec.numel(), *args)
        else:
            hp, buf = self._kernel_tables(dev)
            rc = k.lib.canon_memo(ctypes.cast(hp, ctypes.c_void_p), len(hp), buf.data_ptr(),
                                  buf.numel() * 4, *args)
        k.launched(rc)
        return fps, n_hit

    def fingerprints_memo(self, states, valid, memo):
        """Memoized canonical fingerprints of a [B, W] int32 state batch:
        the ``canon_memo`` (S <= 4) or ``canon_tiered`` (S >= 5) kernel on
        CUDA tensors, their plain version on CPU tensors. Returns (fps [B]
        enc, n_hit 0-d int64); ``memo`` is updated in place."""
        kind = kernels.route(states)
        if kind == "cuda":
            return self.fingerprints_memo_cuda(states, valid, memo)
        return self.fingerprints_memo_plain(states, valid, memo)

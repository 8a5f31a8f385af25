"""VIEW projection + SYMMETRY reduction + fingerprinting, layout-driven.

Counterpart of ``raft_tpu/ops/symmetry.py`` (fingerprint formula v5,
hashv=5) for layouts with at most four servers, where the reference's
canonical fingerprint is the plain min over all S! server permutations
of the permuted view's hash (``_masked_min(view, None)``, :1017); the
signature tiers the reference uses from S = 5 up are not ported yet.

The hash of a permuted view is never materialized: non-bag lanes hash
positionally, so a permutation moves positional salts (``_build_direct``
tables, :490) and remaps server-valued lanes and bitmasks; the message
bag hashes as a multiset whose server fields are remapped in place
(``_bag_streams``, :823): XOR over the non-bag lanes, ADDITION mod 2^32
over the occupied bag slots.

``fingerprints_memo`` is the main path: on a CUDA tensor it launches the
``canon_memo`` kernel (csrc/canon_memo.cu); on a CPU tensor it runs the
plain PyTorch version below. Both probe and fill the same direct-mapped
memo table and return bit-identical fingerprints.
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


def permute_states(layout, packer, states: np.ndarray, sigma) -> np.ndarray:
    """Apply the server permutation ``sigma`` (old server i -> new index
    sigma[i]) to a [B, W] numpy state batch: server rows move, server
    values and bitmasks remap, message endpoints remap and the bag slots
    re-sort. A symmetric canonicalization gives the result the same
    fingerprint as the input."""
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
    for name in ("msource", "mdest"):
        val = packer.unpack(hi, lo, name)
        hi2, lo2 = packer.replace(hi, lo, name, sigma[val])
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
    states and the tests."""

    MAX_SERVERS = 4

    @classmethod
    def for_model(cls, model, symmetry: bool = True, seed: int = 0):
        return cls(model.layout, model.packer, symmetry=symmetry, seed=seed)

    def __init__(self, layout, packer, symmetry: bool = True, seed: int = 0):
        S = layout.n_servers
        if symmetry and S > self.MAX_SERVERS:
            raise NotImplementedError(
                f"symmetry reduction for {S} servers needs the signature-"
                "tiered canonicalization (raft_tpu ops/symmetry.py "
                "_signatures/_tier_pre/_tier3_*), which raft_tpu_torch has "
                "not ported yet (a later slice of the port)"
            )
        VL = layout.view_len
        self.layout, self.packer = layout, packer
        self.symmetry, self.seed = symmetry, seed
        self.S, self.VL = S, VL
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

        # permuted positional salts: outpos[t, j] = hash position that
        # source nonbag lane j lands at under perms[t] (_build_direct)
        gidx = self._np_gidx(perms, view_fields)
        src = nb_inv[gidx[:, nb]]  # [P, K]
        outpos = np.empty((self.P, K), np.int64)
        outpos[np.repeat(np.arange(self.P), K), src.reshape(-1)] = np.tile(
            np.arange(K), self.P)
        op = outpos[:, nb_inv[lanes]]  # [P, K] in group order
        rp = nb_inv[lanes][None, :]  # raw positions [1, K]
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
        fields = []  # server-valued fields inside a message key
        for name in ("msource", "mdest"):
            word, shift, mask = packer.locate(name)
            fields.append((word, shift, mask))
        self._host = dict(
            lanes=lanes, perms=perms, valmap=valmap,
            pow2=(1 << perms),
            perm=np.stack(salts(op)), raw=np.stack(salts(rp)),
            wa=wa, wb=wb, sx=sx, fields=fields,
            hi_off=hi_sl.start, lo_off=lo_sl.start, cnt_off=cnt_sl.start,
            M=hi_sl.stop - hi_sl.start,
            ka=(K * KA) & M32, kb=(K * KB) & M32,
        )
        self._dev: dict = {}  # per-device tensors (plain path + kernel tables)
        self._claims: dict = {}  # per-(device, MCAP) kernel claim arrays

    @staticmethod
    def _np_gidx(perms: np.ndarray, view_fields) -> np.ndarray:
        """[P, VL] lane-gather table: permuted[l] = view[gidx[t, l]]."""
        T, S = perms.shape
        VL = sum(f.size for f in view_fields)
        inv = np.argsort(perms, axis=1)
        gidx = np.tile(np.arange(VL, dtype=np.int64), (T, 1))
        for f in view_fields:
            off, size = f.offset, f.size
            if f.kind in ("per_server", "per_server_val", "server_bitmask"):
                rest = size // S
                base = off + inv[:, :, None] * rest + np.arange(rest)
                gidx[:, off:off + size] = base.reshape(T, -1)
            elif f.kind == "per_server_pair":
                src = off + inv[:, :, None] * S + inv[:, None, :]
                gidx[:, off:off + size] = src.reshape(T, -1)
        return gidx

    def _tensors(self, dev: torch.device) -> dict:
        key = str(dev)
        t = self._dev.get(key)
        if t is None:
            h = self._host
            t = {k: torch.as_tensor(h[k], dtype=torch.int64, device=dev)
                 for k in ("lanes", "perms", "valmap", "pow2", "perm", "raw")}
            self._dev[key] = t
        return t

    # ---------------- plain PyTorch version ----------------

    def _hash(self, view: torch.Tensor, remap: bool) -> torch.Tensor:
        """enc fingerprints [T, B] of a [B, VL] view batch under every
        permutation (remap=True) or the raw identity hash (remap=False,
        T = 1: no value remaps — ``_perm_hash`` of the reference)."""
        h, t = self._host, self._tensors(view.device)
        S = self.S
        n_plain, n_val, _ = self._groups
        x = view[:, t["lanes"]].to(torch.int64)  # [B, K]
        pa, pb, xa, xb = t["perm"] if remap else t["raw"]  # [T, K] each
        T = pa.shape[0]
        if remap:
            xp = x[:, :n_plain].expand(T, -1, -1)
            v = x[:, n_plain:n_plain + n_val]
            xv = t["valmap"][:, torch.where((v >= 1) & (v <= S), v, 0)]
            bm = x[:, n_plain + n_val:]
            xm = sum(((bm >> j) & 1) * t["pow2"][:, j, None, None] for j in range(S))
            X = torch.cat([xp, xv, xm if S else bm.expand(T, -1, -1)], dim=-1)
        else:
            X = x.unsqueeze(0)
        X = X & M32
        ha = mix32((mul32(X ^ xa[:, None, :], KA) + pa[:, None, :]) & M32)
        hb = mix32((mul32(X ^ xb[:, None, :], KB) + pb[:, None, :]) & M32)
        na = xor_reduce(ha) ^ h["ka"]
        nb = xor_reduce(hb) ^ h["kb"]
        ba, bb = self._bag(view, remap)
        return combine_pair(na ^ ba, nb ^ bb)

    def _bag(self, view, remap: bool):
        """Multiset stream pair [T, B] of the message bag, server fields
        remapped per permutation when ``remap``."""
        h, t = self._host, self._tensors(view.device)
        M = h["M"]
        hi = view[:, h["hi_off"]:h["hi_off"] + M].to(torch.int64)
        lo = view[:, h["lo_off"]:h["lo_off"] + M].to(torch.int64)
        cnt = view[:, h["cnt_off"]:h["cnt_off"] + M].to(torch.int64)
        occ = hi != EMPTY
        words = [lo, hi]  # packer word order: 0 = lo, 1 = hi
        nwords = [lo.unsqueeze(0), hi.unsqueeze(0)]
        if remap:
            for word, shift, mask in h["fields"]:
                val = (words[word] >> shift) & mask
                new = torch.where(
                    val < self.S, t["perms"][:, val.clamp(max=self.S - 1)], 0)
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
        """enc [B] canonical fingerprints: min over all S! permutations."""
        if not self.symmetry:
            return self.raw_fingerprints(states)
        return self._hash(states[:, : self.VL], remap=True).min(dim=0).values

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
        """Plain PyTorch version of the ``canon_memo`` kernel.

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

    def fingerprints_memo_cuda(self, states, valid, memo):
        """Launch ``canon_memo`` (csrc/canon_memo.cu) on CUDA tensors:
        the same contract as ``fingerprints_memo_plain``."""
        k = kernels.CANON_MEMO
        B, W = states.shape
        kernels.require(states, torch.int32, "states", ndim=2)
        kernels.require(valid, torch.bool, "valid", shape=(B,))
        kernels.require(memo, torch.int64, "memo", ndim=2)
        MCAP = memo.shape[0]
        if memo.shape[1] != 2 or MCAP & (MCAP - 1):
            raise ValueError("memo must be [MCAP, 2] with MCAP a power of two")
        dev = states.device
        hp, buf = self._kernel_tables(dev)
        ck = (str(dev), MCAP)
        claim = self._claims.get(ck)
        if claim is None:
            claim = torch.full((MCAP,), -1, dtype=torch.int32, device=dev)
            self._claims[ck] = claim
        fps = torch.empty(B, dtype=torch.int64, device=dev)
        raw = torch.empty(B, dtype=torch.int64, device=dev)
        slot = torch.empty(B, dtype=torch.int32, device=dev)
        n_hit = torch.zeros((), dtype=torch.int64, device=dev)
        rc = k.lib.canon_memo(
            ctypes.cast(hp, ctypes.c_void_p), len(hp), buf.data_ptr(), buf.numel() * 4,
            states.data_ptr(), B, W, valid.data_ptr(), memo.data_ptr(),
            MCAP, claim.data_ptr(), fps.data_ptr(), raw.data_ptr(),
            slot.data_ptr(), n_hit.data_ptr(), kernels.stream(dev),
        )
        k.launched(rc)
        return fps, n_hit

    def fingerprints_memo(self, states, valid, memo):
        """Memoized canonical fingerprints of a [B, W] int32 state batch:
        the ``canon_memo`` kernel on CUDA tensors, its plain version on
        CPU tensors. Returns (fps [B] enc, n_hit 0-d int64); ``memo`` is
        updated in place."""
        kind = kernels.route(states)
        if kind == "cuda":
            return self.fingerprints_memo_cuda(states, valid, memo)
        return self.fingerprints_memo_plain(states, valid, memo)

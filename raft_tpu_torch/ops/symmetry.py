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
whose server fields are remapped in place by kind (``_bag_streams``, :823:
a server index, a Nil-able one, a member-set bitmask): XOR over the
non-bag lanes, ADDITION mod 2^32 over the occupied bag slots, a slot
hashing its key words in sort order and its count, salted by stream
index ((hi, lo, count) for the 2-word bags; (w0 .. w{N-1}, count) for the
reconfiguration specs' N-word bags, :541-560).

The signatures read a server-valued or member-set field as one lane a
server (the reference's ``_signatures`` raises on any other size). The
reconfiguration specs hold such fields with r > 1 lanes a server (a log
entry's member set or Nil-able server, r log slots), and five of their
servers take the admissible min: there a field of r lanes a server is
signed as r one-lane fields, the c-th holding lane c of each server's row
under the salt offset off + c * S (``split_fields``). Where every such
field has one lane a server this is the reference's formula, bit for bit.

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
REFINE_ROUNDS = 3  # 1-WL refinement depth of the signatures (wl=3)
PRUNE_FROM = 5  # layouts with this many servers take the admissible min
# the server fields of a message key and how each remaps under a
# permutation (the reference's msg_perm_spec, raft_tpu/ops/symmetry.py:
# 333-343): "server" is a plain index (msource, mdest), "server_nil" is
# 0 = Nil or i + 1 = server i (KRaft's mleader), "server_bitmask" a set of
# servers whose bit j moves to bit sigma[j] (the reconfiguration specs'
# member sets). The field order is part of the fingerprint (the signatures
# salt field k by k).
MSG_SERVER_FIELDS = ("msource", "mdest")
DEFAULT_SPEC = tuple((f, "server") for f in MSG_SERVER_FIELDS)
MSG_KINDS = {"server": 0, "server_nil": 1, "server_bitmask": 2}  # codes shared with csrc/canon_*
MAX_MSG_FIELDS = 32  # csrc/canon_tiers.cuh CT_MAX_FIELDS
MAX_BAG_WORDS = 8  # csrc/canon_tiers.cuh CT_MAX_WORDS
# codes shared with csrc/canon_tiers.cuh
SIG_KINDS = {"per_server": 0, "per_server_val": 1, "server_bitmask": 2,
             "per_server_pair": 3}
TIER_HEADER = ("S", "VL", "K", "n_plain", "n_val", "n_bm", "n_words", "general",
               "cnt_off", "M", "n_fields", "n_sig", "rounds", "ka", "kb", "seeded",
               "seed_a", "seed_b", "off_words", "off_fields", "off_sig", "off_lanes", "len")
MAX_TIER_SERVERS = 8  # csrc/canon_tiers.cuh CT_MAX_S
TIER_FAST_FIELDS = 4  # csrc/canon_tiers.cuh CT_FAST_FIELDS: the 2-word path's message fields


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
    maps to 0 and a bitmask keeps only its S low bits, as the reference's
    one-hot sums give."""
    if kind == "server":
        return np.where((val >= 0) & (val < S), sigma[np.clip(val, 0, S - 1)], 0)
    if kind == "server_bitmask":
        return sum(((val >> j) & 1) << int(sigma[j]) for j in range(S))
    return np.where((val >= 1) & (val <= S), sigma[np.clip(val - 1, 0, S - 1)] + 1, 0)


def bag_streams(layout) -> tuple[list[str], int]:
    """(the bag's key-word field names in hash-stream order, the number of
    packer words): ["msg_hi", "msg_lo"] for a 2-word BitPacker bag (hi is
    word 1 and sorts first), the msg_word fields for an N-word one (word 0
    first, as its slots sort). The count is the last stream."""
    from ..models.base import msg_word_fields

    wide = msg_word_fields(layout)
    return (wide, len(wide)) if wide else (["msg_hi", "msg_lo"], 2)


def stream_of_word(word: int, n_words: int, wide: bool) -> int:
    """The hash stream of a packer word: a 2-word bag's streams are (hi,
    lo), its packer words (lo, hi)."""
    return word if wide else n_words - 1 - word


def split_fields(view_fields, S: int) -> list[tuple[str, int, np.ndarray]]:
    """The signature fields of a layout's view fields, in offset order:
    (kind, salt offset, view lanes). A per_server field's lanes are its
    [S, r] rows, a pair field's its [S, S] matrix; a per_server_val or
    server_bitmask field of r lanes a server becomes r one-lane fields,
    the c-th holding lane c of each server's row (off + i * r + c) under
    the salt offset off + c * S."""
    out = []
    for f in view_fields:
        if f.kind not in SIG_KINDS:
            continue
        if f.kind in ("per_server_val", "server_bitmask"):
            r = f.size // S
            out += [(f.kind, f.offset + c * S, f.offset + np.arange(S) * r + c)
                    for c in range(r)]
        else:
            out.append((f.kind, f.offset, f.offset + np.arange(f.size)))
    return out


def permute_states(layout, packer, states: np.ndarray, sigma, spec=DEFAULT_SPEC) -> np.ndarray:
    """Apply the server permutation ``sigma`` (old server i -> new index
    sigma[i]) to a [B, W] numpy state batch: server rows move, server
    values and bitmasks remap, the message fields of ``spec`` ((field,
    kind) pairs, ``msg_perm_spec``) remap and the bag slots re-sort (an
    N-word bag lexicographically from word 0). A symmetric
    canonicalization gives the result the same fingerprint as the
    input."""
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
    names, n_words = bag_streams(layout)
    wide = names[0] != "msg_hi"
    streams = [layout.get(out, n).copy() for n in names]
    cnt = layout.get(out, "msg_cnt").copy()
    occ = streams[0] != EMPTY
    for name, kind in _checked_spec(spec):
        word, shift, mask = packer.locate(name)
        k = stream_of_word(word, n_words, wide)
        val = (streams[k] >> shift) & mask
        new = (streams[k] & ~(mask << shift)) | (_remap_np(val, kind, sigma, S) << shift)
        streams[k] = np.where(occ, new, streams[k])
    order = np.lexsort(tuple(streams[::-1]), axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    for n, w in zip(names, streams):
        out[:, layout.sl(n)] = take(w)
    out[:, layout.sl("msg_cnt")] = take(cnt)
    return out


class Canonicalizer:
    """Canonical (VIEW + SYMMETRY) fingerprints of packed Raft states.

    ``fingerprints_memo(states, valid, memo)`` is the engine's call; see
    the module docstring. ``fingerprints`` (no memo) serves the initial
    states and the tests. A message key's server fields and their kinds
    are ``spec`` (``msg_perm_spec``)."""

    refine_rounds = REFINE_ROUNDS  # the wl= of a checkpoint's ident

    @classmethod
    def for_model(cls, model, symmetry: bool = True, seed: int = 0):
        """The model's own canonicalizer where it defines one
        (``make_canonicalizer``: KRaftWithReconfig's data-dependent slot
        canon, which has ``fingerprints`` and no memo), else this class
        over the model's layout and message-field kinds."""
        if hasattr(model, "make_canonicalizer"):
            return model.make_canonicalizer(symmetry, seed=seed)
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
        bag_kinds = ("msg_hi", "msg_lo", "msg_cnt", "msg_word")
        stream_names, n_words = bag_streams(layout)
        wide = stream_names[0] != "msg_hi"
        if n_words > MAX_BAG_WORDS or len(self.spec) > MAX_MSG_FIELDS:
            raise NotImplementedError(
                f"canon_memo takes at most {MAX_BAG_WORDS} key words and {MAX_MSG_FIELDS} "
                f"message remap fields (got {n_words} and {len(self.spec)})")
        bag_lanes = set()
        val_lanes, bm_lanes = set(), set()
        for f in view_fields:
            lanes = range(f.offset, f.offset + f.size)
            if f.kind in bag_kinds:
                bag_lanes |= set(lanes)
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
        self._sig_fields = split_fields(view_fields, S)
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
        # the bag's hash streams: its key words in sort order, then the
        # count, each salted by its stream index (the reference's
        # [*words, cnt], symmetry.py:541-560)
        wa, wb, sx = [], [], []
        for w_i in range(n_words + 1):
            a, b = _salt(w_i, 20)
            wa.append(a)
            wb.append(b)
            sx.append(_host_mix64(w_i * _C2 + seed) & M32 if seed else 0)
        stream_offs = [layout.fields[n].offset for n in stream_names]
        cnt_sl = layout.sl("msg_cnt")
        # (packer word, shift, mask, kind code) of each message server
        # field, and the stream each field's word hashes in
        fields = [(*packer.locate(name), MSG_KINDS[kind]) for name, kind in self.spec]
        self._host = dict(
            lanes=lanes, perms=perms, valmap=valmap,
            pow2=(1 << perms), inv=np.argsort(perms, axis=1),
            perm=np.stack(salts(op)), raw=np.stack(salts(rp)),
            wa=wa, wb=wb, sx=sx, fields=fields,
            field_streams=[stream_of_word(f[0], n_words, wide) for f in fields],
            seed_salts=(sa, sb), stream_offs=stream_offs, cnt_off=cnt_sl.start,
            M=cnt_sl.stop - cnt_sl.start,
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
        words = [view[:, o:o + M].to(torch.int64) for o in h["stream_offs"]]
        cnt = view[:, h["cnt_off"]:h["cnt_off"] + M].to(torch.int64)
        occ = words[0] != EMPTY
        nwords = [w.unsqueeze(0) for w in words]
        if tb is not None:
            S = self.S
            T = tb["perms"].shape[0]
            perms = tb["perms"].expand(T, words[0].shape[0], -1)  # [T, B, S]
            for (_w, shift, mask, kind), k in zip(h["fields"], h["field_streams"]):
                val = (words[k] >> shift) & mask
                if kind == MSG_KINDS["server"]:
                    new = torch.where(val < S, perms.gather(
                        2, val.clamp(max=S - 1).expand(T, -1, -1)), 0)
                elif kind == MSG_KINDS["server_nil"]:  # 0 stays Nil, u -> sigma[u - 1] + 1
                    new = torch.where((val >= 1) & (val <= S), perms.gather(
                        2, (val - 1).clamp(0, S - 1).expand(T, -1, -1)) + 1, 0)
                else:  # server_bitmask: bit j moves to bit sigma[j]
                    new = sum(((val >> j) & 1) * tb["pow2"][..., j, None] for j in range(S))
                nwords[k] = (nwords[k] & ~(mask << shift)) | (new << shift)
        ha = hb = 0
        for w_i, w in enumerate([*nwords, cnt.unsqueeze(0)]):
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
        REFINE_ROUNDS 1-WL rounds over the fields of ``split_fields``.
        sig(perm(x))[sigma(i)] == sig(x)[i]."""
        view = states[:, : self.VL].to(torch.int64)
        S, B, dev = self.S, view.shape[0], view.device
        sr = torch.arange(S, device=dev)
        zero = torch.zeros((B, S), dtype=torch.int64, device=dev)
        acc = (zero, zero)

        # ---- round 0: each server's invariant content ----
        val_f, bm_f, pair_f = [], [], []
        for kind, off, lanes in self._sig_fields:
            seg = view[:, torch.as_tensor(lanes, device=dev)]
            if kind == "per_server":
                rows = seg.reshape(B, S, -1)
                acc = _padd(acc, _pfold(hash_lanes_pair(rows), _salt(off, 0)))
            elif kind == "per_server_val":  # 0 = Nil, i + 1 = server i
                cat = torch.where(seg == 0, 0, torch.where(seg - 1 == sr, 1, 2))
                acc = _padd(acc, _pmix(cat, _salt(off, 1)))
                indeg = ((seg[:, :, None] - 1 == sr) & (seg[:, :, None] > 0)).sum(1)
                acc = _padd(acc, _pmix(indeg, _salt(off, 2)))
                val_f.append((off, seg))
            elif kind == "server_bitmask":
                bits = (seg[:, :, None] >> sr) & 1  # [B, i, j]: j in set i
                acc = _padd(acc, _pmix(bits.sum(2) * 2 + ((seg >> sr) & 1), _salt(off, 3)))
                acc = _padd(acc, _pmix(bits.sum(1), _salt(off, 4)))
                bm_f.append((off, bits == 1))
            else:  # per_server_pair
                mat = seg.reshape(B, S, S)
                offd = ~torch.eye(S, dtype=torch.bool, device=dev)
                acc = _padd(acc, _pmix(mat.diagonal(dim1=1, dim2=2), _salt(off, 5)))
                acc = _padd(acc, _psum(_pwhere(offd, _pmix(mat, _salt(off, 6)))))
                acc = _padd(acc, _psum(_pwhere(offd, _pmix(mat.transpose(1, 2), _salt(off, 7)))))
                pair_f.append((off, mat))

        # messages, round 0: each record with its server fields zeroed
        # (its key words in stream order, then the count), folded into the
        # servers it references
        h = self._host
        M = h["M"]
        words = [view[:, o:o + M] for o in h["stream_offs"]]
        cnt = view[:, h["cnt_off"]:h["cnt_off"] + M]
        occ = words[0] != EMPTY
        zw = list(words)
        for (_w, shift, mask, _kind), k in zip(h["fields"], h["field_streams"]):
            zw[k] = zw[k] & ~(mask << shift)
        ra = rb = 0
        for w_i, w in enumerate([*zw, cnt]):
            sa, sb = _salt(w_i, 21)
            ra = ra ^ mix32((mul32(u32(w), KA) + sa) & M32)
            rb = rb ^ mix32((mul32(u32(w), KB) + sb) & M32)
        rec0 = (mix32(ra), mix32(rb))
        cnt32 = torch.where(occ, u32(cnt), 0)
        svals = [(words[k] >> shift) & mask
                 for (_w, shift, mask, _kind), k in zip(h["fields"], h["field_streams"])]
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
        the servers a message field names (by its kind: one server, none
        for a Nil Nil-able field, each member of a member set) -> [B, S]
        pair."""
        srv = torch.arange(self.S, device=val.device)[None, :, None]
        if kind == MSG_KINDS["server"]:
            hit = val[:, None, :] == srv
        elif kind == MSG_KINDS["server_nil"]:  # u > 0 names server u - 1
            hit = (val[:, None, :] - 1 == srv) & (val[:, None, :] > 0)
        else:  # server_bitmask: every server whose bit is set
            hit = ((val[:, None, :] >> srv) & 1) == 1
        hit = hit & occ[:, None, :]
        return _psum(_pwhere(hit, (c[0][:, None, :], c[1][:, None, :])))

    def _gather_sig_fold(self, sig, val, kind, salt):
        """The signatures of the servers a [B, M] message field names,
        folded under ``salt`` into a per-slot stream pair: the one server's
        (its index clamped into range), 0 for a Nil Nil-able field, the
        multiset sum over a member set's servers."""
        if kind == MSG_KINDS["server_bitmask"]:
            bits = ((val[:, :, None] >> torch.arange(self.S, device=val.device)) & 1) == 1
            e = _pxmix(sig, salt)
            return _psum(_pwhere(bits, (e[0][:, None, :], e[1][:, None, :])))
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

    # ---------------- the CUDA kernels ----------------

    def tier_general(self) -> bool:
        """Whether csrc/canon_tiers.cuh takes its general path (N-word keys,
        up to 32 message fields of any kind, fields of r > 1 lanes a server)
        rather than the 2-word one (hi/lo keys, at most 4 plain or Nil-able
        message fields, one lane a server) for canon_tiered."""
        return self.memo_general() or any(
            f.kind in ("per_server_val", "server_bitmask") and f.size > self.S
            for f in self._view_fields)

    def memo_general(self) -> bool:
        """Whether canon_memo takes its general build: the hash alone
        (no signatures) takes the 2-word one for hi/lo keys with at most 4
        plain or Nil-able message fields, whatever the view's fields."""
        h = self._host
        return (len(h["stream_offs"]) != 2 or len(h["fields"]) > TIER_FAST_FIELDS
                or any(f[3] == MSG_KINDS["server_bitmask"] for f in h["fields"]))

    def tier_spec(self, memo: bool = False) -> np.ndarray:
        """The int32 spec vector of csrc/canon_tiers.cuh (``memo``: for
        canon_memo, whose ``general`` is ``memo_general``): the TIER_HEADER
        scalars; at ``off_words`` the key words' slot offsets in stream
        order, then the N + 1 stream xors of the seeded bag hash (count
        last); per message server field (stream, shift, mask, kind); per
        signature field of ``split_fields`` (kind + 16 * n, salt offset,
        first lane), n a per_server field's lanes a server or a
        server-valued or member-set field's lane stride (its lane of server
        i is first + i * n); per non-bag lane (view lane, c0, s1, m1, s2, m2)
        in group order (plain, val, bm). Three ints a signature field keep
        the 2-word layouts' blocks of 32 staged rows at five an SM."""
        h = self._host
        S = self.S
        sig = []
        for kind, off, lanes in self._sig_fields:
            if kind == "per_server":
                n = len(lanes) // S
            elif kind == "per_server_pair":
                n = S
            else:
                n = int(lanes[1] - lanes[0]) if len(lanes) > 1 else 1
            sig.append((SIG_KINDS[kind] + 16 * n, off, int(lanes[0])))
        fields = [(k, shift, mask, kind)
                  for (_w, shift, mask, kind), k in zip(h["fields"], h["field_streams"])]
        nw = len(h["stream_offs"])
        off_words = len(TIER_HEADER)
        off_fields = off_words + 2 * nw + 1
        off_sig = off_fields + 4 * len(fields)
        off_lanes = off_sig + 3 * len(sig)
        total = off_lanes + 6 * self._K
        hdr = dict(
            S=S, VL=self.VL, K=self._K, n_plain=self._groups[0], n_val=self._groups[1],
            n_bm=self._groups[2], n_words=nw,
            general=int(self.memo_general() if memo else self.tier_general()),
            cnt_off=h["cnt_off"], M=h["M"], n_fields=len(fields), n_sig=len(sig),
            rounds=REFINE_ROUNDS, ka=h["ka"], kb=h["kb"], seeded=int(bool(self.seed)),
            seed_a=h["seed_salts"][0], seed_b=h["seed_salts"][1], off_words=off_words,
            off_fields=off_fields, off_sig=off_sig, off_lanes=off_lanes, len=total)
        vec = np.concatenate([
            np.array([hdr[n] for n in TIER_HEADER], np.int64),
            np.array(h["stream_offs"] + h["sx"], np.int64),
            np.array(fields, np.int64).reshape(-1), np.array(sig, np.int64).reshape(-1),
            self._lane_desc.reshape(-1)])
        assert len(vec) == total
        return (vec & M32).astype(np.uint32).view(np.int32)

    def _tier_table(self, dev: torch.device, memo: bool = False):
        """(host ctypes copy, device tensor) of the spec vector (``memo``:
        canon_memo's)."""
        key = ("memo" if memo else "tier", str(dev))
        got = self._dev.get(key)
        if got is None:
            spec = self.tier_spec(memo)
            got = ((ctypes.c_int * len(spec))(*spec.tolist()),
                   torch.as_tensor(spec, device=dev))
            self._dev[key] = got
        return got

    def occupancy(self, dev: torch.device) -> dict:
        """The launch shape this layout's canon kernel (``canon_tiered``
        when ``prune``, else ``canon_memo``) takes on the card ``dev``
        (threads of a tile, threads and dynamic shared bytes a block) and
        the occupancy it reaches there
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: blocks and warps
        an SM). Launches nothing."""
        hspec, _spec = self._tier_table(dev, memo=not self.prune)
        out = (ctypes.c_int * 5)()
        name = "canon_tiered" if self.prune else "canon_memo"
        with torch.cuda.device(dev):
            lib = (kernels.CANON_TIERED if self.prune else kernels.CANON_MEMO).lib
            rc = getattr(lib, f"{name}_occupancy")(ctypes.cast(hspec, ctypes.c_void_p),
                                                   len(hspec), ctypes.cast(out, ctypes.c_void_p))
        if rc:
            raise RuntimeError(f"{name}_occupancy: {lib.rt_error_string(rc).decode()}")
        return dict(zip(("G", "threads", "smem_bytes", "blocks_per_sm", "warps_per_sm"), out))

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
        hspec, spec = self._tier_table(dev, memo=not self.prune)
        if self.prune:
            rc = k.lib.canon_tiered(ctypes.cast(hspec, ctypes.c_void_p), spec.data_ptr(),
                                    spec.numel(), *args)
        else:
            rc = k.lib.canon_memo(ctypes.cast(hspec, ctypes.c_void_p), spec.data_ptr(),
                                  spec.numel(), int(self.symmetry), *args)
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

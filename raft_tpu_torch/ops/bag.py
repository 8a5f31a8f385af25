"""Branchless message-bag kernels, batched over leading dimensions.

Counterpart of ``raft_tpu/ops/bag.py``. The bag is a function record ->
delivery count (``Raft.tla:55-58``); ``Discard`` decrements the count but
the record stays in the domain (``Raft.tla:164-167``), so slots are never
freed. Encoding: (hi, lo) key words + a count lane per slot, slots kept in
lexicographic (hi, lo) order with unused slots (EMPTY, EMPTY, 0) last; the
N-word bags of the WidePacker models (``wide_bag_put``) keep their slots in
lexicographic order of the words from word 0 (the packer's low-bit word),
unused slots (EMPTY, ..., EMPTY, 0) last.

Every function takes the slot axis LAST and broadcasts over the leading
dimensions, so one call serves a whole [chunk, bindings] grid.
"""

from __future__ import annotations

import torch

from .packing import EMPTY


def bag_put(hi, lo, cnt, khi, klo):
    """Add one delivery of the key (khi, klo) — TLA+
    ``_SendNoRestriction`` (``Raft.tla:129-132``): increment if the record
    is in the domain, else shift-insert it at its lexicographic rank.

    hi/lo/cnt: [..., M]; khi/klo: [...]. Returns (hi, lo, cnt, existed,
    overflow); overflow is set when an insert found no free slot."""
    khi = khi.unsqueeze(-1)
    klo = klo.unsqueeze(-1)
    eq = (hi == khi) & (lo == klo)
    existed = eq.any(-1)
    cnt_inc = cnt + eq.to(cnt.dtype)
    have_empty = (hi == EMPTY).any(-1)
    less = (hi < khi) | ((hi == khi) & (lo < klo))
    pos = less.sum(-1, keepdim=True)
    M = hi.shape[-1]
    lane = torch.arange(M, dtype=torch.int64, device=hi.device)

    def ins(w, k):
        return torch.where(
            lane < pos, w, torch.where(lane == pos, k, torch.roll(w, 1, -1))
        )

    one = torch.ones_like(cnt[..., :1])
    e = existed.unsqueeze(-1)
    hi2 = torch.where(e, hi, ins(hi, khi))
    lo2 = torch.where(e, lo, ins(lo, klo))
    cnt2 = torch.where(e, cnt_inc, ins(cnt, one))
    overflow = (~existed) & (~have_empty)
    return hi2, lo2, cnt2, existed, overflow


def wide_bag_put(words, cnt, key):
    """``bag_put`` over N key words (``raft_tpu/ops/bag.py:33``): the
    lexicographic order puts words[0] first. words: a list of [..., M]
    tensors; cnt [..., M]; key: a list of N [...] tensors or ints. Returns
    (words, cnt, existed, overflow)."""
    ref = words[0]
    key = [k.unsqueeze(-1) if isinstance(k, torch.Tensor) else k for k in key]
    eq = torch.ones_like(ref, dtype=torch.bool)
    less = torch.zeros_like(ref, dtype=torch.bool)
    tie = torch.ones_like(ref, dtype=torch.bool)
    for w, k in zip(words, key):
        eq = eq & (w == k)
        less = less | (tie & (w < k))
        tie = tie & (w == k)
    existed = eq.any(-1)
    have_empty = (ref == EMPTY).any(-1)
    pos = less.sum(-1, keepdim=True)
    lane = torch.arange(ref.shape[-1], dtype=torch.int64, device=ref.device)
    e = existed.unsqueeze(-1)

    def ins(w, k):
        k = torch.as_tensor(k, dtype=w.dtype, device=w.device)
        return torch.where(lane < pos, w, torch.where(lane == pos, k, torch.roll(w, 1, -1)))

    out = [torch.where(e, w, ins(w, k)) for w, k in zip(words, key)]
    cnt2 = torch.where(e, cnt + eq.to(cnt.dtype), ins(cnt, 1))
    return out, cnt2, existed, (~existed) & (~have_empty)


def bag_count(hi, lo, cnt, khi, klo):
    """Delivery count of a key (0 if not in the domain)."""
    eq = (hi == khi.unsqueeze(-1)) & (lo == klo.unsqueeze(-1))
    return torch.where(eq, cnt, 0).sum(-1)


def bag_discard_at(cnt, slot):
    """``Discard`` (``Raft.tla:164-167``): one fewer delivery at ``slot``
    ([...] indices into the last axis of cnt [..., M])."""
    M = cnt.shape[-1]
    lane = torch.arange(M, dtype=torch.int64, device=cnt.device)
    return cnt - (lane == slot.unsqueeze(-1)).to(cnt.dtype)


def wide_bag_sort(words, cnt):
    """Canonicalize an N-word bag: its slots in lexicographic order of the
    key words, word 0 first, ``cnt`` carried along (``raft_tpu/ops/bag.py:27``,
    a ``lax.sort`` with the words as its keys). words: a list of [..., M]
    tensors; cnt [..., M]. A bag's keys are unique and its unused slots
    identical (EMPTY words, count 0), so the order is unique and a chain of
    stable sorts from the last word to the first gives it."""
    order = None
    for w in reversed(words):
        key = w if order is None else w.gather(-1, order)
        step = torch.sort(key, dim=-1, stable=True).indices
        order = step if order is None else order.gather(-1, step)
    return [w.gather(-1, order) for w in words], cnt.gather(-1, order)

"""State-vector layout machinery and batched one-hot helpers.

Counterpart of ``raft_tpu/models/base.py``. Every spec lowers its TLA+
variables to one flat ``int32[W]`` vector per state, with the same field
offsets as the reference, so numpy state batches pass between the two
packages unchanged. The layout records each field's *kind* — how it
transforms under a permutation of the server set — which drives the
symmetry canonicalizer. VIEW fields come first, aux (VIEW-excluded)
fields last, so the VIEW projection is the prefix ``vec[:view_len]``.

Batched convention of the one-hot helpers: an array argument has shape
``[C, n|1, S, *rest]`` (chunk, binding axis, the indexed axis, the rest)
and an index ``[C|1, n]``; the helpers select or set along axis 2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# Field kinds (see raft_tpu/models/base.py for their permutation rules).
KINDS = (
    "scalar",
    "per_server",
    "per_server_val",
    "server_bitmask",
    "per_server_pair",
    "msg_hi",
    "msg_lo",
    "msg_cnt",
    "msg_word",
    "aux",
)


@dataclass(frozen=True)
class Field:
    name: str
    kind: str
    shape: tuple[int, ...]
    offset: int

    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1


class Layout:
    def __init__(self, n_servers: int):
        self.n_servers = n_servers
        self.fields: dict[str, Field] = {}
        self.W = 0
        self.view_len: int | None = None  # set when the first aux field lands

    def add(self, name: str, kind: str, shape: tuple[int, ...] = ()) -> Field:
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind}")
        if name in self.fields:
            raise ValueError(f"duplicate field {name}")
        if kind == "aux":
            if self.view_len is None:
                self.view_len = self.W
        elif self.view_len is not None:
            raise ValueError("non-aux field added after aux fields")
        f = Field(name, kind, shape, self.W)
        self.fields[name] = f
        self.W += f.size
        return f

    def finish(self):
        if self.view_len is None:
            self.view_len = self.W
        return self

    def sl(self, name: str) -> slice:
        f = self.fields[name]
        return slice(f.offset, f.offset + f.size)

    def get(self, vec, name: str):
        """Slice field ``name`` out of a [..., W] vector, reshaped to its
        shape (numpy arrays and torch tensors alike)."""
        f = self.fields[name]
        out = vec[..., f.offset : f.offset + f.size]
        if f.shape:
            return out.reshape(tuple(vec.shape[:-1]) + f.shape)
        return out[..., 0]

    def zeros(self, batch: tuple[int, ...] = ()) -> np.ndarray:
        return np.zeros(batch + (self.W,), dtype=np.int32)


class ActionLabelMixin:
    """Human-readable labels for expansion candidates. Subclass contract:
    ``self.bindings`` ((kernel name, binding tuple) per candidate) and
    ``self.ACTION_NAMES`` (rank -> action name). The fused HandleMessage
    kernel resolves its disjunct at run time, so its label comes from
    the fired rank."""

    ACTION_NAMES: list[str]

    def action_label(self, rank: int, cand: int) -> str:
        name, binding = self.bindings[cand]
        if name == "HandleMessage":
            return f"{self.ACTION_NAMES[rank]}(slot {binding[0]})"
        return f"{name}{binding}"


def _onehot(arr, i):
    """bool mask [C|1, n, S, 1...] selecting index i along axis 2."""
    S = arr.shape[2]
    oh = torch.arange(S, device=arr.device) == i.unsqueeze(-1)
    return oh.reshape(oh.shape + (1,) * (arr.ndim - 3))


def onehot_row(arr, i):
    """``arr[..., i, ...]`` along axis 2 via a one-hot select (0 where i
    is out of range, as the reference's one-hot helper gives)."""
    return torch.where(_onehot(arr, i), arr, 0).sum(dim=2, dtype=arr.dtype)


def onehot_set(arr, i, val):
    """``arr.at[i].set(val)`` along axis 2. ``val`` is a scalar or a
    tensor shaped like the result row ``[C|1, n|1, *rest]``."""
    if isinstance(val, torch.Tensor):
        val = val.unsqueeze(2)
    return torch.where(_onehot(arr, i), val, arr)


def onehot_set2(arr, i, j, val):
    """``arr.at[i, j].set(val)`` on axes 2 and 3 (val: scalar or
    [C|1, n])."""
    S, T = arr.shape[2], arr.shape[3]
    oi = (torch.arange(S, device=arr.device) == i.unsqueeze(-1)).unsqueeze(-1)
    oj = (torch.arange(T, device=arr.device) == j.unsqueeze(-1)).unsqueeze(-2)
    if isinstance(val, torch.Tensor):
        val = val.unsqueeze(-1).unsqueeze(-1)
    return torch.where(oi & oj, val, arr)


def messages_are_valid_kernel(layout: Layout, packer):
    """MessagesAreValid — MessagePassing.tla:81-83: no record in the bag
    domain is self-addressed. Batched over [..., W] states (2-word
    BitPacker bags)."""
    from ..ops.packing import EMPTY

    def kernel(states):
        hi = layout.get(states, "msg_hi")
        lo = layout.get(states, "msg_lo")
        occ = hi != EMPTY
        src = packer.unpack(hi, lo, "msource")
        dst = packer.unpack(hi, lo, "mdest")
        return ~torch.any(occ & (src == dst), dim=-1)

    return kernel

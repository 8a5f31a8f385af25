"""Carrying values between the JAX reference and this port.

State rows need no conversion: both packages lay a state out as the same
``int32 [B, W]`` vector with the same field offsets. Parameters cross as
plain dicts (``dataclasses.asdict`` of the reference's ``RaftParams``),
and fingerprints as numpy arrays: the reference's ``uint64`` values, the
port's int64 ``u64 ^ (1 << 63)`` encoding (order-preserving; the
``U64_MAX`` sentinel becomes ``INT64_MAX``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.raft import RaftParams

_SIGN = np.uint64(1 << 63)


def params_from_reference(d: dict) -> RaftParams:
    """The port's ``RaftParams`` from ``dataclasses.asdict`` of the
    reference's (the two dataclasses have the same fields)."""
    d = dict(d)
    if "dyn_consts" in d:
        d["dyn_consts"] = tuple(d["dyn_consts"])
    return RaftParams(**d)


def fps_from_u64(a) -> torch.Tensor:
    """numpy uint64 fingerprints -> the port's int64 enc tensor."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy((a ^ _SIGN).view(np.int64).copy())


def fps_to_u64(t: torch.Tensor) -> np.ndarray:
    """The port's int64 enc fingerprints -> numpy uint64 values."""
    a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.int64)
    return a.view(np.uint64) ^ _SIGN

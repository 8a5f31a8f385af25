"""Carrying values between the JAX reference and this port.

State rows need no conversion: both packages lay a state out as the same
``int32 [B, W]`` vector with the same field offsets. Parameters cross as
plain dicts (``dataclasses.asdict`` of the reference's ``RaftParams``,
``PullRaftParams``, ``KRaftParams``, ``ReconfigRaftParams``,
``JointRaftParams`` or ``KRaftReconfigParams``),
and fingerprints as numpy arrays: the reference's ``uint64`` values, the
port's int64 ``u64 ^ (1 << 63)`` encoding (order-preserving; the
``U64_MAX`` sentinel becomes ``INT64_MAX``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.joint_raft import JointRaftParams
from .models.kraft import KRaftParams
from .models.kraft_reconfig import KRaftReconfigParams
from .models.pull_raft import PullRaftParams
from .models.raft import RaftParams
from .models.reconfig_raft import ReconfigRaftParams

_SIGN = np.uint64(1 << 63)


def params_from_reference(d: dict):
    """The port's ``RaftParams``, ``PullRaftParams``, ``KRaftParams``,
    ``ReconfigRaftParams``, ``JointRaftParams`` or ``KRaftReconfigParams``
    from ``dataclasses.asdict``
    of the reference's (each pair of dataclasses has the same fields; a
    dict with ``variant2`` is the pull family's, one with exactly a port
    dataclass's fields that one's). The pull family's fleet lanes are not
    ported: a dict that sets ``fleet`` or ``dyn_consts`` is refused."""
    d = dict(d)
    if "dyn_consts" in d:
        d["dyn_consts"] = tuple(d["dyn_consts"])
    if "variant2" in d:
        if d.get("fleet") or d.get("dyn_consts"):
            raise NotImplementedError(
                "PullRaft fleet lanes (fleet, dyn_consts) are not ported to raft_tpu_torch")
        return PullRaftParams(**d)
    for cls in (KRaftParams, ReconfigRaftParams, JointRaftParams, KRaftReconfigParams):
        if set(d) == {f.name for f in dataclasses.fields(cls)}:
            return cls(**d)
    return RaftParams(**d)


def fps_from_u64(a) -> torch.Tensor:
    """numpy uint64 fingerprints -> the port's int64 enc tensor."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy((a ^ _SIGN).view(np.int64).copy())


def fps_to_u64(t: torch.Tensor) -> np.ndarray:
    """The port's int64 enc fingerprints -> numpy uint64 values."""
    a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.int64)
    return a.view(np.uint64) ^ _SIGN

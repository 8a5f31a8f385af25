"""Spec registry: maps a TLA+ module name to its lowering builder.

Counterpart of ``raft_tpu/models/registry.py`` for the specs this port
lowers so far — the three that one ``RaftModel`` serves. Every other spec
the reference knows raises a "not yet ported" ``CfgError`` (CLI exit 64).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils.cfg import Cfg, CfgError
from .raft import RaftModel, RaftParams


@dataclass
class CheckSetup:
    model: object
    invariants: tuple[str, ...]
    symmetry: bool
    server_names: list[str]
    value_names: list[str]


def _require_int(cfg: Cfg, name: str) -> int:
    if name not in cfg.constants:
        raise CfgError(f"{cfg.path}: required constant {name} is missing")
    v = cfg.constants[name]
    if not isinstance(v, int) or isinstance(v, bool):
        raise CfgError(f"{cfg.path}: constant {name} must be a number, got {v!r}")
    return v


def _require_bool(cfg: Cfg, name: str) -> bool:
    if name not in cfg.constants:
        raise CfgError(f"{cfg.path}: required constant {name} is missing")
    v = cfg.constants[name]
    if not isinstance(v, bool):
        raise CfgError(f"{cfg.path}: constant {name} must be TRUE/FALSE, got {v!r}")
    return v


def _setup(cfg: Cfg, params: RaftParams, name: str) -> CheckSetup:
    servers = cfg.server_like("Server")
    values = cfg.server_like("Value")
    model = RaftModel(params, server_names=servers, value_names=values)
    model.name = name
    unknown = [i for i in cfg.invariants if i not in model.invariants]
    if unknown:
        raise CfgError(f"{cfg.path}: unknown invariant(s) {unknown}")
    return CheckSetup(
        model=model,
        invariants=tuple(cfg.invariants),
        symmetry=cfg.symmetry is not None,
        server_names=servers,
        value_names=values,
    )


def _core(cfg: Cfg, msg_slots: int | None) -> dict:
    return dict(
        n_servers=len(cfg.server_like("Server")),
        n_values=len(cfg.server_like("Value")),
        max_elections=_require_int(cfg, "MaxElections"),
        max_restarts=_require_int(cfg, "MaxRestarts"),
        msg_slots=msg_slots if msg_slots is not None else 48,
    )


def build_raft(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """standard-raft/Raft.tla + Raft.cfg."""
    return _setup(cfg, RaftParams(**_core(cfg, msg_slots)), "Raft")


def build_flexible_raft(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """flexible-raft/FlexibleRaft.tla: count-based quorums
    (FlexibleRaft.tla:262,296), strictly send-once messaging (:127-151),
    no pendingResponse (:109), term-mismatch truncation (:413-416)."""
    params = RaftParams(
        **_core(cfg, msg_slots),
        election_quorum=_require_int(cfg, "ElectionQuorumSize"),
        replication_quorum=_require_int(cfg, "ReplicationQuorumSize"),
        strict_send_once=True,
        has_pending_response=False,
        trunc_term_mismatch=True,
    )
    return _setup(cfg, params, "FlexibleRaft")


def build_raft_fsync(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """raft-and-fsync/RaftFsync.tla: fsyncIndex durability (:92), crash
    truncation (:203-218), split Timeout/RequestVote (:222-243),
    AdvanceFsyncIndex (:339) and the three fsync policy constants (:50-52)."""
    params = RaftParams(
        **_core(cfg, msg_slots),
        strict_send_once=True,
        has_pending_response=False,
        trunc_term_mismatch=True,
        has_fsync=True,
        fsync_leader_before_ae=_require_bool(cfg, "LeaderFsyncBeforeAppendEntries"),
        fsync_leader_quorum=_require_bool(cfg, "LeaderFsyncBeforeIncludeInQuorum"),
        fsync_follower_reply=_require_bool(cfg, "FollowerFsyncBeforeReply"),
    )
    return _setup(cfg, params, "RaftFsync")


BUILDERS = {
    "Raft": build_raft,
    "FlexibleRaft": build_flexible_raft,
    "RaftFsync": build_raft_fsync,
}

# Specs the reference lowers that this port does not yet.
NOT_YET_PORTED = (
    "PullRaft",
    "PullRaftVariant2",
    "KRaft",
    "RaftWithReconfigAddRemove",
    "RaftWithReconfigJointConsensus",
    "KRaftWithReconfig",
)


def build_from_cfg(cfg: Cfg, spec: str | None = None,
                   msg_slots: int | None = None) -> CheckSetup:
    name = spec or os.path.splitext(os.path.basename(cfg.path))[0]
    if name in NOT_YET_PORTED:
        raise CfgError(
            f"spec {name!r} is not yet ported to raft_tpu_torch (ported: "
            f"{', '.join(sorted(BUILDERS))}); use the reference: python -m raft_tpu"
        )
    if name not in BUILDERS:
        raise CfgError(
            f"no lowering registered for spec {name!r} "
            f"(available: {', '.join(sorted(BUILDERS))})"
        )
    return BUILDERS[name](cfg, msg_slots=msg_slots)

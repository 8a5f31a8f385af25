"""Spec registry: maps a TLA+ module name to its lowering builder.

Counterpart of ``raft_tpu/models/registry.py`` for the specs this port
lowers — all of the reference's: the three that one ``RaftModel`` serves,
PullRaft and PullRaftVariant2 (``PullRaftModel``), KRaft (``KRaftModel``),
the two reconfiguration specs (``ReconfigRaftModel``, ``JointRaftModel``)
and KRaftWithReconfig (``KRaftReconfigModel``). A spec name with no builder
raises "no lowering registered" (CLI exit 64).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils.cfg import Cfg, CfgError
from .joint_raft import JointRaftModel, JointRaftParams
from .kraft import KRaftModel, KRaftParams
from .kraft_reconfig import KRaftReconfigModel, KRaftReconfigParams
from .pull_raft import PullRaftModel, PullRaftParams
from .raft import RaftModel, RaftParams
from .reconfig_raft import ReconfigRaftModel, ReconfigRaftParams


@dataclass
class CheckSetup:
    model: object
    invariants: tuple[str, ...]
    symmetry: bool
    server_names: list[str]
    value_names: list[str]
    properties: tuple[str, ...] = ()  # the cfg's PROPERTY lines


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


def _setup(cfg: Cfg, params, name: str, model_cls=RaftModel,
           servers_from: str = "Server") -> CheckSetup:
    servers = cfg.server_like(servers_from)
    values = cfg.server_like("Value")
    model = model_cls(params, server_names=servers, value_names=values)
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
        properties=tuple(cfg.properties),
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


def _build_pull(cfg: Cfg, msg_slots: int | None, variant2: bool) -> CheckSetup:
    params = PullRaftParams(
        n_servers=len(cfg.server_like("Server")),
        n_values=len(cfg.server_like("Value")),
        max_elections=_require_int(cfg, "MaxElections"),
        max_restarts=_require_int(cfg, "MaxRestarts"),
        # pull specs need extra bag headroom: every message type is
        # send-once, so count-0 records pile up across a behavior
        msg_slots=msg_slots if msg_slots is not None else 64,
        variant2=variant2,
    )
    return _setup(cfg, params, "PullRaftVariant2" if variant2 else "PullRaft", PullRaftModel)


def build_pull_raft(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """pull-raft/PullRaft.tla + PullRaft.cfg (the reference cfg names the
    undeclared model value `v2`, PullRaft.cfg:9-11: parse it with
    lenient=True, CLI --lenient, to diagnose and repair)."""
    return _build_pull(cfg, msg_slots, variant2=False)


def build_pull_raft_v2(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """pull-raft/PullRaftVariant2.tla + PullRaftVariant2.cfg (the same cfg
    bug)."""
    return _build_pull(cfg, msg_slots, variant2=True)


def build_kraft(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """pull-raft/KRaft.tla + KRaft.cfg: Kafka KRaft (KIP-595) with five
    server states + IllegalState, fetch-based replication with correlation,
    error codes, and the BeginQuorumRequest leadership notify."""
    # fetch responses carry whole correlation records, so distinct-record
    # counts run higher than the push-based variants': 80 slots by default
    params = KRaftParams(**_core(cfg, 80 if msg_slots is None else msg_slots))
    return _setup(cfg, params, "KRaft", KRaftModel)


def build_reconfig_add_remove(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """standard-raft/RaftWithReconfigAddRemove.tla + its cfg. The reference
    cfg omits the required constant ``MaxClusterSize``
    (RaftWithReconfigAddRemove.tla:88): a strict parse raises, a lenient
    one repairs it to |Server| (the physical bound) and records the
    diagnosis."""
    servers = cfg.server_like("Server")
    if "MaxClusterSize" not in cfg.constants:
        diag = (f"{cfg.path}: required constant MaxClusterSize "
                "(RaftWithReconfigAddRemove.tla:88) is missing from the cfg; lenient mode "
                f"repairs this by defaulting it to |Server| = {len(servers)}")
        if not cfg.lenient:
            raise CfgError(diag)
        cfg.diagnostics.append(diag)
        cfg.constants["MaxClusterSize"] = len(servers)
    params = ReconfigRaftParams(
        n_servers=len(servers),
        n_values=len(cfg.server_like("Value")),
        init_cluster_size=_require_int(cfg, "InitClusterSize"),
        max_elections=_require_int(cfg, "MaxElections"),
        max_restarts=_require_int(cfg, "MaxRestarts"),
        max_values_per_term=_require_int(cfg, "MaxValuesPerTerm"),
        max_add_reconfigs=_require_int(cfg, "MaxAddReconfigs"),
        max_remove_reconfigs=_require_int(cfg, "MaxRemoveReconfigs"),
        min_cluster_size=_require_int(cfg, "MinClusterSize"),
        max_cluster_size=_require_int(cfg, "MaxClusterSize"),
        include_thesis_bug=_require_bool(cfg, "IncludeThesisBug"),
        # snapshot records embed whole logs and AppendEntries records pile
        # up per (term, prev, entry): 112 slots by default
        msg_slots=msg_slots if msg_slots is not None else 112,
    )
    return _setup(cfg, params, "RaftWithReconfigAddRemove", ReconfigRaftModel)


def build_reconfig_joint(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """standard-raft/RaftWithReconfigJointConsensus.tla + its cfg: joint
    consensus with dual quorums and the ReconfigType knob
    (RaftWithReconfigJointConsensus.tla:79-80)."""
    params = JointRaftParams(
        n_servers=len(cfg.server_like("Server")),
        n_values=len(cfg.server_like("Value")),
        init_cluster_size=_require_int(cfg, "InitClusterSize"),
        max_elections=_require_int(cfg, "MaxElections"),
        max_restarts=_require_int(cfg, "MaxRestarts"),
        max_reconfigs=_require_int(cfg, "MaxReconfigs"),
        max_values_per_term=_require_int(cfg, "MaxValuesPerTerm"),
        reconfig_type=_require_int(cfg, "ReconfigType"),
        msg_slots=msg_slots if msg_slots is not None else 112,
    )
    return _setup(cfg, params, "RaftWithReconfigJointConsensus", JointRaftModel)


def build_kraft_reconfig(cfg: Cfg, msg_slots: int | None = None) -> CheckSetup:
    """pull-raft/KRaftWithReconfig.tla + its cfg: the dynamic-server
    universe, lowered to MaxSpawnedServers identity slots over the cfg's
    Hosts (the cfg prescribes simulation, KRaftWithReconfig.cfg:5). The cfg
    names the undeclared model value v2 as PullRaft.cfg does (a lenient
    parse repairs it)."""
    params = KRaftReconfigParams(
        n_hosts=len(cfg.server_like("Hosts")),
        n_values=len(cfg.server_like("Value")),
        init_cluster_size=_require_int(cfg, "InitClusterSize"),
        min_cluster_size=_require_int(cfg, "MinClusterSize"),
        max_cluster_size=_require_int(cfg, "MaxClusterSize"),
        max_elections=_require_int(cfg, "MaxElections"),
        max_restarts=_require_int(cfg, "MaxRestarts"),
        max_values_per_epoch=_require_int(cfg, "MaxValuesPerEpoch"),
        max_add_reconfigs=_require_int(cfg, "MaxAddReconfigs"),
        max_remove_reconfigs=_require_int(cfg, "MaxRemoveReconfigs"),
        max_spawned_servers=_require_int(cfg, "MaxSpawnedServers"),
        msg_slots=msg_slots if msg_slots is not None else 40,
    )
    return _setup(cfg, params, "KRaftWithReconfig", KRaftReconfigModel, servers_from="Hosts")


BUILDERS = {
    "Raft": build_raft,
    "FlexibleRaft": build_flexible_raft,
    "RaftFsync": build_raft_fsync,
    "PullRaft": build_pull_raft,
    "PullRaftVariant2": build_pull_raft_v2,
    "KRaft": build_kraft,
    "RaftWithReconfigAddRemove": build_reconfig_add_remove,
    "RaftWithReconfigJointConsensus": build_reconfig_joint,
    "KRaftWithReconfig": build_kraft_reconfig,
}


def build_from_cfg(cfg: Cfg, spec: str | None = None,
                   msg_slots: int | None = None) -> CheckSetup:
    name = spec or os.path.splitext(os.path.basename(cfg.path))[0]
    if name not in BUILDERS:
        raise CfgError(
            f"no lowering registered for spec {name!r} "
            f"(available: {', '.join(sorted(BUILDERS))})"
        )
    return BUILDERS[name](cfg, msg_slots=msg_slots)

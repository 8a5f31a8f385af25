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

import functools
import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import expand as expand_ops

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


@dataclass(frozen=True)
class SparseGroup:
    """One contiguous run of same-named bindings in ``self.bindings``:
    the unit of the guard-first expansion. ``params`` is the [n, arity]
    int32 binding table of the group's candidates."""

    name: str
    off: int  # first candidate index of the group
    n: int  # candidates in the group
    params: np.ndarray  # [n, arity] int32


class SparseExpandMixin:
    """Guard-first expansion contract (``SparseExpandMixin`` of the
    reference, ``raft_tpu/models/base.py:236-489``), split in two:

      guards        valid/rank/ovf over the [C, A] candidate grid, no
                    successor rows;
      sparse_apply  successor rows only for a compacted worklist of
                    flat candidate ids.

    These are the plain PyTorch versions: both sit on the dense
    ``expand`` (bit-identical to the reference's guard grid by
    construction, ``raft_tpu/models/base.py:251-263``). The hand-written
    kernels of ``ops/expand.py`` compute the same values without ever
    building the [C, A, W] grid. The reference's per-group apply budgets
    (``sparse_plan``) are a static-shape workaround the port drops: one
    worklist lane per enabled candidate, so ``apply_ovf`` never fires
    (the reference's ``valid_per_group=None`` default)."""

    def sparse_groups(self) -> list[SparseGroup]:
        """Contiguous same-named runs of ``self.bindings`` with their
        [n, arity] parameter tables (cached)."""
        if "_sparse_groups" not in self.__dict__:
            groups, off = [], 0
            for name, run in itertools.groupby(self.bindings, key=lambda b: b[0]):
                params = np.asarray([list(b[1]) for b in run], np.int32)
                n = len(params)
                groups.append(SparseGroup(name, off, n, params.reshape(n, -1)))
                off += n
            names = [g.name for g in groups]
            if len(set(names)) != len(names):
                raise ValueError(f"non-contiguous binding groups: {names}")
            self.__dict__["_sparse_groups"] = groups
        return self.__dict__["_sparse_groups"]

    def guards(self, states: torch.Tensor):
        """(valid [C, A] bool, rank [C, A] int32, ovf [C, A] bool) of a
        [C, W] state batch (``guards1`` of the reference, batched)."""
        _succs, valid, rank, ovf = self.expand(states)
        return valid, rank, ovf

    def sparse_apply(self, states: torch.Tensor, sel: torch.Tensor, selv: torch.Tensor):
        """Successor rows [VC, W] int32 of the flat candidate ids ``sel``
        (state * A + candidate); lanes where ``selv`` is false (the drop
        value C * A) get a zeros row — the dense gather ``flatp[sel]`` of
        the reference's ``sparse_apply``."""
        C, W = states.shape
        succs = self.expand(states)[0].reshape(C * self.A, W)
        rows = succs.index_select(0, sel.to(torch.int64).clamp(0, C * self.A - 1))
        return torch.where(selv[:, None], rows, 0)


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


FLEET_JOB = "fleet_job"


class FleetConstMixin:
    """Fleet packing: a config axis embedded in the state vector
    (``FleetConstMixin`` of ``raft_tpu/models/base.py:130-232``).

    A fleet-packed model (``params.fleet``) carries extra VIEW scalar
    lanes, added by the lowering's ``_build_layout`` after the message-bag
    fields and before the first aux field:

      fleet_job   the manifest job a state belongs to; a VIEW lane, so
                  states of different jobs never dedup against each other;
      c_<name>    one lane per dynamic constant of ``params.dyn_consts``;
                  guards read it through ``_cv`` instead of the static
                  param, so one model serves every constants point of a
                  group.

    Subclass contract: ``init_states`` ends with ``self._fleet_stamp(vec)``
    (identity when no table is bound), and every guard that reads a
    dynamic constant goes through ``_cv`` / ``_cv_batch``; the kernels
    read the lanes through the spec vector's lane offsets."""

    def fleet_bind(self, table) -> None:
        """Bind the per-job dynamic-constant table: [J, len(dyn_consts)]
        ints, row j job j's value of each dynamic constant in
        ``dyn_consts`` order. The static params must be the element-wise
        maximum over the table (they size capacity, e.g. ``max_term``)."""
        table = np.asarray(table, np.int64)
        dyn = tuple(self.p.dyn_consts)
        if table.ndim != 2 or table.shape[1] != len(dyn):
            raise ValueError(f"fleet table must be [J, {len(dyn)}] for dyn_consts {dyn}")
        for k, name in enumerate(dyn):
            cap = int(getattr(self.p, name))
            hi = int(table[:, k].max()) if len(table) else 0
            if hi > cap:
                raise ValueError(
                    f"fleet table {name} max {hi} exceeds static param {cap}"
                    " (representative params must be the per-constant max)")
        self._fleet_table = table
        self._fleet_sel: int | None = None

    @property
    def fleet_jobs(self) -> int:
        t = getattr(self, "_fleet_table", None)
        return 0 if t is None else len(t)

    def fleet_select(self, j: int | None) -> None:
        """Restrict ``init_states`` stamping to job ``j`` (None: every
        job); the queue arm runs the jobs one at a time through one
        engine by re-selecting between runs."""
        if getattr(self, "_fleet_table", None) is None:
            raise ValueError("fleet_select before fleet_bind")
        self._fleet_sel = j

    def fleet_job_of(self, states) -> np.ndarray:
        """[n] job index of each row of a [n, W] state batch."""
        return np.asarray(states)[..., self.layout.fields[FLEET_JOB].offset]

    def _fleet_stamp(self, vec: np.ndarray) -> np.ndarray:
        """Stamp the initial states with the job lane and the constant
        lanes, one copy per selected job, job-major; identity when no
        table is bound."""
        table = getattr(self, "_fleet_table", None)
        if table is None:
            return vec
        lay = self.layout
        sel = getattr(self, "_fleet_sel", None)
        out = []
        for j in range(len(table)) if sel is None else [sel]:
            v = vec.copy()
            v[:, lay.fields[FLEET_JOB].offset] = j
            for k, name in enumerate(self.p.dyn_consts):
                v[:, lay.fields["c_" + name].offset] = int(table[j, k])
            out.append(v)
        return np.concatenate(out, axis=0)

    def _cv(self, d: dict, name: str):
        """A constant's value in a batched action: the state lane ([C, 1])
        when fleet-packed, the static param otherwise."""
        key = "c_" + name
        if key in self.layout.fields:
            return d[key]
        return getattr(self.p, name)

    def _cv_batch(self, states, name: str):
        """``_cv`` over a [..., W] state batch (the invariants and the
        liveness predicates)."""
        return cv_batch(self.layout, self.p, states, name)

    def _lane_offset(self, name: str) -> int:
        """The offset of constant ``name``'s lane, -1 when static (the
        kernels' spec vector)."""
        f = self.layout.fields.get("c_" + name)
        return -1 if f is None else f.offset


def cv_batch(lay: Layout, p, states, name: str):
    """A constant's value over a [..., W] state batch: its ``c_<name>``
    lane when the layout has one, the static param otherwise."""
    key = "c_" + name
    if key in lay.fields:
        return lay.get(states, key)
    return getattr(p, name)


def fleet_lanes(lay: Layout, p) -> None:
    """Add the fleet lanes of ``p`` (``fleet_job``, then ``c_<name>`` per
    dynamic constant) to a layout: VIEW scalars, so jobs never dedup
    against each other."""
    if p.fleet:
        lay.add(FLEET_JOB, "scalar")
        for nm in p.dyn_consts:
            lay.add("c_" + nm, "scalar")


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


def popcount(x, n: int):
    """Set bits among the low ``n`` of each value."""
    return ((x.unsqueeze(-1) >> torch.arange(n, device=x.device)) & 1).sum(-1)


def select(cond, a, b):
    """``where(cond, a, b)`` with cond [C, n] broadcast over the trailing
    field axes of a/b."""
    nd = max(a.ndim if isinstance(a, torch.Tensor) else 0,
             b.ndim if isinstance(b, torch.Tensor) else 0)
    return torch.where(cond.reshape(cond.shape + (1,) * (nd - cond.ndim)), a, b)


def _jax_index(i, n: int):
    """A traced JAX index into an axis of ``n``: a negative one counts from
    the end."""
    return torch.where(i < 0, i + n, i)


def jax_take(arr, i):
    """``arr[i]`` along axis 2 as JAX gathers with a traced index: a
    negative index counts from the end, then the index is clamped into
    range (the reference's PullRaft reads ``x[dst]`` this way)."""
    return onehot_row(arr, _jax_index(i, arr.shape[2]).clamp(0, arr.shape[2] - 1))


def jax_set(arr, i, val):
    """``arr.at[i].set(val)`` along axis 2 as JAX scatters with a traced
    index: a negative index counts from the end, and the write is dropped
    where the index is out of range."""
    return onehot_set(arr, _jax_index(i, arr.shape[2]), val)


def jax_set2(arr, i, j, val):
    """``arr.at[i, j].set(val)`` on axes 2 and 3 as JAX scatters: dropped
    where either index is out of range."""
    return onehot_set2(arr, _jax_index(i, arr.shape[2]), _jax_index(j, arr.shape[3]), val)


# the invariants every family's kernels evaluate, by kernel id (the INV_*
# enum of csrc/actions_common.cuh)
INVARIANT_IDS = {
    "MessagesAreValid": 0, "NoLogDivergence": 1, "LeaderHasAllAckedValues": 2,
    "CommittedEntriesReachMajority": 3, "TestInv": 4,
}


class KernelModel:
    """What a family's batched model shares with the others: field access
    over a [C, n] grid of (state, binding) pairs, and the hand-written
    kernels' view of the model.

    Subclass contract: ``layout``, ``bindings``, ``A``, ``ACTION_NAMES``,
    ``_consts`` (a dict), ``_bind_tables()`` (name -> binding-index list),
    ``_spec_vector()`` (the int32 spec its actions header reads),
    ``GROUP_IDS``/``GROUP_RANKS`` (binding group -> kernel group id / rank),
    ``_pred_ids`` (predicate name -> kernel id), ``ACTIONS_HEADER`` (the
    csrc header that evaluates them) and ``KERNELS`` (role -> Kernel:
    guard, apply, fold, predicates, sim_check)."""

    # The build of the guard and apply kernels the model runs: "" for the
    # kernel itself, or a variant its source also builds (Kernel.launcher).
    KERNEL_VARIANT = ""

    # The engine's chunk entry points. DeviceBFS, Simulator and the
    # liveness checker expand, fold and check only through these, so the
    # choice of kernels stays with the model (as the reference's engine
    # calls ``model.guards1`` and ``model.sparse_apply``). Each routes by
    # tensor device: the model's hand-written kernel (KERNELS) for a CUDA
    # tensor, its plain version for a CPU one (ops/expand.py).
    chunk_guards = expand_ops.guard
    chunk_apply = expand_ops.apply
    chunk_fold = expand_ops.fold
    chunk_predicates = expand_ops.predicates
    sim_check = expand_ops.sim_check

    def _idx(self, name: str, dev: torch.device) -> torch.Tensor:
        """Cached [1, n] binding-index tensors (device-resident, so a
        chunk never uploads them again)."""
        key = (name, str(dev))
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(self._bind_tables()[name], dtype=torch.int64, device=dev)[None, :]
            self._consts[key] = t
        return t

    def _dec(self, states):
        """[C, W] -> {field: [C, 1, *shape]} (the binding axis is 1)."""
        g = self.layout.get
        return {f: g(states, f).unsqueeze(1) for f in self.layout.fields}

    def _asm(self, d, C: int, n: int, **updates):
        """Reassemble successor rows [C, n, W] in layout order."""
        parts = []
        for name, f in self.layout.fields.items():
            arr = updates.get(name, d[name])
            arr = arr.to(torch.int32).expand((C, n) + f.shape)
            parts.append(arr.reshape(C, n, f.size))
        return torch.cat(parts, dim=2)

    @staticmethod
    def _full(C, n, val, dtype, dev):
        return torch.full((C, n), val, dtype=dtype, device=dev)

    def pack_i32(self, **vals):
        """Pack a key as int32 words, as the pull and KRaft references'
        ``_pack`` casts them (a word wraps where a field's value exceeds its
        width); a word of constant fields only comes back as a 0-d tensor
        on the device of the tensor-valued fields."""
        dev = next(v.device for v in vals.values() if isinstance(v, torch.Tensor))
        vals = {k: v.to(torch.int64) if isinstance(v, torch.Tensor) else v
                for k, v in vals.items()}
        return tuple(
            w.to(torch.int32) if isinstance(w, torch.Tensor)
            else torch.full((), w, dtype=torch.int32, device=dev)
            for w in self.packer.pack(**vals)
        )

    @staticmethod
    def _cand_args(name: str, row) -> list[int]:
        """The two int32 parameters (p0, p1) of a candidate row of the
        kernels' table, from the binding's parameters (at most two)."""
        return list(row) + [0] * (2 - len(row))

    def prepare_device(self, device, invariants) -> None:
        """Fail before a run, not inside it, where the kernels on
        ``device`` cannot evaluate one of ``invariants``."""
        if torch.device(device).type == "cuda":
            self.kernel_spec(device, tuple(invariants))

    def kernel_spec(self, dev, invariants: tuple[str, ...] = ()):
        """(spec int32 [spec length], cand int32 [A, 4], ids int32
        [len(invariants)]) on ``dev``, built once per device and
        predicate tuple: everything the hand-written kernels read about
        this model (field offsets, message-field locations, parameter
        flags, the candidate table of (group, p0, p1, rank) rows, the
        kernel ids of the named invariants or liveness predicates).
        Raises KeyError for a predicate the kernels do not evaluate."""
        missing = [n for n in invariants if n not in self._pred_ids]
        if missing:
            raise KeyError(
                f"predicate(s) {missing} have no kernel predicate "
                f"(csrc/{self.ACTIONS_HEADER} evaluates {sorted(self._pred_ids)})")
        dev = torch.device(dev)
        key = ("kernel_spec", str(dev), tuple(invariants))
        hit = self._consts.get(key)
        if hit is not None:
            return hit
        cand = []
        for g in self.sparse_groups():
            for row in g.params:
                cand.append([self.GROUP_IDS[g.name], *self._cand_args(g.name, row),
                             self.GROUP_RANKS[g.name]])
        hit = tuple(
            torch.tensor(v, dtype=torch.int32, device=dev)
            for v in (self._spec_vector(), cand, [self._pred_ids[n] for n in invariants]))
        self._consts[key] = hit
        return hit


# server states and acked[v] values of the Raft family (Raft.tla:38,62-65;
# PullRaft.tla keeps them)
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
ACK_NIL, ACK_FALSE, ACK_TRUE = 0, 1, 2
# the liveness predicate ValueAllOrNothing(v) has kernel id PRED_VALUE_AON + v
# (PRED_VALUE_AON of csrc/actions_common.cuh)
PRED_VALUE_AON = 16


@dataclass(frozen=True)
class InvFields:
    """What the shared invariants and ValueAllOrNothing read of a family:
    the names of its term, commit-index and log-term fields, and the state
    code of its Leader (the InvFields of csrc/actions_common.cuh)."""

    term: str = "currentTerm"
    commit: str = "commitIndex"
    log_term: str = "log_term"
    leader: int = LEADER


RAFT_FIELDS = InvFields()


def raft_invariants(model, f: InvFields = RAFT_FIELDS) -> dict:
    """The invariants every Raft-family model registers, by name, each
    mapping states [B, W] -> ok bool [B] (True = invariant holds). The
    formulas are Raft.tla's; the pull specs repeat them
    (PullRaft.tla:578-627) over the same field names, KRaft
    (KRaft.tla:894-957) over its own (``f``)."""
    lay, p = model.layout, model.p
    return {
        "MessagesAreValid": messages_are_valid_kernel(lay, model.packer),
        "NoLogDivergence": lambda s: inv_no_log_divergence(lay, p, s, f),
        "LeaderHasAllAckedValues": lambda s: inv_leader_has_acked(lay, p, s, f),
        "CommittedEntriesReachMajority": lambda s: inv_committed_majority(lay, p, s, f),
        "TestInv": lambda s: torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device),
    }


def inv_no_log_divergence(lay: Layout, p, states, f: InvFields = RAFT_FIELDS):
    """NoLogDivergence — Raft.tla:588-596."""
    L = p.max_log
    ci = lay.get(states, f.commit)  # [B,S]
    lt = lay.get(states, f.log_term)  # [B,S,L]
    lv = lay.get(states, "log_value")
    mci = torch.minimum(ci[:, :, None], ci[:, None, :])  # [B,S,S]
    lanes = torch.arange(1, L + 1, device=states.device)
    in_common = lanes <= mci[..., None]  # [B,S,S,L]
    eq = (lt[:, :, None, :] == lt[:, None, :, :]) & (lv[:, :, None, :] == lv[:, None, :, :])
    return torch.all((~in_common | eq).flatten(1), dim=1)


def inv_leader_has_acked(lay: Layout, p, states, f: InvFields = RAFT_FIELDS):
    """LeaderHasAllAckedValues — Raft.tla:604-620."""
    V = p.n_values
    ct = lay.get(states, f.term)
    st = lay.get(states, "state")
    lv = lay.get(states, "log_value")  # [B,S,L]
    acked = lay.get(states, "acked")  # [B,V]
    not_stale = torch.all(ct[:, :, None] >= ct[:, None, :], dim=2)  # [B,S]
    is_lead = (st == f.leader) & not_stale
    vals = torch.arange(1, V + 1, device=states.device)
    has_v = torch.any(lv[:, :, None, :] == vals[None, None, :, None], dim=3)
    bad = (acked[:, None, :] == ACK_TRUE) & is_lead[:, :, None] & ~has_v
    return ~bad.flatten(1).any(dim=1)


def inv_committed_majority(lay: Layout, p, states, f: InvFields = RAFT_FIELDS):
    """CommittedEntriesReachMajority — Raft.tla:625-636."""
    S, L = p.n_servers, p.max_log
    st = lay.get(states, "state")
    ci = lay.get(states, f.commit)
    ll = lay.get(states, "log_len")
    lt = lay.get(states, f.log_term)
    lv = lay.get(states, "log_value")
    lead = (st == f.leader) & (ci > 0)  # [B,S]
    pos = torch.clamp(ci - 1, 0, L - 1).to(torch.int64)  # [B,S]
    lt_i = torch.gather(lt, 2, pos[:, :, None])[:, :, 0]  # [B,S]
    lv_i = torch.gather(lv, 2, pos[:, :, None])[:, :, 0]
    B = states.shape[0]
    posj = pos[:, :, None, None].expand(B, S, S, 1)
    lt_j = torch.gather(lt[:, None].expand(B, S, S, L), 3, posj)[..., 0]
    lv_j = torch.gather(lv[:, None].expand(B, S, S, L), 3, posj)[..., 0]
    match = (ll[:, None, :] >= ci[:, :, None]) & (lt_j == lt_i[..., None]) & (
        lv_j == lv_i[..., None])
    enough = match.sum(dim=2) >= (S // 2 + 1)  # quorum incl. i
    return ~torch.any(lead, dim=1) | torch.any(lead & enough, dim=1)


def live_value_all_or_nothing(lay: Layout, p, v: int, states, f: InvFields = RAFT_FIELDS):
    """ValueAllOrNothing(v) — Raft.tla:560-573 (KRaft.tla:867-875): TRUE
    when the last permissible election failed with no leader (progress
    legitimately impossible), else v must be on EVERY server log or on
    NONE."""
    L = p.max_log
    ec = lay.get(states, "electionCtr")
    st = lay.get(states, "state")
    lv = lay.get(states, "log_value")
    ll = lay.get(states, "log_len")
    lanes = torch.arange(L, device=states.device)
    in_log = lanes < ll[..., None]
    has_v = torch.any(in_log & (lv == v + 1), dim=2)  # [B, S]
    all_have = torch.all(has_v, dim=1)
    none_have = ~torch.any(has_v, dim=1)
    no_leader = ~torch.any(st == f.leader, dim=1)
    spent = ec == cv_batch(lay, p, states, "max_elections")
    return (spent & no_leader) | all_have | none_have


def values_not_stuck(model, f: InvFields = RAFT_FIELDS) -> None:
    """Register ValuesNotStuck == \\A v : []<> ValueAllOrNothing(v)
    (Raft.tla:567-576, KRaft.tla:877-879), the temporal property under
    WF_vars(Next) of checker/liveness.py: one (label, P, Q) instance per
    value, P = None for []<>Q, Q naming a state predicate of
    ``model.predicates`` with kernel id PRED_VALUE_AON + v."""
    model.liveness = {"ValuesNotStuck": []}
    for v, vname in enumerate(model.value_names):
        q = f"ValueAllOrNothing({vname})"
        model.predicates[q] = functools.partial(
            live_value_all_or_nothing, model.layout, model.p, v, f=f)
        model._pred_ids[q] = PRED_VALUE_AON + v
        model.liveness["ValuesNotStuck"].append((vname, None, q))


def messages_are_valid_kernel(layout: Layout, packer):
    """MessagesAreValid — MessagePassing.tla:81-83: no record in the bag
    domain is self-addressed. Batched over [..., W] states, for the 2-word
    BitPacker bags (msg_hi/msg_lo) and the N-word WidePacker ones (msg_w*,
    occupancy read from word 0)."""
    from ..ops.packing import EMPTY, WidePacker

    wide = msg_word_fields(layout)

    def kernel(states):
        if isinstance(packer, WidePacker):
            words = tuple(layout.get(states, n) for n in wide)
            occ = words[0] != EMPTY
            src = packer.unpack(words, "msource")
            dst = packer.unpack(words, "mdest")
        else:
            hi = layout.get(states, "msg_hi")
            lo = layout.get(states, "msg_lo")
            occ = hi != EMPTY
            src = packer.unpack(hi, lo, "msource")
            dst = packer.unpack(hi, lo, "mdest")
        return ~torch.any(occ & (src == dst), dim=-1)

    return kernel


def msg_word_fields(layout: Layout) -> list[str]:
    """The names of an N-word bag's key-word fields (kind ``msg_word``) in
    declaration order, word 0 first; empty for a 2-word bag."""
    return [f.name for f in layout.fields.values() if f.kind == "msg_word"]

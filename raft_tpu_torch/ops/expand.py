"""The guard-first expand and the coverage/invariant fold of a chunk, for
every ported spec family.

Each family's actions, invariants and predicates are device code in its
``csrc/*_actions.cuh`` (Raft: ``raft_actions.cuh``; PullRaft:
``pull_actions.cuh``; KRaft: ``kraft_actions.cuh``), driven by kernels
whose drivers the families share (``csrc/expand_driver.cuh``,
``fold_driver.cuh``, ``predicates_driver.cuh``). A family has five
kernels, named after it (``raft_*``, ``pull_*``, ``kraft_*``), each with
its plain PyTorch version beside it here:

  ``guard``       valid/rank/ovf over the [C, A] candidate grid, the
                  chunk scalars (n_gen, terminal, expand_ovf) and the
                  enabled/fired coverage — ``guards1`` of
                  ``raft_tpu/models/base.py:332`` as the sparse branch of
                  ``raft_tpu/checker/device_bfs.py:346-376`` uses it, with
                  the coverage of ``:436-452``;
  ``apply``       successor rows of a compacted worklist —
                  ``sparse_apply`` of ``raft_tpu/models/base.py:426``;
  ``fold``        the new-distinct coverage and the first bad journal
                  index per invariant — ``device_bfs.py:453-460,501-506``;
  ``predicates``  named predicates over rows (the liveness graph's
                  ``_eval_kernel``, ``raft_tpu/checker/liveness.py:254``,
                  and simulate's initial check);
  ``sim_check``   a simulate step's invariant check fused with its
                  settle (``raft_tpu/checker/simulate.py:88-103``), in
                  ``predicates``' source, with its own launch count.

A wrapper runs the plain version for CPU tensors and launches the model's
kernel (``model.KERNELS[role]``; the guard and apply in the build the
model's ``KERNEL_VARIANT`` names) for CUDA tensors (it raises rather than
fall back). The kernels read the model through ``model.kernel_spec``; the
plain versions through the model's ``guards``/``sparse_apply``/
``invariants``/``predicates``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..checker.util import I32_MAX


# ---------------- guard ----------------


def guard_plain(model, states: torch.Tensor, n_live: int, cov: torch.Tensor):
    """Plain version of ``guard``: the dense guard grid, masked by
    live (state index < n_live), its chunk scalars and coverage."""
    C = states.shape[0]
    K = len(model.ACTION_NAMES)
    valid, rank, ovf = model.guards(states)
    live = torch.arange(C, device=states.device) < n_live
    valid = valid & live[:, None]
    scal = torch.stack([valid.sum(), (live & ~valid.any(dim=1)).sum(),
                        (valid & ovf).any().to(torch.int64)])
    # per-action coverage [enabled, fired] per rank (invalid lanes to bucket K)
    rk = torch.where(valid, rank, K).to(torch.int64)
    fired = torch.zeros(K + 1, dtype=torch.int64, device=states.device)
    fired.scatter_add_(0, rk.reshape(-1), torch.ones_like(rk.reshape(-1)))
    en = torch.zeros((C, K + 1), dtype=torch.int64, device=states.device)
    en.scatter_(1, rk, 1)
    cov[:, :2] += torch.stack([en[:, :K].sum(0), fired[:K]], dim=1)
    return valid, rank, ovf, scal


def guard(model, states: torch.Tensor, n_live: int, cov: torch.Tensor):
    """Guard pass over the [C, A] grid of a [C, W] int32 state batch:
    returns (valid [C, A] bool — masked by live, the first ``n_live``
    states —, rank [C, A] int32, ovf [C, A] bool, scal int64 [3] =
    (n_gen, terminal, expand_ovf)) and adds the per-rank enabled and
    fired counts into ``cov[:, 0]`` and ``cov[:, 1]`` (int64 [K, 3], in
    place). No successor row is built."""
    if kernels.route(states) == "cpu":
        return guard_plain(model, states, n_live, cov)
    k = model.KERNELS["guard"]
    C, W = states.shape
    A, K = model.A, len(model.ACTION_NAMES)
    kernels.require(states, torch.int32, "states", shape=(C, model.layout.W))
    kernels.require(cov, torch.int64, "cov", shape=(K, 3))
    spec, cand, _ = model.kernel_spec(states.device)
    dev = states.device
    valid = torch.empty((C, A), dtype=torch.bool, device=dev)
    rank = torch.empty((C, A), dtype=torch.int32, device=dev)
    ovf = torch.empty((C, A), dtype=torch.bool, device=dev)
    scal = torch.empty(3, dtype=torch.int64, device=dev)
    rc = k.launcher(model.KERNEL_VARIANT)(
        states.data_ptr(), C, n_live, spec.data_ptr(), spec.numel(), cand.data_ptr(), A, W, K,
        model.p.n_servers, model.p.msg_slots, valid.data_ptr(), rank.data_ptr(), ovf.data_ptr(),
        scal.data_ptr(), cov.data_ptr(), kernels.stream(dev))
    k.launched(rc)
    return valid, rank, ovf, scal


def guard_occupancy(model) -> dict | None:
    """What the model's guard reaches on the current card where it is the
    group guard (csrc/expand_driver.cuh EXPAND_KERNELS_GROUP, whose library
    exports ``<name>_occupancy``): threads a state (G), threads a block,
    resident blocks and warps an SM at the model's message slots and row
    width (its shared memory grows with them), registers and local (stack)
    bytes a thread. None for a guard of ``guard_body``. Launches nothing."""
    return _occupancy(model.KERNELS["guard"], model.p.msg_slots, model.layout.W)


def _occupancy(k, *args, variant: str = "") -> dict | None:
    """``<name>_occupancy(*args, out)`` of a group kernel's library as a
    dict (the name of the kernel's launcher, or of its ``variant``'s), or
    None where the library has no such launcher."""
    name = k.launcher(variant).__name__ + "_occupancy"
    if not hasattr(k.lib, name):
        return None
    out = (ctypes.c_int * 6)()
    rc = getattr(k.lib, name)(*args, ctypes.cast(out, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"{name}: {k.lib.rt_error_string(rc).decode()}")
    return dict(zip(("G", "threads", "blocks_per_sm", "warps_per_sm", "registers",
                     "stack_bytes"), out))


# ---------------- apply ----------------


def apply_plain(model, states: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain version of ``apply``: the model's ``sparse_apply``."""
    return model.sparse_apply(states, sel, sel < states.shape[0] * model.A)


def apply(model, states: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Successor rows [VC, W] int32 of the worklist ``sel`` (int32 [VC]
    flat candidate ids state * A + candidate; the drop value C * A gives
    a zeros row)."""
    if kernels.route(states) == "cpu":
        return apply_plain(model, states, sel)
    k = model.KERNELS["apply"]
    C, W = states.shape
    kernels.require(states, torch.int32, "states", shape=(C, model.layout.W))
    kernels.require(sel, torch.int32, "sel", ndim=1)
    spec, cand, _ = model.kernel_spec(states.device)
    VC = sel.numel()
    flatc = torch.empty((VC, W), dtype=torch.int32, device=states.device)
    rc = k.launcher(model.KERNEL_VARIANT)(
        states.data_ptr(), C, sel.data_ptr(), VC, spec.data_ptr(), spec.numel(),
        cand.data_ptr(), W, flatc.data_ptr(), kernels.stream(states.device))
    k.launched(rc)
    return flatc


def apply_occupancy(model) -> dict | None:
    """What the model's apply reaches on the current card where it is a
    group apply (csrc/expand_driver.cuh EXPAND_KERNELS_GROUP_APPLY, whose
    library exports ``<name>_occupancy``): threads a worklist lane (G),
    threads a block, resident blocks and warps an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and local
    (stack) bytes a thread, at every row width. None for an apply that
    sizes its blocks by W (``apply_body``). A model's build of the kernel
    (``raft_nf_apply`` for a Raft model with net_faults) is the one read.
    Launches nothing."""
    return _occupancy(model.KERNELS["apply"], variant=model.KERNEL_VARIANT)


# ---------------- fold ----------------


def fold_plain(model, flatc, new, jcount, viol, invariants, cov=None, sel=None,
               valid=None, rank=None) -> None:
    """Plain version of ``fold`` (the reference's formulas)."""
    if cov is not None:
        K = cov.shape[0]
        n_flat = rank.numel()
        sel64 = sel.to(torch.int64).clamp(0, n_flat - 1)
        rk = torch.where(valid.reshape(-1), rank.reshape(-1), K).to(torch.int64)
        flat_rk = torch.where(sel < n_flat, rk.index_select(0, sel64), K)
        newk = torch.zeros(K + 1, dtype=torch.int64, device=flatc.device)
        newk.scatter_add_(0, torch.where(new, flat_rk, K), new.to(torch.int64))
        cov[:, 2] += newk[:K]
    if invariants and new.numel():
        npos = torch.cumsum(new.to(torch.int64), 0) - 1
        jidx = torch.where(new, jcount.reshape(()) + npos, I32_MAX)
        for k, name in enumerate(invariants):
            bad = new & ~model.invariants[name](flatc)
            viol[k] = torch.minimum(viol[k], torch.where(bad, jidx, I32_MAX).min())


def fold(model, flatc, new, jcount, viol, invariants, cov=None, sel=None, valid=None,
         rank=None) -> None:
    """Fold one worklist into the run's accumulators, in place.

    flatc [VC, W] int32 rows, new [VC] bool (the lanes that are new
    distinct states), jcount a one-element int64 tensor (the journal
    cursor before this chunk's append): for each invariant k of
    ``invariants``, viol[k] (int64) becomes min(viol[k], jcount + the
    number of new lanes before the first new lane that violates it).
    With ``cov`` (int64 [K, 3]) given, cov[rank[sel[j]], 2] += 1 for each
    new lane j whose candidate is a valid lane (sel [VC] int32 into the
    flattened valid [C, A] bool / rank [C, A] int32)."""
    if kernels.route(flatc) == "cpu":
        return fold_plain(model, flatc, new, jcount, viol, invariants, cov, sel, valid,
                          rank)
    k = model.KERNELS["fold"]
    dev = flatc.device
    kernels.require(flatc, torch.int32, "flatc", ndim=2)
    kernels.require(new, torch.bool, "new", shape=(flatc.shape[0],))
    kernels.require(jcount, torch.int64, "jcount", shape=(1,))
    kernels.require(viol, torch.int64, "viol")
    if viol.numel() < len(invariants):
        raise ValueError("viol needs one lane per invariant")
    spec, _, inv = model.kernel_spec(dev, tuple(invariants))
    n_flat = 0
    if cov is not None:
        kernels.require(cov, torch.int64, "cov", shape=(len(model.ACTION_NAMES), 3))
        kernels.require(sel, torch.int32, "sel", shape=(flatc.shape[0],))
        kernels.require(valid, torch.bool, "valid")
        kernels.require(rank, torch.int32, "rank", shape=tuple(valid.shape))
        n_flat = valid.numel()
    first_bad = torch.empty(max(1, len(invariants)), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = k.fn(flatc.data_ptr(), flatc.shape[0], new.data_ptr(), ptr(sel),
              ptr(valid), ptr(rank), n_flat, spec.data_ptr(), spec.numel(),
              inv.data_ptr(), len(invariants), first_bad.data_ptr(),
              jcount.data_ptr(), viol.data_ptr(), ptr(cov), kernels.stream(dev))
    k.launched(rc)


# ---------------- predicates ----------------


def predicates_plain(model, rows: torch.Tensor, names) -> torch.Tensor:
    """Plain version of ``predicates``: the model's invariant or
    predicate functions, 65,536 rows at a time."""
    fns = [model.invariants.get(n) or model.predicates[n] for n in names]
    out = torch.empty((len(names), rows.shape[0]), dtype=torch.bool, device=rows.device)
    for off in range(0, rows.shape[0], 1 << 16):
        part = rows[off:off + (1 << 16)]
        for p, fn in enumerate(fns):
            out[p, off:off + part.shape[0]] = fn(part)
    return out


def predicates(model, rows: torch.Tensor, names) -> torch.Tensor:
    """bool [P, N]: predicate ``names[p]`` (an invariant of
    ``model.invariants`` or a liveness predicate of ``model.predicates``)
    on each int32 [N, W] row — the batched predicate calls of
    ``raft_tpu/checker/liveness.py:254``."""
    names = tuple(names)
    if kernels.route(rows) == "cpu":
        return predicates_plain(model, rows, names)
    k = model.KERNELS["predicates"]
    kernels.require(rows, torch.int32, "rows", ndim=2)
    if rows.shape[1] != model.layout.W:
        raise ValueError(f"rows must be [N, {model.layout.W}], got {tuple(rows.shape)}")
    spec, _, ids = model.kernel_spec(rows.device, names)
    out = torch.empty((len(names), rows.shape[0]), dtype=torch.bool, device=rows.device)
    rc = k.fn(rows.data_ptr(), rows.shape[0], spec.data_ptr(), spec.numel(),
              ids.data_ptr(), len(names), out.data_ptr(),
              kernels.stream(rows.device))
    k.launched(rc)
    return out


# ---------------- sim_check (simulate's check and settle) ----------------

NO_WALK = 0x7F7F7F7F7F7F7F7F  # stats[3] when no walk broke an invariant


def sim_check_plain(model, states, nxt, moved, chosen, ridx, init_pool, depth,
                    max_depth: int, journal, jlen, invariants, stats):
    """Plain version of ``sim_check`` (``raft_tpu/checker/simulate.py:
    88-103`` and the journal bookkeeping of :169-185)."""
    R = states.shape[0]
    inv_bad = torch.full((R,), -1, dtype=torch.int32, device=states.device)
    for idx in range(len(invariants) - 1, -1, -1):
        ok = model.invariants[invariants[idx]](nxt)
        inv_bad = torch.where(~ok & moved, idx, inv_bad).to(torch.int32)
    nd = depth + moved.to(torch.int32)
    done = (~moved | (nd >= max_depth)) & (inv_bad < 0)
    w = torch.arange(R, device=states.device)
    J = journal.shape[1]
    app = moved & (jlen < J)
    journal[w[app], jlen[app].long()] = chosen[app]
    jlen += app.to(torch.int32)
    journal[done, 0] = ridx[done]
    jlen[done] = 1
    depth.copy_(torch.where(done, 0, nd))
    nxt.copy_(torch.where(done[:, None], init_pool[ridx.long()],
                          torch.where(moved[:, None], nxt, states)))
    bad = torch.nonzero(inv_bad >= 0)
    stats[2] = done.sum()
    stats[3] = bad[0, 0] if bad.numel() else NO_WALK
    return inv_bad, done


def sim_check(model, states, nxt, moved, chosen, ridx, init_pool, depth, max_depth: int,
              journal, jlen, invariants, stats):
    """One simulate step's check and settle, after ``apply`` wrote the
    moved walks' successors into ``nxt`` [R, W] (zeros where a walk did
    not move). Returns (inv_bad int32 [R]: the first of ``invariants``
    that the walk's new row breaks, -1 if none or not moved; done bool
    [R]) and updates in place: ``nxt`` becomes the walks' next rows (a walk
    that did not move keeps its row of ``states``; a done walk restarts
    from ``init_pool[ridx]``), ``depth`` [R] int32, the journal int32
    [R, J] with its lengths ``jlen`` [R] int32 (chosen appended for a
    moved walk, [ridx] for a done one), stats[2] (done walks) and stats[3]
    (the lowest walk with inv_bad >= 0, ``NO_WALK`` when none)."""
    invariants = tuple(invariants)
    if kernels.route(states) == "cpu":
        return sim_check_plain(model, states, nxt, moved, chosen, ridx, init_pool, depth,
                               max_depth, journal, jlen, invariants, stats)
    k = model.KERNELS["sim_check"]
    R, W = states.shape
    kernels.require(states, torch.int32, "states", shape=(R, model.layout.W))
    kernels.require(nxt, torch.int32, "nxt", shape=(R, W))
    kernels.require(init_pool, torch.int32, "init_pool", ndim=2)
    for t, name in ((chosen, "chosen"), (ridx, "ridx"), (depth, "depth"), (jlen, "jlen")):
        kernels.require(t, torch.int32, name, shape=(R,))
    kernels.require(moved, torch.bool, "moved", shape=(R,))
    kernels.require(journal, torch.int32, "journal", ndim=2)
    kernels.require(stats, torch.int64, "stats", shape=(4,))
    spec, _, inv = model.kernel_spec(states.device, invariants)
    inv_bad = torch.empty(R, dtype=torch.int32, device=states.device)
    done = torch.empty(R, dtype=torch.bool, device=states.device)
    rc = k.fn(
        states.data_ptr(), nxt.data_ptr(), R, moved.data_ptr(), chosen.data_ptr(),
        ridx.data_ptr(), init_pool.data_ptr(), depth.data_ptr(), max_depth, journal.data_ptr(),
        journal.shape[1], jlen.data_ptr(), spec.data_ptr(), spec.numel(), inv.data_ptr(),
        len(invariants), inv_bad.data_ptr(), done.data_ptr(), stats.data_ptr(),
        kernels.stream(states.device))
    k.launched(rc)
    return inv_bad, done


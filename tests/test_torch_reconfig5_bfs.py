"""The port's DeviceBFS on five-server RaftWithReconfigAddRemove
(chip_smoke.py's ADDREMOVE5_CFG at 24 message slots; JointConsensus:
tests/test_torch_joint5_bfs.py) on the CPU against the JAX reference's
dense DeviceBFS: distinct, total, depth,
terminal, depth counts and coverage, equal (tolerance: none). The port's
canon takes the signature-admissible min (its fingerprints are held to
the reference's bit for bit in tests/test_torch_canon_tiers_wide.py); the
reference engine here takes its full S! min, whose programs compile in a
third of the time of its signature tiers: a run's counts and coverage do
not depend on which canonical form it takes. The port's collision audit
(seeds 0 and 0x5EED5EED) and parity gate (chunks 64 and 128) pass there
with the reference's depth counts.
"""

import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.ops import symmetry as ref_symmetry
from raft_tpu_torch.checker.audit import collision_audit
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.parity import parity_gate

from test_expand_sparse import DenseShim
from test_torch_canon_tiers_wide import PARAMS5
from test_torch_reconfig import _models
from test_torch_reconfig_bfs import INV

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def check_five_server_bfs(name, monkeypatch):
    """The port's run, audit and parity gate of PARAMS5[name] to depth 5
    against the reference's dense engine."""
    jm, tm = _models(PARAMS5[name])
    depth = 5
    # the reference engine's canonicalizer takes the min over all S! permutations
    init = ref_symmetry.Canonicalizer.__init__

    def full_min(self, *a, **k):
        init(self, *a, **k)
        self.prune = False

    monkeypatch.setattr(ref_symmetry.Canonicalizer, "__init__", full_min)
    ref = JaxDeviceBFS(DenseShim(jm), invariants=INV, chunk=8, frontier_cap=1 << 11,
                       journal_cap=1 << 13).run(max_depth=depth)
    caps = dict(frontier_cap=1 << 11, journal_cap=1 << 13, max_seen_cap=1 << 16,
                canon_memo_cap=1 << 12)
    res = DeviceBFS(tm, invariants=INV, chunk=64, device="cpu", **caps).run(max_depth=depth)
    assert res.violation is None and ref.violation is None
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert res.distinct > 500
    audit = collision_audit(tm, INV, depth=depth, chunk=64, frontier_cap=1 << 11,
                            journal_cap=1 << 13, device="cpu")
    assert audit.ok and audit.counts[0] == ref.depth_counts, audit
    gate = parity_gate(tm, INV, depth=depth, chunks=(64, 128), frontier_cap=1 << 11,
                       device="cpu")
    assert gate.ok and gate.counts[0] == ref.depth_counts, gate


def test_five_server_device_bfs_matches_reference_dense_engine(monkeypatch):
    check_five_server_bfs("reconfig", monkeypatch)

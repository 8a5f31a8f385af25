"""The port's DeviceBFS on five-server RaftWithReconfigJointConsensus
(chip_smoke.py's JOINT5_CFG at 24 message slots) on the CPU against the
JAX reference's dense DeviceBFS, with the port's collision audit and
parity gate, as tests/test_torch_reconfig5_bfs.py holds AddRemove
(tolerance: none)."""

import torch

from test_torch_reconfig5_bfs import check_five_server_bfs

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def test_five_server_device_bfs_matches_reference_dense_engine(monkeypatch):
    check_five_server_bfs("joint", monkeypatch)

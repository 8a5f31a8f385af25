"""raft_tpu_torch stands alone: importing it pulls in neither jax nor
raft_tpu, and its entry points default to cuda and refuse to fall back to
the CPU when no card is visible."""

import os
import subprocess
import sys

import pytest
import torch

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "raft_tpu_torch", "raft_tpu_torch.__main__", "raft_tpu_torch.convert",
    "raft_tpu_torch.kernels", "raft_tpu_torch.ops.symmetry", "raft_tpu_torch.ops.expand",
    "raft_tpu_torch.models.registry", "raft_tpu_torch.checker.device_bfs",
    "raft_tpu_torch.utils.pprint", "raft_tpu_torch.ops.prng", "raft_tpu_torch.ops.hashing",
    "raft_tpu_torch.checker.simulate", "raft_tpu_torch.checker.liveness",
    "raft_tpu_torch.models.pull_raft", "raft_tpu_torch.models.kraft",
    "raft_tpu_torch.models.config_common", "raft_tpu_torch.models.reconfig_raft",
    "raft_tpu_torch.models.joint_raft", "raft_tpu_torch.ops.bag",
    "raft_tpu_torch.models.kraft_reconfig", "raft_tpu_torch.ops.slot_canon",
]


def test_imports_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'raft_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_cuda_and_raises_without_card():
    from raft_tpu_torch import resolve_device
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.liveness import LivenessChecker
    from raft_tpu_torch.checker.simulate import Simulator
    from raft_tpu_torch.models.raft import RaftModel, RaftParams

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    model = RaftModel(RaftParams(n_servers=2, n_values=1, max_elections=1,
                                 max_restarts=0, msg_slots=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBFS(model, chunk=64, frontier_cap=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LivenessChecker(model, ("ValuesNotStuck",))
    assert resolve_device("cpu").type == "cpu"

"""``python -m raft_tpu_torch`` end to end on the CPU: exit codes 0 (clean),
2 (violation, trace printed), 5 (no card and no ``--device cpu``), 64 (spec
not yet ported) and 66 (no file)."""

import json
import os
import subprocess
import sys

import pytest
import torch

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
    Value = { v1 }
    MaxElections = 2
    MaxRestarts = 0
"""
TAIL = """\
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
"""


def _cli(path, *args):
    return subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch", str(path), "--device", "cpu",
         "--chunk", "256", "--msg-slots", "16", "--frontier-cap", "4096", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_clean_run_rc0(tmp_path):
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    out = _cli(cfg, "--max-depth", "6", "--json")
    assert out.returncode == 0, out.stderr
    assert "no invariant violations" in out.stdout
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["depth"] == 6 and summary["violation"] is None
    assert summary["device"] == "cpu"


def test_violation_rc2_prints_trace(tmp_path):
    # FlexibleRaft with non-intersecting quorums loses an acked value
    cfg = tmp_path / "FlexibleRaft.cfg"
    cfg.write_text(HEAD + "    ElectionQuorumSize = 1\n    ReplicationQuorumSize = 1\n" + TAIL)
    out = _cli(cfg)
    assert out.returncode == 2, out.stderr
    assert "INVARIANT LeaderHasAllAckedValues VIOLATED (depth 6)" in out.stdout
    assert out.stdout.count("State ") == 7 and "<Initial predicate>" in out.stdout


def test_unported_spec_rc64_and_missing_file_rc66(tmp_path):
    cfg = tmp_path / "KRaftWithReconfig.cfg"
    cfg.write_text(HEAD + TAIL)
    out = _cli(cfg)
    assert out.returncode == 64 and "not yet ported" in out.stderr
    assert _cli(tmp_path / "Missing.cfg").returncode == 66


def test_default_device_without_card_rc5(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible, so the default device runs")
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    out = subprocess.run([sys.executable, "-m", "raft_tpu_torch", str(cfg), "--max-depth", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 5 and "no CUDA device" in out.stderr
    assert "distinct=" not in out.stdout

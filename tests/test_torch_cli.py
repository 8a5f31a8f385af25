"""``python -m raft_tpu_torch`` end to end on the CPU: exit codes 0 (clean),
2 (violation, trace printed), 3 (``--coverage=strict`` with an action that
never fired), 5 (no card and no ``--device cpu``), 64 (a spec with no
lowering, a cfg a strict parse refuses, ``--coverage`` or
``--collision-audit`` with ``--simulate``, an unported ``--checker``, a bad
``--devices``, ``--no-reshard`` against another mesh size), 66 (no file, no
``--resume`` file) and 70 (the collision audit's two hash families
disagree); ``--checker tpu`` / ``$CHECKER`` and ``--checker sharded`` on
gloo CPU processes."""

import json
import os
import subprocess
import sys

import pytest
import torch

from raft_tpu.obs.coverage import render_coverage_table as ref_render_coverage_table
from raft_tpu_torch import __main__ as cli
from raft_tpu_torch.checker import audit

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
    # every spec of the reference is ported: a spec name with no builder
    # still exits 64
    cfg = tmp_path / "NoSuchSpec.cfg"
    cfg.write_text(HEAD + TAIL)
    out = _cli(cfg)
    assert out.returncode == 64 and "no lowering registered for spec 'NoSuchSpec'" in out.stderr
    assert "KRaftWithReconfig" in out.stderr  # among the available specs
    assert _cli(tmp_path / "Missing.cfg").returncode == 66


KRAFT_RECONFIG_SMALL = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Hosts = { n1, n2, n3 }
    Value = { v1, v2 }
    InitClusterSize = 2
    MinClusterSize = 2
    MaxClusterSize = 3
    MaxSpawnedServers = 4
    MaxElections = 1
    MaxRestarts = 1
    MaxValuesPerEpoch = 1
    MaxAddReconfigs = 1
    MaxRemoveReconfigs = 1
INIT Init
NEXT Next
VIEW view
SYMMETRY symmHostsAndValues
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    NeverTwoLeadersInSameEpoch
    NoIllegalState
    StatesMatchRoles
"""


def test_kraft_reconfig_strict_rc64_lenient_runs(tmp_path):
    # the reference cfg's undeclared v2: a strict parse exits 64 naming it,
    # --lenient declares it and runs (the reference's counts at depth 2)
    cfg = tmp_path / "KRaftWithReconfig.cfg"
    cfg.write_text(KRAFT_RECONFIG_SMALL)
    out = _cli(cfg, "--max-depth", "2")
    assert out.returncode == 64 and "undeclared model value 'v2'" in out.stderr
    out = _cli(cfg, "--lenient", "--max-depth", "2", "--msg-slots", "24", "--chunk", "64")
    assert out.returncode == 0, out.stderr
    assert "distinct=55 total=76 depth=2" in out.stdout, out.stdout


def test_default_device_without_card_rc5(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible, so the default device runs")
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    out = subprocess.run([sys.executable, "-m", "raft_tpu_torch", str(cfg), "--max-depth", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 5 and "no CUDA device" in out.stderr
    assert "distinct=" not in out.stdout


def test_coverage_table_and_strict_rc3(tmp_path):
    # at depth 3 no value is committed yet: AdvanceCommitIndex never fires
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    out = _cli(cfg, "--max-depth", "3", "--coverage", "--json")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    start = lines.index("Action coverage (cumulative over the run):")
    table = lines[start:-1]
    assert "WARNING: action AdvanceCommitIndex never fired" in table
    # the table is the reference renderer's on the same counts (Raft's 12
    # Next disjuncts)
    rows = [ln.split() for ln in table[2:] if not ln.startswith("WARNING")]
    names, counts = [r[0] for r in rows], [[int(x) for x in r[1:]] for r in rows]
    assert len(rows) == 12 and names[0] == "Restart"
    assert "\n".join(table) == ref_render_coverage_table(names, counts)
    strict = _cli(cfg, "--max-depth", "3", "--coverage=strict")
    assert strict.returncode == 3, strict.stderr
    assert strict.stdout.count("never fired") == out.stdout.count("never fired") > 0


def test_audit_and_coverage_refuse_simulate_rc64(tmp_path):
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    for flags in (["--coverage"], ["--coverage=strict"], ["--collision-audit", "3"]):
        assert cli.main([str(cfg), "--device", "cpu", "--simulate", "4", *flags]) == 64


def test_collision_audit_passes_rc0_and_mismatch_rc70(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    args = [str(cfg), "--device", "cpu", "--chunk", "256", "--msg-slots", "16",
            "--max-depth", "4", "--collision-audit", "4"]
    assert cli.main(args) == 0
    assert "collision audit PASS: depth=4 seeds=(0, 1592614637)" in capsys.readouterr().err

    class SecondFamilyMiscounts(audit.DeviceBFS):
        """The engine, whose run under the second hash family loses a state
        at the last depth (as a fingerprint collision would)."""

        def __init__(self, *a, fingerprint_seed=0, **k):
            super().__init__(*a, fingerprint_seed=fingerprint_seed, **k)
            self.seed = fingerprint_seed

        def run(self, *a, **k):
            res = super().run(*a, **k)
            if self.seed:
                res.depth_counts[-1] -= 1
            return res

    monkeypatch.setattr(audit, "DeviceBFS", SecondFamilyMiscounts)
    assert cli.main(args) == 70
    err = capsys.readouterr().err
    assert "collision audit FAIL" in err and "counts differ between hash families" in err


def _summary(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("distinct="))


def test_checker_flag_and_env(tmp_path, capsys, monkeypatch):
    """--checker tpu (and $CHECKER) run DeviceBFS: Raft.cfg's constants to
    depth 6 give distinct=128 total=252; sharded on two gloo CPU processes
    gives the same line plus devices=2; the reference's tpu-host and
    oracle checkers exit 64 naming their ROADMAP.md Queue 1 items."""
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD + TAIL)
    args = [str(cfg), "--device", "cpu", "--max-depth", "6", "--chunk", "256"]
    assert cli.main([*args, "--checker", "tpu"]) == 0
    line = _summary(capsys.readouterr().out)
    assert line.startswith("distinct=128 total=252 depth=6 ")
    monkeypatch.setenv("CHECKER", "tpu")
    assert cli.main(args) == 0
    assert _summary(capsys.readouterr().out).startswith("distinct=128 total=252 depth=6 ")
    monkeypatch.delenv("CHECKER")
    assert cli.main([*args, "--checker", "sharded", "--devices", "2"]) == 0
    sline = _summary(capsys.readouterr().out)
    assert sline.split(" time=")[0] == line.split(" time=")[0]
    assert sline.endswith(" devices=2")
    for checker, item in (("tpu-host", 2), ("oracle", 6)):
        assert cli.main([*args, "--checker", checker]) == 64
        assert f"Queue 1 item {item}" in capsys.readouterr().err


def test_sharded_flag_errors_and_resume_codes(tmp_path, capsys):
    """--devices 0 and --devices without --checker sharded exit 64, a
    missing --resume file 66, and --no-reshard refuses a checkpoint of
    another mesh size with 64, naming both sizes."""
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(HEAD.replace("    n3 = n3\n", "").replace(", n3 }", " }") + TAIL)
    args = [str(cfg), "--device", "cpu", "--chunk", "256", "--msg-slots", "16"]
    sharded = [*args, "--checker", "sharded"]
    assert cli.main([*sharded, "--devices", "0"]) == 64
    assert cli.main([*args, "--devices", "2"]) == 64
    assert cli.main([*args, "--resume", str(tmp_path / "none.npz")]) == 66
    assert cli.main([*sharded, "--resume", str(tmp_path / "none.npz")]) == 66
    path = str(tmp_path / "run.npz")
    assert cli.main([*sharded, "--devices", "2", "--max-depth", "3", "--checkpoint", path,
                     "--checkpoint-every", "0"]) == 0
    capsys.readouterr()
    assert cli.main([*sharded, "--devices", "1", "--resume", path, "--no-reshard"]) == 64
    err = capsys.readouterr().err
    assert "D=2 mesh" in err and "D=1" in err
    assert cli.main([*sharded, "--devices", "1", "--resume", path]) == 0
    out = capsys.readouterr()
    assert "resume: validated" in out.err and _summary(out.out).endswith(" devices=1")

"""Checkpoints of the port's engines against the reference's format and
engines: ``resilience/ckpt.py``'s content hash and generations, the
sharded engine's mesh-portable payload (a checkpoint of the reference's
``ShardedBFS`` at D = 2 resumed by the port at D = 2 and D = 1, the port's
own resharded, ``reshard=False`` refused naming both mesh sizes, a payload
without the jfp lane refused with exit 64), and ``DeviceBFS``'s checkpoint
read back by the port and by the reference's dense engine."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.parallel.sharded import ShardedBFS as JaxShardedBFS
from raft_tpu.resilience import ckpt as jax_ckpt
from raft_tpu_torch import __main__ as cli
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.parallel.launch import run_sharded
from raft_tpu_torch.resilience import ckpt
from raft_tpu_torch.resilience.errors import CheckpointCorrupt, CheckpointMismatch

from test_expand_sparse import DenseShim

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

PARAMS = RaftParams(n_servers=2, n_values=1, max_elections=1, max_restarts=0, msg_slots=16)
INV = ("NoLogDivergence",)
CAPS = dict(chunk=256, frontier_cap=1024, seen_cap=1 << 12)
PP = params_from_reference(dataclasses.asdict(PARAMS))
BUILD = functools.partial(RaftModel, PP)


def counts(res):
    return (res.distinct, res.total, res.terminal, res.depth, list(res.depth_counts))


def test_content_hash_and_generations(tmp_path):
    payload = dict(spec="x/D=2", a=np.arange(5, dtype=np.int32),
                   b=np.full((2, 3), 7, np.uint64), c=np.int64(3))
    assert ckpt.content_hash(payload) == jax_ckpt.content_hash(payload)
    path = str(tmp_path / "sub" / "run.npz")
    for depth in range(3):
        ckpt.save_npz(path, dict(payload, depth=np.int64(depth)), keep=3)
    assert [os.path.exists(ckpt.generation_path(path, g)) for g in range(4)] == [
        True, True, True, False]
    got, gen, skipped = ckpt.load_npz(path, keep=3)
    assert (int(got["depth"]), gen, skipped) == (2, 0, [])
    # the reference reads the port's file, hash and all
    ref, ref_gen, _ = jax_ckpt.load_npz(path, keep=3)
    assert int(ref["depth"]) == 2 and ref_gen == 0
    with open(path, "r+b") as fh:  # a torn newest write
        fh.truncate(100)
    got, gen, skipped = ckpt.load_npz(path, keep=3)
    assert (int(got["depth"]), gen, len(skipped)) == (1, 1, 1)
    for g in range(3):
        with open(ckpt.generation_path(path, g), "wb") as fh:
            fh.write(b"junk")
    with pytest.raises(CheckpointCorrupt):
        ckpt.load_npz(path, keep=3)
    with pytest.raises(FileNotFoundError):
        ckpt.load_npz(str(tmp_path / "none.npz"))
    # spec checks: the reference's messages
    with pytest.raises(CheckpointMismatch, match="checkpoint is for spec"):
        ckpt.check_spec({"spec": "a/D=2"}, "b/D=2", path)
    with pytest.raises(CheckpointMismatch, match="D=2 mesh.*D=1"):
        ckpt.check_spec({"spec": "a/D=2/x"}, "a/D=1/x", path)
    ckpt.check_spec({"spec": "a/D=2/x"}, "a/D=1/x", path, allow_reshard=True)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """The reference's ShardedBFS at D = 2 stopped at depth 4 with a
    checkpoint, and its engine's ident."""
    path = str(tmp_path_factory.mktemp("ref") / "sh.npz")
    engine = JaxShardedBFS(DenseShim(cached_model(PARAMS)), invariants=INV,
                           devices=jax.devices()[:2], canon_memo_cap=0, **CAPS)
    r1 = engine.run(max_depth=4, checkpoint_path=path, checkpoint_every_s=0.0)
    assert r1.depth == 4 and not r1.exhausted
    return path, engine._ckpt_ident()


@pytest.fixture(scope="module")
def uninterrupted():
    return DeviceBFS(RaftModel(PP), invariants=INV, device="cpu", **CAPS).run()


@pytest.mark.parametrize("D", [2, 1])
def test_reference_sharded_checkpoint_resumes_in_the_port(reference_checkpoint,
                                                          uninterrupted, D):
    path, ref_ident = reference_checkpoint
    engine, res = run_sharded(BUILD, D, device="cpu", engine_kw=dict(invariants=INV, **CAPS),
                              run_kw=dict(resume=path))
    if D == 2:
        assert engine._ckpt_ident() == ref_ident
    assert res.exhausted and counts(res) == counts(uninterrupted)


def test_port_sharded_checkpoint_reshards_and_refuses(tmp_path, uninterrupted):
    path = str(tmp_path / "p2.npz")
    _, r1 = run_sharded(BUILD, 2, device="cpu", engine_kw=dict(invariants=INV, **CAPS),
                        run_kw=dict(max_depth=5, checkpoint_path=path, checkpoint_every_s=0.0))
    assert r1.depth == 5 and not r1.exhausted
    with pytest.raises(CheckpointMismatch) as e:
        run_sharded(BUILD, 1, device="cpu", engine_kw=dict(invariants=INV, **CAPS),
                    run_kw=dict(resume=path, reshard=False))
    assert "D=2 mesh" in str(e.value) and "D=1" in str(e.value)
    _, res = run_sharded(BUILD, 1, device="cpu", engine_kw=dict(invariants=INV, **CAPS),
                         run_kw=dict(resume=path))
    assert res.exhausted and counts(res) == counts(uninterrupted)


def test_device_bfs_checkpoint_resumes_here_and_in_the_reference(tmp_path, uninterrupted):
    path = str(tmp_path / "dev.npz")
    r1 = DeviceBFS(RaftModel(PP), invariants=INV, device="cpu", **CAPS).run(
        max_depth=4, checkpoint_path=path, checkpoint_every_s=0.0)
    assert r1.depth == 4 and not r1.exhausted
    r2 = DeviceBFS(RaftModel(PP), invariants=INV, device="cpu", **CAPS).run(resume=path)
    assert r2.exhausted and counts(r2) == counts(uninterrupted)
    assert r2.coverage == uninterrupted.coverage
    jax_engine = JaxDeviceBFS(DenseShim(cached_model(PARAMS)), invariants=INV,
                              canon_memo_cap=0, **CAPS)
    assert jax_engine._ckpt_ident() == DeviceBFS(RaftModel(PP), invariants=INV,
                                                 device="cpu")._ckpt_ident()
    r3 = jax_engine.run(resume=path)
    assert r3.exhausted and counts(r3) == counts(uninterrupted)


CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    v1 = v1
    Server = { n1, n2 }
    Value = { v1 }
    MaxElections = 1
    MaxRestarts = 0
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    NoLogDivergence
"""


def test_cli_resume_refuses_a_payload_without_jfp(tmp_path, capsys):
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(CFG)
    path = str(tmp_path / "s.npz")
    base = [str(cfg), "--device", "cpu", "--checker", "sharded", "--devices", "1",
            "--chunk", "256", "--msg-slots", "16"]
    assert cli.main([*base, "--max-depth", "3", "--checkpoint", path,
                     "--checkpoint-every", "0"]) == 0
    ck, _gen, _ = ckpt.load_npz(path)
    v1 = {k: v for k, v in ck.items()
          if k not in ("jfp", "format_version", "content_hash")}
    v1["version"] = np.int64(1)
    ckpt.save_npz(path, v1)
    capsys.readouterr()
    assert cli.main([*base, "--resume", path]) == 64
    err = capsys.readouterr().err
    assert "jfp" in err and "Queue 1 item 3" in err

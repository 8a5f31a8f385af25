"""The port's PullRaft and PullRaftVariant2 (raft_tpu_torch/models/
pull_raft.py, the plain versions of the pull kernels) against the JAX
reference, bit for bit, on the CPU:

  - the layout and message packer, field for field;
  - the batched expand against the dense ``jax.vmap(_expand1)`` on
    reachable states (succs, valid, rank, ovf), and the guard grid and
    the worklist apply against the dense grid and the reference's
    ``sparse_apply``;
  - every registered invariant, decode/encode, the initial state and the
    action labels;
  - the CLI: a strict parse of the reference cfg's undeclared ``v2`` is
    refused, ``--lenient`` repairs it, PROPERTY is refused (PullRaft has no
    liveness formula), ``--simulate`` runs.

The canonical fingerprints and the BFS engine are held in
tests/test_torch_pull_bfs.py (a file of its own, so that the two share
the test workers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.models.pull_raft import PullRaftParams, cached_model
from raft_tpu.oracle.pull_oracle import PullRaftOracle
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.checker.util import dense_prefix_sel
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.pull_raft import PullRaftModel
from raft_tpu_torch.ops.expand import apply, guard

from conftest import collect_states

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_pull_raft.py's PARAMS
PARAMS = {
    "pull": PullRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                           msg_slots=40),
    "pull2": PullRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                            msg_slots=40, variant2=True),
    "pull2_restart": PullRaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=1,
                                    msg_slots=48, variant2=True),
}
INV = ("LeaderHasAllAckedValues", "NoLogDivergence")


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, port model, reachable batch, its dense (succs, valid,
    rank, ovf) as numpy)."""
    jp = PARAMS[name]
    jm = cached_model(jp)
    tm = PullRaftModel(params_from_reference(dataclasses.asdict(jp)))
    oracle = PullRaftOracle(jp.n_servers, jp.n_values, jp.max_elections, jp.max_restarts,
                            variant2=jp.variant2)
    batch = np.stack([jm.encode(s) for s in collect_states(oracle, 8, cap=120)])
    batch = batch.astype(np.int32)
    return jm, tm, batch, [np.array(x) for x in jax.device_get(jm.expand(batch))]


@pytest.mark.parametrize("name", list(PARAMS))
def test_layout_and_packer_match_reference(name):
    jm, tm, _batch, _dense = _pair(name)
    assert {k: (f.kind, f.offset, f.shape) for k, f in tm.layout.fields.items()} == {
        k: (f.kind, f.offset, f.shape) for k, f in jm.layout.fields.items()}
    assert (tm.layout.W, tm.layout.view_len) == (jm.layout.W, jm.layout.view_len)
    assert tm.packer.fields == jm.packer.fields
    assert tm.bindings == jm.bindings and tm.A == jm.A
    assert tm.ACTION_NAMES == jm.ACTION_NAMES and tm.name == jm.name


@pytest.mark.parametrize("name", list(PARAMS))
def test_expand_bit_identical(name):
    _jm, tm, batch, want = _pair(name)
    got = [x.numpy() for x in tm.expand(torch.from_numpy(batch))]
    for label, w, g in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert w.shape == g.shape and np.array_equal(w, g), label
    assert want[1].sum() > len(batch)  # the batch really has enabled actions


@pytest.mark.parametrize("name", list(PARAMS))
def test_guard_and_apply_match_reference(name):
    jm, tm, batch, (_succs, valid, rank, ovf) = _pair(name)
    C = len(batch)
    assert [(g.name, g.off, g.n) for g in tm.sparse_groups()] == [
        (g.name, g.off, g.n) for g in jm.sparse_groups()]
    n_live = C - 5
    cov = torch.zeros((len(tm.ACTION_NAMES), 3), dtype=torch.int64)
    gv, gr, go, scal = guard(tm, torch.from_numpy(batch), n_live, cov)
    live = np.arange(C) < n_live
    want_v = valid & live[:, None]
    assert np.array_equal(gv.numpy(), want_v)
    assert np.array_equal(gr.numpy(), rank) and np.array_equal(go.numpy(), ovf)
    assert scal.tolist() == [int(want_v.sum()), int((live & ~want_v.any(1)).sum()),
                             int((want_v & ovf).any())]
    sel, n = dense_prefix_sel(torch.from_numpy(valid.reshape(-1).copy()),
                              int(valid.sum()) + 9, C * jm.A)
    sel = sel.numpy()
    selv = sel < C * jm.A
    plan = jm.sparse_plan(C, len(sel))
    ref, apply_ovf = jax.device_get(jax.jit(jm.sparse_apply, static_argnums=3)(
        jnp.asarray(batch), jnp.asarray(sel), jnp.asarray(selv), plan))
    got = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel)).numpy()
    assert not apply_ovf and np.array_equal(got, np.asarray(ref))
    assert not got[~selv].any() and got[selv].any()


@pytest.mark.parametrize("name", list(PARAMS))
def test_invariants_init_decode_encode(name):
    jm, tm, batch, (succs, *_rest) = _pair(name)
    flat = succs.reshape(-1, jm.layout.W)[::3]
    for states in (batch, flat):
        for inv in jm.invariants:
            want = np.asarray(jm.invariants[inv](states))
            assert np.array_equal(tm.invariants[inv](torch.from_numpy(states)).numpy(), want), inv
    assert set(tm.invariants) == set(jm.invariants)
    assert np.array_equal(tm.init_states(), jm.init_states())
    for row in batch[:40]:
        st = tm.decode(row)
        assert st == jm.decode(row)
        assert np.array_equal(tm.encode(st), jm.encode(st)) and np.array_equal(tm.encode(st), row)
    assert [tm.action_label(r, c) for c in range(tm.A) for r in (1, 9)] == [
        jm.action_label(r, c) for c in range(jm.A) for r in (1, 9)]


# PullRaft.cfg as SURVEY.md records it: Value = {v1, v2} with only v1
# declared as a model value (PullRaft.cfg:9-11)
PULL_CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
    Value = { v1, v2 }
    MaxElections = 1
    MaxRestarts = 0
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
"""


def _cli(capsys, path, *args):
    """The CLI's ``main`` in this process: (rc, stdout, stderr)."""
    rc = main([str(path), "--device", "cpu", "--chunk", "256", "--msg-slots", "24",
               "--frontier-cap", "4096", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_pull_specs(tmp_path, capsys):
    cfg = tmp_path / "PullRaftVariant2.cfg"
    cfg.write_text(PULL_CFG)
    rc, _out, err = _cli(capsys, cfg, "--max-depth", "4")
    assert rc == 64 and "v2" in err
    rc, out, err = _cli(capsys, cfg, "--lenient", "--max-depth", "10")
    assert rc == 0, err
    assert "spec=PullRaftVariant2" in err and "no invariant violations" in out
    assert "distinct=123 total=279 depth=10 terminal=0" in out
    rc, out, err = _cli(capsys, cfg, "--lenient", "--spec", "PullRaft", "--simulate", "8",
                        "--sim-walks", "4", "--sim-depth", "10")
    assert rc == 0, err
    assert "spec=PullRaft " in err and "no invariant violations" in out
    prop = tmp_path / "PullRaft.cfg"
    prop.write_text(PULL_CFG + "PROPERTY\n    ValuesNotStuck\n")
    rc, _out, err = _cli(capsys, prop, "--lenient")
    assert rc == 64 and "no liveness support" in err

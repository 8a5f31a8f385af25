"""Simulation mode of the port (raft_tpu_torch.checker.simulate) against
the JAX package's Simulator on the CPU: the same walks step for step for
the same seed (Raft, the pull family's PullRaftVariant2 and KRaft) (states,
depth, chosen candidate, done, restart index, invariant verdicts,
journals), the same behaviors and steps, the same violation and trace, and
the CLI's ``--simulate`` exit codes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.simulate import Simulator as JaxSimulator
from raft_tpu.models import kraft as jax_kraft
from raft_tpu.models import pull_raft as jax_pull
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.models.registry import build_from_cfg as jax_build
from raft_tpu.utils.cfg import parse_cfg as jax_parse
from raft_tpu_torch.checker.simulate import Simulator, sim_pick_plain
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.kraft import KRaftModel
from raft_tpu_torch.models.pull_raft import PullRaftModel
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.models.registry import build_from_cfg
from raft_tpu_torch.ops import prng
from raft_tpu_torch.utils.cfg import parse_cfg

from test_torch_cli import HEAD, TAIL

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_simulate.py's configuration
PARAMS = RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=32)
# the step test's families: (reference model, port model class); the pull
# family's is tests/test_pull_raft.py's Variant2 with two values and a restart,
# KRaft's tests/test_kraft.py's second set (two values and a restart)
FAMILIES = {
    "raft": (lambda: cached_model(PARAMS), RaftModel),
    "pull": (lambda: jax_pull.cached_model(jax_pull.PullRaftParams(
        n_servers=3, n_values=2, max_elections=2, max_restarts=1, msg_slots=48,
        variant2=True)), PullRaftModel),
    "kraft": (lambda: jax_kraft.cached_model(jax_kraft.KRaftParams(
        n_servers=3, n_values=2, max_elections=2, max_restarts=1, msg_slots=64)), KRaftModel),
}
INVS = ("LeaderHasAllAckedValues", "NoLogDivergence")
WALKS, DEPTH, SEED, BEHAVIORS = 16, 12, 7, 32
# FlexibleRaft with quorums that need not intersect (3 servers, 2 + 1):
# LeaderHasAllAckedValues fails; 16 walks of depth 20 from seed 0 find it
FLEX_CFG = HEAD + "    ElectionQuorumSize = 2\n    ReplicationQuorumSize = 1\n" + TAIL


def _key(k) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(k).tolist())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_steps_equal_reference(family):
    """Drive the reference's jitted step and the port's step side by side
    with the reference's key sequence (``Simulator.run``'s): every
    per-walk output and the port's on-device journals must agree."""
    make_ref, model_cls = FAMILIES[family]
    jm = make_ref()
    tm = model_cls(params_from_reference(dataclasses.asdict(jm.p)))
    js = JaxSimulator(jm, invariants=INVS, walks=WALKS, max_behavior_depth=DEPTH, seed=SEED)
    ts = Simulator(tm, invariants=INVS, walks=WALKS, max_behavior_depth=DEPTH, seed=SEED,
                   device="cpu")
    assert ts.start() is None
    rng = jax.random.PRNGKey(SEED)
    init_pool = jnp.asarray(jm.init_states())
    rng, k0 = jax.random.split(rng)
    init_idx = np.asarray(jax.random.randint(k0, (WALKS,), 0, init_pool.shape[0]))
    states = init_pool[jnp.asarray(init_idx)]
    depth = jnp.zeros(WALKS, dtype=jnp.int32)
    journal = [[int(i)] for i in init_idx]
    assert np.array_equal(ts.states.numpy(), np.asarray(states))
    behaviors = steps = n_steps = 0
    while behaviors < BEHAVIORS:
        rng, key = jax.random.split(rng)
        states, depth, chosen, moved, done, ridx, inv_bad, ovf = (
            np.asarray(x) for x in js._step(states, depth, init_pool, key))
        n_moved, t_ovf, n_done, bad = ts.step()
        assert ts.rng == _key(rng)
        last = {k: v.numpy() for k, v in ts.last.items()}
        assert np.array_equal(ts.states.numpy(), states)
        assert np.array_equal(ts.depth.numpy(), depth)
        for name, want in (("chosen", chosen), ("moved", moved), ("done", done),
                           ("ridx", ridx), ("inv_bad", inv_bad)):
            assert np.array_equal(last[name], want), (n_steps, name)
        assert (n_moved, bool(t_ovf), n_done) == (moved.sum(), bool(ovf), done.sum())
        assert (inv_bad < 0).all() and bad == 0x7F7F7F7F7F7F7F7F
        for w in np.nonzero(moved)[0]:
            journal[w].append(int(chosen[w]))
        for w in np.nonzero(done)[0]:
            journal[w] = [int(ridx[w])]
        for w in range(WALKS):
            assert ts.journal[w, : int(ts.jlen[w])].tolist() == journal[w], (n_steps, w)
        steps += int(moved.sum())
        behaviors += int(done.sum())
        n_steps += 1
        states, depth = jnp.asarray(states), jnp.asarray(depth)
    res = Simulator(tm, invariants=INVS, walks=WALKS, max_behavior_depth=DEPTH, seed=SEED,
                    device="cpu").run(max_behaviors=BEHAVIORS)
    assert (res.behaviors, res.steps, res.violation) == (behaviors, steps, None)
    jres = js.run(max_behaviors=BEHAVIORS)
    assert (jres.behaviors, jres.steps) == (res.behaviors, res.steps)


def test_pick_plain_matches_reference_formulas():
    """sim_pick's plain version against the reference's pick and restart
    draw, on random valid grids with empty rows (walks that cannot move)."""
    rng = np.random.default_rng(5)
    valid = rng.random((300, 37)) < 0.08
    valid[::7] = False
    ovf = rng.random((300, 37)) < 0.5
    key = jax.random.PRNGKey(99)
    ku, kr = jax.random.split(key)
    n_valid = valid.sum(axis=1)
    u = np.asarray(jax.random.uniform(ku, (300,)))
    k = np.floor(u * np.maximum(n_valid, 1)).astype(np.int32)
    chosen = np.asarray(jnp.argmax(jnp.cumsum(valid, axis=1) > k[:, None], axis=1))
    ridx = np.asarray(jax.random.randint(kr, (300,), 0, 5))
    stats = torch.zeros(4, dtype=torch.int64)
    got = sim_pick_plain(torch.from_numpy(valid), torch.from_numpy(ovf), _key(key), 5, stats)
    moved = n_valid > 0
    assert np.array_equal(got[0].numpy(), chosen) and np.array_equal(got[1].numpy(), moved)
    sel = np.where(moved, np.arange(300) * 37 + chosen, 300 * 37)
    assert np.array_equal(got[2].numpy(), sel) and np.array_equal(got[3].numpy(), ridx)
    assert stats[0] == moved.sum()
    assert bool(stats[1]) == bool((ovf[np.arange(300), chosen] & moved).any())


def test_flexible_raft_violation_equal_reference():
    """The non-intersecting quorums' LeaderHasAllAckedValues violation:
    the same invariant, walk, depth, behaviors, steps and trace. The
    reference's trace is taken from its own journal through its jitted
    ``model.expand`` (the same ``vmap(_expand1)`` its replay runs
    unjitted)."""
    jsetup = jax_build(jax_parse("FlexibleRaft.cfg", text=FLEX_CFG), msg_slots=32)
    tsetup = build_from_cfg(parse_cfg("FlexibleRaft.cfg", text=FLEX_CFG), msg_slots=32)
    jm = jsetup.model
    js = JaxSimulator(jm, invariants=jsetup.invariants, walks=16, max_behavior_depth=20,
                      seed=0)

    def replay(init, journal):
        state = np.asarray(init[journal[0]])
        out = [("Initial predicate", jm.decode(state))]
        for cand in journal[1:]:
            succs, valid, rank, _ovf = jax.device_get(jm.expand(state[None, :]))
            assert valid[0, cand]
            state = np.asarray(succs[0, cand])
            out.append((jm.action_label(int(rank[0, cand]), cand), jm.decode(state)))
        return out

    js._replay = replay
    want = js.run(max_steps=5000)
    got = Simulator(tsetup.model, invariants=tsetup.invariants, walks=16,
                    max_behavior_depth=20, seed=0, device="cpu").run(max_steps=5000)
    assert want.violation is not None
    assert dataclasses.astuple(got.violation) == dataclasses.astuple(want.violation)
    assert (got.behaviors, got.steps) == (want.behaviors, want.steps)
    assert got.trace == want.trace
    assert len(got.trace) == got.violation.depth + 1


def test_initial_state_violation_and_prng_keys():
    """An invariant that fails on Init is reported at walk 0, depth 0 with
    the initial state as its trace; the walks draw from the reference's
    key sequence."""
    tm = RaftModel(params_from_reference(dataclasses.asdict(PARAMS)))
    tm.invariants["NoInit"] = lambda s: torch.zeros(s.shape[0], dtype=torch.bool)
    res = Simulator(tm, invariants=("NoLogDivergence", "NoInit"), walks=4,
                    device="cpu").run(max_steps=10)
    assert dataclasses.astuple(res.violation) == ("NoInit", 0, 0)
    assert res.steps == 0 and res.trace[0][0] == "Initial predicate"
    sim = Simulator(tm, walks=4, seed=3, device="cpu")
    sim.start()
    rng, _k0 = prng.split(prng.PRNGKey(3))
    assert sim.rng == rng
    with pytest.raises(KeyError, match="unknown invariant"):
        Simulator(tm, invariants=("Nope",), device="cpu")


def _cli(capsys, path, *args):
    """The CLI in-process: (exit code, stdout, stderr)."""
    from raft_tpu_torch.__main__ import main

    rc = main([str(path), "--device", "cpu", "--msg-slots", "16", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["clean", "violation"])
def test_cli_simulate_exit_codes(tmp_path, capsys, case):
    if case == "clean":
        cfg = tmp_path / "Raft.cfg"
        cfg.write_text(HEAD + TAIL)
        rc, out, err = _cli(capsys, cfg, "--simulate", "24", "--sim-depth", "10",
                            "--sim-walks", "8")
        assert rc == 0, err
        assert "no invariant violations (simulation is not exhaustive)" in out
        assert "simulate: behaviors=" in out
    else:
        # quorums 1 + 1: the violation is a few steps deep
        cfg = tmp_path / "FlexibleRaft.cfg"
        cfg.write_text(HEAD + "    ElectionQuorumSize = 1\n    ReplicationQuorumSize = 1\n"
                       + TAIL)
        rc, out, err = _cli(capsys, cfg, "--simulate", "64", "--sim-depth", "12",
                            "--sim-walks", "16", "--seed", "1")
        assert rc == 2, err
        assert "INVARIANT LeaderHasAllAckedValues VIOLATED (walk 11, depth 7)" in out
        assert out.count("State ") == 8 and "<Initial predicate>" in out

"""The port's sharded engine on tiny caps against the reference's
``ShardedBFS`` at D = 2 (gloo CPU processes; the reference on the
conftest's virtual CPU mesh, dense path, no canon memo): the sub-stepping
cursor, frontier and journal growth, and the port's worklist and
route-cap redos, down to the last checkpoint's frontiers, seen runs and
journals. A file of its own: the reference's run at chunk 8 takes most of
a minute on this CPU."""

import dataclasses
import functools

import jax
import numpy as np
import torch

from raft_tpu.models.raft import cached_model
from raft_tpu.parallel.sharded import ShardedBFS as JaxShardedBFS
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.parallel.launch import run_sharded

from test_expand_sparse import DenseShim
from test_torch_sharded import INV, PARAMS, counts

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def test_substeps_growth_and_redos_keep_the_counts(tmp_path):
    """Chunks of 8 states (many sub-steps a wave) and frontier and journal
    caps that must grow, at MaxElections 2, against the reference at the
    same caps; the port also starts with one worklist lane a state and two
    route slots a pair, which overflow and are redone doubled (the
    reference raises CapacityOverflow there, so it runs them unbounded: a
    redo must leave no trace). Both write a checkpoint every wave; the last
    payloads, which hold every shard's frontier, seen run and journal lanes
    in order, must be equal field for field, content hash included."""
    params = dataclasses.replace(PARAMS, max_elections=2)
    caps = dict(chunk=8, frontier_cap=8, seen_cap=64, journal_cap=8)
    ck = dict(checkpoint_every_s=0)
    ref_engine = JaxShardedBFS(DenseShim(cached_model(params)), invariants=INV,
                               devices=jax.devices()[:2], canon_memo_cap=0, **caps)
    ref = ref_engine.run(collect_metrics=True, checkpoint_path=str(tmp_path / "ref.npz"), **ck)
    pp = params_from_reference(dataclasses.asdict(params))
    _, res = run_sharded(functools.partial(RaftModel, pp), 2, device="cpu",
                         engine_kw=dict(invariants=INV, valid_per_state=1, route_cap=2, **caps),
                         run_kw=dict(collect_metrics=True,
                                     checkpoint_path=str(tmp_path / "port.npz"), **ck))
    assert counts(res) == counts(ref) and res.exhausted
    assert res.violation_invariant is None and res.distinct > 1000
    assert res.coverage == ref.coverage
    assert [m["a2a_lanes"] for m in res.metrics] == [m["a2a_lanes"] for m in ref.metrics]
    want, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and (got[k] == want[k]).all(), k
    st = res.stats
    assert (st["frontier_cap"], st["journal_cap"]) == (ref_engine.FCAP, ref_engine.JCAP)
    assert st["frontier_cap"] > 8 and st["journal_cap"] > 8
    assert st["valid_cap"] > 8 and st["route_cap"] > 2 and st["redone_chunks"] > 0

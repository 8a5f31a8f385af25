"""Start the D shards of a sharded run: the rendezvous, the ranks and the
result.

``run_sharded(build, D)`` runs rank 0 in the calling process and spawns
ranks 1 .. D-1 (the ``spawn`` start method: no CUDA context is forked);
at D = 1 nothing is spawned, and the run still goes through a process
group of one, so the path at any mesh size is the same. The ranks meet
through a ``file://`` rendezvous in a fresh temporary directory (no TCP
port, so concurrent runs never collide), on NCCL for ``cuda`` (shard r
on card r) and on gloo for ``cpu`` (D CPU processes: the counterpart of
the reference's ``xla_force_host_platform_device_count``). On ``cuda``
the kernels are built here once, before any rank starts, so that no two
ranks run nvcc on the same files.

``build`` makes the model in each rank (it must pickle: a class and its
parameters, or ``CfgModel``). Rank 0's result is returned with the
engine; the other ranks' copies are dropped. A spawned rank imports the
caller's main module again, so a script that starts a run with D > 1 keeps
its work under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from .. import kernels, resolve_device
from ..resilience.errors import CapacityOverflow, CheckpointError
from .sharded import ShardedBFS

TIMEOUT = datetime.timedelta(seconds=600)  # how long a collective waits for a lost shard
# failures every shard raises alike (rank 0 reports them); a rank > 0
# exits quietly on these and prints the traceback of anything else
EXPECTED = (CapacityOverflow, CheckpointError, FileNotFoundError, NotImplementedError,
            ValueError, KeyError)


class CfgModel:
    """A picklable model builder from a cfg (the CLI's ``load_setup``)."""

    def __init__(self, cfg_path: str, **kw):
        self.cfg_path, self.kw = cfg_path, kw

    def __call__(self):
        from ..__main__ import load_setup

        return load_setup(self.cfg_path, **self.kw).model


def _rank_run(rank: int, D: int, init_method: str, device: str, build, engine_kw: dict,
              run_kw: dict):
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    hook = sys.excepthook  # init_process_group chains a rank prefix onto it
    dist.init_process_group(backend, init_method=init_method, world_size=D, rank=rank,
                            timeout=TIMEOUT)
    try:
        engine = ShardedBFS(build(), device=device, **engine_kw)
        return engine, engine.run(**run_kw)
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def _child(rank, D, init_method, device, build, engine_kw, run_kw, threads):
    torch.set_num_threads(threads)
    try:
        _rank_run(rank, D, init_method, device, build, engine_kw, run_kw)
    except EXPECTED:
        os._exit(3)
    except BaseException:  # noqa: BLE001 - a rank's own fault: show it, then fail
        traceback.print_exc()
        os._exit(1)


def run_sharded(build, D: int, device="cuda", engine_kw: dict | None = None,
                run_kw: dict | None = None):
    """Run ``ShardedBFS(build(), **engine_kw).run(**run_kw)`` on D shards.
    Returns (rank 0's engine, its ShardedResult). Raises what rank 0
    raised, or RuntimeError when another rank failed alone."""
    dev = resolve_device(device)
    if D < 1:
        raise ValueError(f"a sharded run needs at least one shard, got D={D}")
    if dev.type == "cuda":
        if D > torch.cuda.device_count():
            raise ValueError(f"{D} shards need {D} CUDA cards, {torch.cuda.device_count()} "
                             "visible")
        kernels.build_all()
    engine_kw, run_kw = dict(engine_kw or {}), dict(run_kw or {})
    # CPU shards share this process's threads (oversubscribed, gloo's
    # waits spin against the compute)
    threads = torch.get_num_threads()
    per_rank = max(1, threads // D) if dev.type == "cpu" else threads
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="raft_tpu_torch_rdv_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, D, init_method, str(device), build, engine_kw, run_kw,
                                   per_rank))
                 for r in range(1, D)]
        for p in procs:
            p.start()
        torch.set_num_threads(per_rank)
        try:
            out = _rank_run(0, D, init_method, str(device), build, engine_kw, run_kw)
        except BaseException:
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.terminate()
            raise
        finally:
            torch.set_num_threads(threads)
        failed = []
        for r, p in enumerate(procs, start=1):
            p.join(TIMEOUT.total_seconds())
            if p.is_alive():
                p.terminate()
                failed.append(f"rank {r} did not finish")
            elif p.exitcode:
                failed.append(f"rank {r} exited with code {p.exitcode}")
        if failed:
            raise RuntimeError(f"sharded run: {'; '.join(failed)}")
    return out

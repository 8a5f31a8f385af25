"""raft_tpu_torch — the PyTorch/CUDA port of the raft_tpu model checker.

The package mirrors ``raft_tpu``'s layout so each counterpart is easy to
find:

  ops/       hashing, bit packing, message-bag ops, symmetry
             canonicalization (the ``canon_memo`` CUDA kernel up to four
             servers, ``canon_tiered`` and ``canon_signatures`` from
             five), and the guard-first expand, the coverage/invariant
             fold and the predicates of every family (``raft_*``,
             ``pull_*``, ``kraft_*`` kernels)
  models/    state layout + batched action kernels + invariants of the
             Raft, pull and KRaft families (the kernels' plain versions),
             and the cfg -> model registry
  checker/   the device-resident BFS engine (``DeviceBFS``), its sorted-
             run seen set (``merge_runs`` kernel) and the dedup / emit
             helpers (``probe_runs``, ``chunk_sort`` and
             ``compact_append`` kernels)
  utils/     TLC ``.cfg`` parser, TLC-style trace printer
  csrc/      the CUDA C++ sources of the 24 kernels (``kernels.py``
             builds them with nvcc and binds them through ctypes)

It imports torch and numpy only — never jax and never ``raft_tpu``.
Fingerprints are u64 values in the reference; torch has no unsigned
64-bit compares or sorts on the CPU, so every fingerprint tensor here is
int64 holding ``u64 ^ (1 << 63)`` (an order-preserving map: sorting the
int64 values sorts the u64 values, and ``U64_MAX`` becomes ``INT64_MAX``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is requested and no card is visible
    — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (CLI: --device "
            "cpu) to run the plain PyTorch versions on the CPU"
        )
    return dev


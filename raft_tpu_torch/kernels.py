"""Build, bind and count the port's hand-written CUDA kernels.

Each kernel lives in a CUDA C++ source in ``csrc/`` with a plain C
interface (``raft_guard`` and ``raft_apply`` share ``raft_expand.cu``;
``raft_predicates`` and simulate's ``raft_sim_check`` share
``raft_predicates.cu``; the pull family's ``pull_*``, KRaft's ``kraft_*``,
the reconfiguration specs' ``reconfig_*`` (AddRemove) and ``joint_*``
(JointConsensus) and KRaftWithReconfig's ``kreconfig_*`` kernels the same
way; KRaftWithReconfig's slot canonicalizer is ``slot_canon.cu``, the
sharded engine's owner route ``owner_route.cu``;
``*.cuh`` headers are shared device code and kernel drivers). ``nvcc -gencode
arch=compute_90a,code=sm_90a`` compiles each source into a shared
library under ``build/raft_tpu_torch/`` at first use (``build_all``
starts one nvcc per source, all at once); ``ctypes`` loads it. A launcher
takes raw device pointers (``tensor.data_ptr()``) and PyTorch's current
stream, launches without synchronizing, and returns ``cudaGetLastError``
— which ``Kernel.launched`` turns into an exception.

Every kernel counts its launches in ``Kernel.launches``: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels. Nothing here is imported
from or built at module import; the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raft_tpu_torch")
ARCH = "arch=compute_90a,code=sm_90a"

# C signatures of the launchers (every pointer and the stream are
# c_void_p so ctypes never truncates them to 32 bits).
_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# a family's expand, fold and predicate launchers (csrc/raft_expand.cu and
# pull_expand.cu, ... share the drivers of csrc/*_driver.cuh, so each
# family's launchers have the same signatures)
_GUARD = [_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_APPLY = [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P]
_FOLD = [_P, _I, _P, _P, _P, _P, _L, _P, _I, _P, _I, _P, _P, _P, _P, _P]
_PREDICATES = [_P, _L, _P, _I, _P, _I, _P, _P]
_SIM_CHECK = [_P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P]
_SIGNATURES = {
    "canon_memo": {
        "canon_memo": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
        "canon_memo_occupancy": [_P, _I, _P],
    },
    "canon_tiered": {
        "canon_tiered": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
        "canon_signatures": [_P, _P, _I, _P, _I, _I, _P, _P],
        "canon_tiered_occupancy": [_P, _I, _P],
    },
    "chunk_dedup": {
        "chunk_dedup": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _L, _P],
        "chunk_dedup_scratch": [_I],
    },
    "compact_append": {
        "compact_indices": [_P, _I, _P, _I, _I, _P, _P, _I, _P],
        "append_rows": [_P, _P, _I, _I, _P, _I, _I, _P, _L, _P],
    },
    "merge_runs": {
        "merge_runs": [_P, _L, _P, _L, _P, _L, _P],
    },
    "sim_step": {
        "sim_pick": [_P, _P, _I, _I, _U, _U, _U, _U, _U, _U, _I, _P, _P, _P, _P, _P, _P],
    },
    "hash_rows": {
        "hash_rows": [_P, _L, _I, _U, _U, _I, _P, _P],
    },
    "slot_canon": {
        "slot_canon": [_P, _P, _I, _P, _L, _I, _P, _P, _I, _P, _I, _U, _U, _I, _P, _P],
        "slot_canon_occupancy": [_P, _I, _I, _I, _P],
    },
    "owner_route": {
        "owner_route": [_P, _I, _P, _I, _P, _P, _I, _I, _L, _I, _I, _P, _I, _P, _P, _P, _P,
                        _P],
    },
}
for _fam in ("raft", "pull", "kraft", "reconfig", "joint", "kreconfig"):
    _SIGNATURES[f"{_fam}_expand"] = {f"{_fam}_guard": _GUARD, f"{_fam}_apply": _APPLY}
    _SIGNATURES[f"{_fam}_fold"] = {f"{_fam}_fold": _FOLD}
    _SIGNATURES[f"{_fam}_predicates"] = {f"{_fam}_predicates": _PREDICATES,
                                         f"{_fam}_sim_check": _SIM_CHECK}
# raft_expand.cu's second build of the two, with the network-fault groups
_SIGNATURES["raft_expand"].update(raft_nf_guard=_GUARD, raft_nf_apply=_APPLY)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class Kernel:
    """One kernel: its CUDA source (which several kernels may share), its
    build, its ctypes library and its own launch count."""

    def __init__(self, name: str, source: str | None = None):
        self.name = name
        self.unit = source or name
        self.source = os.path.join(CSRC, f"{self.unit}.cu")
        self.library = os.path.join(BUILD_DIR, f"lib{self.unit}.so")
        self.launches = 0
        self._lib = None

    def stale(self) -> bool:
        if not os.path.exists(self.library):
            return True
        headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
        newest = max(os.path.getmtime(f) for f in [self.source, *headers])
        return os.path.getmtime(self.library) < newest

    def compile_cmd(self) -> list[str]:
        return [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", self.library,
                self.source]

    def start_build(self):
        """Start nvcc for this source (None when the library is fresh)."""
        if not self.stale():
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        return subprocess.Popen(self.compile_cmd(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    @property
    def lib(self):
        if self._lib is None:
            proc = self.start_build()
            if proc is not None:
                out, _ = proc.communicate()
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
            lib = ctypes.CDLL(self.library)
            sigs = dict(_SIGNATURES[self.unit])
            occ = f"{self.name}_occupancy"  # a group apply's launch shape (expand_driver.cuh)
            if occ not in sigs and hasattr(lib, occ):
                sigs[occ] = [_P]
            for fn, args in sigs.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    @property
    def fn(self):
        """The kernel's launcher (the C function named after the kernel)."""
        return getattr(self.lib, self.name)

    def launcher(self, variant: str = ""):
        """The launcher of the kernel, or of a variant its source also builds
        (``raft_guard`` with ``variant="nf"``: ``raft_nf_guard``, the same
        kernel with the network-fault groups compiled in). A variant's
        launches count as the kernel's."""
        if not variant:
            return self.fn
        fam, role = self.name.rsplit("_", 1)
        return getattr(self.lib, f"{fam}_{variant}_{role}")

    def launched(self, rc: int) -> None:
        """Count one launch and raise if the launcher reported an error."""
        if rc:
            msg = self.lib.rt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} ({rc})")
        self.launches += 1


CANON_MEMO = Kernel("canon_memo")
CHUNK_DEDUP = Kernel("chunk_dedup")
COMPACT_APPEND = Kernel("compact_append")
MERGE_RUNS = Kernel("merge_runs")
CANON_TIERED = Kernel("canon_tiered")
CANON_SIGNATURES = Kernel("canon_signatures", source="canon_tiered")
SIM_PICK = Kernel("sim_pick", source="sim_step")
HASH_ROWS = Kernel("hash_rows")
SLOT_CANON = Kernel("slot_canon")
OWNER_ROUTE = Kernel("owner_route")


def _family(prefix: str) -> dict:
    """A spec family's five kernels by role (models/*.py KERNELS; ops/expand.py
    launches them): guard and apply share prefix_expand.cu, predicates and
    sim_check prefix_predicates.cu, the fold has prefix_fold.cu."""
    return dict(guard=Kernel(f"{prefix}_guard", source=f"{prefix}_expand"),
                apply=Kernel(f"{prefix}_apply", source=f"{prefix}_expand"),
                fold=Kernel(f"{prefix}_fold"),
                predicates=Kernel(f"{prefix}_predicates"),
                sim_check=Kernel(f"{prefix}_sim_check", source=f"{prefix}_predicates"))


# the Raft family (Raft, FlexibleRaft, RaftFsync), the pull family, KRaft,
# the reconfiguration specs (AddRemove's reconfig_*, JointConsensus' joint_*)
# and KRaftWithReconfig (kreconfig_*)
RAFT_FAMILY, PULL_FAMILY, KRAFT_FAMILY, RECONFIG_FAMILY, JOINT_FAMILY, KRECONFIG_FAMILY = (
    _family(prefix) for prefix in ("raft", "pull", "kraft", "reconfig", "joint", "kreconfig"))
FAMILIES = (RAFT_FAMILY, PULL_FAMILY, KRAFT_FAMILY, RECONFIG_FAMILY, JOINT_FAMILY,
            KRECONFIG_FAMILY)
ALL = (CANON_MEMO, CHUNK_DEDUP, COMPACT_APPEND, MERGE_RUNS, CANON_TIERED,
       CANON_SIGNATURES, SIM_PICK, HASH_ROWS, SLOT_CANON, OWNER_ROUTE,
       *(k for fam in FAMILIES for k in fam.values()))


def build_all() -> dict[str, str]:
    """Compile every stale kernel source at once (one nvcc each) and
    load them all. Returns {source name: compiler output} (``-Xptxas -v``
    register and shared-memory reports); raises on the first failure."""
    units = {k.unit: k for k in ALL}
    procs = {u: (k, k.start_build()) for u, k in units.items()}
    logs = {}
    failed = []
    for name, (k, proc) in procs.items():
        if proc is None:
            logs[name] = "(up to date)"
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {k.source}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    for k in ALL:
        k.lib  # noqa: B018 - load and bind
    return logs


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def route(t: torch.Tensor) -> str:
    """Which version a wrapper runs for tensor ``t``: "cuda" launches the
    kernel, "cpu" runs the plain PyTorch version; any other device
    raises (there is no silent fallback)."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")


def require(t: torch.Tensor, dtype, name: str, ndim: int | None = None,
            shape: tuple | None = None) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream

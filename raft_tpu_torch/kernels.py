"""Build, bind and count the port's hand-written CUDA kernels.

Each kernel lives in a CUDA C++ source in ``csrc/`` with a plain C
interface (``raft_guard`` and ``raft_apply`` share ``raft_expand.cu``;
``raft_predicates`` and simulate's ``raft_sim_check`` share
``raft_predicates.cu``; the pull family's ``pull_*`` and KRaft's
``kraft_*`` kernels the same way;
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
        "canon_memo": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                       _P, _P, _P],
    },
    "canon_tiered": {
        "canon_tiered": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
        "canon_signatures": [_P, _P, _I, _P, _I, _I, _P, _P],
    },
    "probe_runs": {
        "probe_runs": [_P, _I, _P, _P, _P, _I, _P],
    },
    "compact_append": {
        "compact_indices": [_P, _I, _P, _I, _I, _P, _P, _I, _P],
        "append_rows": [_P, _P, _I, _P, _I, _I, _P, _L, _P],
    },
    "merge_runs": {
        "merge_runs": [_P, _L, _P, _L, _P, _L, _P],
    },
    "chunk_sort": {
        "chunk_sort": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "sim_step": {
        "sim_pick": [_P, _P, _I, _I, _U, _U, _U, _U, _U, _U, _I, _P, _P, _P, _P, _P, _P],
    },
    "hash_rows": {
        "hash_rows": [_P, _L, _I, _U, _U, _I, _P, _P],
    },
}
for _fam in ("raft", "pull", "kraft"):
    _SIGNATURES[f"{_fam}_expand"] = {f"{_fam}_guard": _GUARD, f"{_fam}_apply": _APPLY}
    _SIGNATURES[f"{_fam}_fold"] = {f"{_fam}_fold": _FOLD}
    _SIGNATURES[f"{_fam}_predicates"] = {f"{_fam}_predicates": _PREDICATES,
                                         f"{_fam}_sim_check": _SIM_CHECK}


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
            for fn, args in _SIGNATURES[self.unit].items():
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

    def launched(self, rc: int) -> None:
        """Count one launch and raise if the launcher reported an error."""
        if rc:
            msg = self.lib.rt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} ({rc})")
        self.launches += 1


CANON_MEMO = Kernel("canon_memo")
PROBE_RUNS = Kernel("probe_runs")
COMPACT_APPEND = Kernel("compact_append")
MERGE_RUNS = Kernel("merge_runs")
RAFT_GUARD = Kernel("raft_guard", source="raft_expand")
RAFT_APPLY = Kernel("raft_apply", source="raft_expand")
RAFT_FOLD = Kernel("raft_fold")
CHUNK_SORT = Kernel("chunk_sort")
CANON_TIERED = Kernel("canon_tiered")
CANON_SIGNATURES = Kernel("canon_signatures", source="canon_tiered")
SIM_PICK = Kernel("sim_pick", source="sim_step")
RAFT_PREDICATES = Kernel("raft_predicates")
RAFT_SIM_CHECK = Kernel("raft_sim_check", source="raft_predicates")
HASH_ROWS = Kernel("hash_rows")
PULL_GUARD = Kernel("pull_guard", source="pull_expand")
PULL_APPLY = Kernel("pull_apply", source="pull_expand")
PULL_FOLD = Kernel("pull_fold")
PULL_PREDICATES = Kernel("pull_predicates")
PULL_SIM_CHECK = Kernel("pull_sim_check", source="pull_predicates")
KRAFT_GUARD = Kernel("kraft_guard", source="kraft_expand")
KRAFT_APPLY = Kernel("kraft_apply", source="kraft_expand")
KRAFT_FOLD = Kernel("kraft_fold")
KRAFT_PREDICATES = Kernel("kraft_predicates")
KRAFT_SIM_CHECK = Kernel("kraft_sim_check", source="kraft_predicates")
ALL = (CANON_MEMO, PROBE_RUNS, COMPACT_APPEND, MERGE_RUNS, RAFT_GUARD, RAFT_APPLY,
       RAFT_FOLD, CHUNK_SORT, CANON_TIERED, CANON_SIGNATURES, SIM_PICK, RAFT_PREDICATES,
       RAFT_SIM_CHECK, HASH_ROWS, PULL_GUARD, PULL_APPLY, PULL_FOLD, PULL_PREDICATES,
       PULL_SIM_CHECK, KRAFT_GUARD, KRAFT_APPLY, KRAFT_FOLD, KRAFT_PREDICATES,
       KRAFT_SIM_CHECK)
# each family's kernels by role (models/*.py KERNELS; ops/expand.py launches them)
RAFT_FAMILY = dict(guard=RAFT_GUARD, apply=RAFT_APPLY, fold=RAFT_FOLD,
                   predicates=RAFT_PREDICATES, sim_check=RAFT_SIM_CHECK)
PULL_FAMILY = dict(guard=PULL_GUARD, apply=PULL_APPLY, fold=PULL_FOLD,
                   predicates=PULL_PREDICATES, sim_check=PULL_SIM_CHECK)
KRAFT_FAMILY = dict(guard=KRAFT_GUARD, apply=KRAFT_APPLY, fold=KRAFT_FOLD,
                    predicates=KRAFT_PREDICATES, sim_check=KRAFT_SIM_CHECK)


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

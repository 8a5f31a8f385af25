"""The device code of the Raft expand kernels (raft_tpu_torch/csrc/
raft_actions.cuh) against the JAX reference, on the CPU.

The header's action groups and invariants are plain C++ once CUDA's
qualifiers are defined away, so a host C++ compiler can build them behind
a small shim header. Each (state, candidate) pair then goes through
``ra_action<false>`` (the guard: valid/rank/ovf) and ``ra_action<true>``
(the apply: the successor row), and each state through ``ra_invariant``;
the results must equal the dense ``jax.vmap(_expand1)`` and the
reference's invariants bit for bit, for the core, fsync and flexible
parameter sets, on reachable states and the edge cases that
``edge_rows`` of tests/test_torch_kernels_cuda.py builds from them
(perturbed lanes, full bags, logs at max_log, scrambled servers with
random messages).
Kernel launch, staging and reductions are left to the on-card tests
(tests/test_torch_kernels_cuda.py); ``kernel_spec`` is checked here too.
"""

import ctypes
import functools
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.models.raft import (
    GROUP_IDS, INVARIANT_IDS, MSG_FIELDS, PRED_VALUE_AON, SPEC_LEN, SPEC_OFFSETS,
    SPEC_SCALARS,
)

from test_torch_kernels_cuda import edge_rows
from test_torch_raft_model import VARIANTS, _pair as _make_pair

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

_pair = functools.lru_cache(maxsize=None)(_make_pair)  # shared by this file's tests

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "raft_tpu_torch", "csrc")

SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
struct rt_dim3 { unsigned x, y, z; };
static rt_dim3 threadIdx{0, 0, 0}, blockDim{1, 1, 1};
typedef int cudaError_t;
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <typename T> T __shfl_up_sync(unsigned, T v, int) { return v; }
inline void __syncthreads() {}
"""

DRIVER = """\
#include <vector>
#include "raft_actions.cuh"
extern "C" int spec_len() { return SP_LEN; }
extern "C" void host_expand(const int* states, int C, const int* spec, const int* cand,
                            int A, int write, int* succ, bool* valid, int* rank, bool* ovf) {
  const int W = spec[SP_W];
  std::vector<int> bag(2 * spec[SP_M]);  // a RequestVote guard's scratch
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      Guard g;
      if (write) {
        for (int w = 0; w < W; ++w) o[w] = s[w];
        g = ra_action<true>(spec, s, o, cand + 4 * a, nullptr);
      } else {
        g = ra_action<false>(spec, s, nullptr, cand + 4 * a, bag.data());
      }
      valid[c * A + a] = g.valid;
      rank[c * A + a] = g.rank;
      ovf[c * A + a] = g.ovf;
    }
}
extern "C" void host_invariant(const int* states, int C, const int* spec, int id, bool* ok) {
  for (int c = 0; c < C; ++c) ok[c] = ra_invariant(spec, states + (long long)c * spec[SP_W], id);
}
extern "C" void host_predicate(const int* states, int C, const int* spec, int id, bool* ok) {
  for (int c = 0; c < C; ++c) ok[c] = ra_predicate(spec, states + (long long)c * spec[SP_W], id);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_actions")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER)
    so = d / "libhost_actions.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_expand.argtypes = [P, ctypes.c_int, P, P, ctypes.c_int, ctypes.c_int, P, P, P, P]
    lib.host_invariant.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P]
    lib.host_predicate.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_device_actions_match_reference(lib, name):
    jm, tm, batch = _pair(name)
    assert lib.spec_len() == SPEC_LEN  # the header's SP_* enum and SPEC_SCALARS agree
    states = edge_rows(tm, batch, seed=len(name))
    want = [np.asarray(x) for x in jax.device_get(jm.expand(states))]
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, W = len(states), tm.A, tm.layout.W
    for write in (0, 1):
        succ = np.zeros((C, A, W), np.int32)
        valid, rank, ovf = np.zeros((C, A), bool), np.zeros((C, A), np.int32), np.zeros((C, A), bool)
        lib.host_expand(_ptr(states), C, _ptr(spec), _ptr(cand), A, write, _ptr(succ),
                        _ptr(valid), _ptr(rank), _ptr(ovf))
        for label, w, g in zip(("valid", "rank", "ovf"), want[1:], (valid, rank, ovf)):
            assert np.array_equal(w, g), (label, write)
        if write:
            assert np.array_equal(want[0], succ)
    assert (want[1] & want[3]).any()  # the full bags make puts overflow


@pytest.mark.parametrize("name", list(VARIANTS))
def test_device_invariants_match_reference(lib, name):
    jm, tm, batch = _pair(name)
    states = edge_rows(tm, batch, seed=7)
    succs = np.ascontiguousarray(np.asarray(jax.device_get(jm.expand(states))[0])
                                 .reshape(-1, tm.layout.W)[::7])
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    for inv, iid in INVARIANT_IDS.items():
        for arr in (states, succs):
            ok = np.zeros(len(arr), bool)
            lib.host_invariant(_ptr(arr), len(arr), _ptr(spec), iid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jm.invariants[inv](arr))), inv


@pytest.mark.parametrize("name", list(VARIANTS))
def test_device_liveness_predicate_matches_reference(lib, name):
    # ValueAllOrNothing(v) of each value (PRED_VALUE_AON + v) against the
    # reference's _live_value_all_or_nothing, on reachable and edge rows,
    # their successors, and rows with the election counter spent; and the
    # invariant ids through the same entry point
    jm, tm, batch = _pair(name)
    states = edge_rows(tm, batch, seed=11)
    succs = np.ascontiguousarray(np.asarray(jax.device_get(jm.expand(states))[0])
                                 .reshape(-1, tm.layout.W)[::5])
    spent = states.copy()
    spent[:, tm.layout.fields["electionCtr"].offset] = tm.p.max_elections
    names = [q for _lab, _p, q in tm.liveness["ValuesNotStuck"]]
    spec, _, ids = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu", names))
    assert ids.tolist() == [PRED_VALUE_AON + v for v in range(tm.p.n_values)]
    for arr in (states, succs, spent):
        for (_lab, _p, jq), pid in zip(jm.liveness["ValuesNotStuck"], ids):
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(_ptr(arr), len(arr), _ptr(spec), int(pid), _ptr(ok))
            want = np.asarray(jq(arr))
            assert np.array_equal(ok, want)
            assert want.any() and not want.all()
        for inv, iid in INVARIANT_IDS.items():
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(_ptr(arr), len(arr), _ptr(spec), iid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jm.invariants[inv](arr))), inv


@pytest.mark.parametrize("name", list(VARIANTS))
def test_kernel_spec_layout(name):
    _jm, tm, _batch = _pair(name)
    assert SPEC_LEN == len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
    spec, cand, inv = tm.kernel_spec("cpu", ("NoLogDivergence", "TestInv"))
    spec = dict(zip(SPEC_SCALARS, spec.tolist()))
    lay = tm.layout
    assert spec["W"] == lay.W and spec["A"] == tm.A and spec["K"] == len(tm.ACTION_NAMES)
    for f in SPEC_OFFSETS:
        assert spec[f] == (lay.fields[f].offset if f in lay.fields else -1), f
    assert cand.shape == (tm.A, 4)
    assert [GROUP_IDS[b[0]] for b in tm.bindings] == cand[:, 0].tolist()
    assert inv.tolist() == [INVARIANT_IDS["NoLogDivergence"], INVARIANT_IDS["TestInv"]]
    with pytest.raises(KeyError, match="no kernel predicate"):
        tm.kernel_spec("cpu", ("NoCommit",))

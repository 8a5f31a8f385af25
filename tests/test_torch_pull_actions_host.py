"""The device code of the pull kernels (raft_tpu_torch/csrc/
pull_actions.cuh) against the JAX reference, on the CPU.

As tests/test_torch_actions_host.py does for raft_actions.cuh: the header
builds with a host C++ compiler behind that file's shim, and each (state,
candidate) pair goes through ``PullFamily::action<false>`` (the guard,
with the chain lanes' scratch the kernel gives them) and
``PullFamily::action<true>`` (the apply), and each state through
``PullFamily::invariant``; the results must equal the dense
``jax.vmap(_expand1)`` and the reference's invariants bit for bit, for
PullRaft and PullRaftVariant2, on reachable states and the edge rows of
``pull_edge_rows`` (tests/test_torch_kernels_cuda.py): perturbed lanes,
full bags with count-0 records, logs at max_log, records of every type
naming servers past the last one, and RequestVote and BecomeLeader chains
that overflow partway. Skips without g++.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.models.pull_raft import (
    GROUP_IDS, INVARIANT_IDS, MSG_FIELDS, R_BECOMELEADER, R_HANDLE_SUCCESS_PULL, R_REQUESTVOTE,
    SPEC_LEN, SPEC_OFFSETS, SPEC_SCALARS,
)

from test_torch_actions_host import CSRC, SHIM
from test_torch_kernels_cuda import pull_edge_rows
from test_torch_pull_raft import PARAMS, _pair

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

DRIVER = """\
#include <vector>
#include "pull_actions.cuh"
extern "C" int spec_len() { return PS_LEN; }
extern "C" void host_expand(const int* states, int C, const int* spec, const int* cand,
                            int A, int write, int* succ, bool* valid, int* rank, bool* ovf) {
  const int W = spec[PS_W], M = spec[PS_M];
  std::vector<int> scratch(PullFamily::scratch_slots(spec[PS_S]) * 2 * M);  // one state's
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      const int* cd = cand + 4 * a;
      Guard g;
      if (write) {
        for (int w = 0; w < W; ++w) o[w] = s[w];
        g = PullFamily::action<true>(spec, s, o, cd, nullptr);
      } else {
        const int slot = PullFamily::scratch_slot(cd);
        int* bag = slot >= 0 ? scratch.data() + slot * 2 * M : nullptr;
        g = PullFamily::action<false>(spec, s, nullptr, cd, bag);
      }
      valid[c * A + a] = g.valid;
      rank[c * A + a] = g.rank;
      ovf[c * A + a] = g.ovf;
    }
}
extern "C" void host_invariant(const int* states, int C, const int* spec, int id, bool* ok) {
  for (int c = 0; c < C; ++c)
    ok[c] = PullFamily::invariant(spec, states + (long long)c * spec[PS_W], id);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_pull_actions")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER)
    so = d / "libhost_pull_actions.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_expand.argtypes = [P, ctypes.c_int, P, P, ctypes.c_int, ctypes.c_int, P, P, P, P]
    lib.host_invariant.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("name", ["pull", "pull2_restart"])
def test_device_actions_match_reference(lib, name):
    jm, tm, batch, _dense = _pair(name)
    assert lib.spec_len() == SPEC_LEN  # the header's PS_* enum and SPEC_SCALARS agree
    states = pull_edge_rows(tm, batch, seed=len(name))
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
    # the edge rows overflow both chains and the append of a success
    # response to a log at max_log
    hit = want[1] & want[3]
    for r in (R_REQUESTVOTE, R_BECOMELEADER, R_HANDLE_SUCCESS_PULL):
        assert (hit & (want[2] == r)).any(), r


@pytest.mark.parametrize("name", ["pull", "pull2_restart"])
def test_device_invariants_match_reference(lib, name):
    jm, tm, batch, _dense = _pair(name)
    states = pull_edge_rows(tm, batch, seed=7)
    succs = np.ascontiguousarray(np.asarray(jax.device_get(jm.expand(states))[0])
                                 .reshape(-1, tm.layout.W)[::7])
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    for inv, iid in INVARIANT_IDS.items():
        for arr in (states, succs):
            ok = np.zeros(len(arr), bool)
            lib.host_invariant(_ptr(arr), len(arr), _ptr(spec), iid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jm.invariants[inv](arr))), inv


@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_spec_layout(name):
    _jm, tm, _batch, _dense = _pair(name)
    assert SPEC_LEN == len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
    spec, cand, inv = tm.kernel_spec("cpu", ("NoLogDivergence", "TestInv"))
    spec = dict(zip(SPEC_SCALARS, spec.tolist()))
    lay = tm.layout
    assert spec["W"] == lay.W and spec["A"] == tm.A and spec["K"] == len(tm.ACTION_NAMES)
    assert spec["variant2"] == tm.p.variant2
    for f in SPEC_OFFSETS:
        assert spec[f] == (lay.fields[f].offset if f in lay.fields else -1), f
    assert cand.shape == (tm.A, 4)
    assert [GROUP_IDS[b[0]] for b in tm.bindings] == cand[:, 0].tolist()
    assert inv.tolist() == [INVARIANT_IDS["NoLogDivergence"], INVARIANT_IDS["TestInv"]]
    with pytest.raises(KeyError, match="no kernel predicate"):
        tm.kernel_spec("cpu", ("ValuesNotStuck",))

"""The device code of the KRaft kernels (raft_tpu_torch/csrc/
kraft_actions.cuh) against the JAX reference, on the CPU.

As tests/test_torch_pull_actions_host.py does for pull_actions.cuh: the
header builds with a host C++ compiler behind the shim of
tests/test_torch_actions_host.py, and each (state, candidate) pair goes
through ``KRaftFamily::action<false>`` (the guard, with the chain lanes'
scratch the kernel gives them), ``KRaftFamily::action<true>`` (the apply as
a group of one) and ``KRaftFamily::apply`` (the action of the card's group
apply) with ``GrpSerial`` groups of G = 1, 4, 8 and 32 members, and each
state through ``KRaftFamily::invariant`` and
``KRaftFamily::predicate`` (ValueAllOrNothing); the results must equal the
dense ``jax.vmap(_expand1)``, the reference's invariants and its
``_live_value_all_or_nothing`` bit for bit, on reachable states and the
edge rows of ``kraft_edge_rows`` (tests/test_torch_kernels_cuda.py):
perturbed lanes, full bags with count-0 records, chains that overflow
partway, logs at max_log, scrambled servers with FetchResponses that match
a pendingFetch (every arm of both CASE chains), and FetchResponses already
in the bag; the group apply also on rows where a reply's key is already in
the bag. Skips without g++.
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.models import kraft as kr
from raft_tpu_torch.models.base import INVARIANT_IDS, PRED_VALUE_AON
from raft_tpu_torch.models.kraft import (
    GROUP_IDS, KRAFT_INVARIANT_IDS, MSG_FIELDS, SPEC_LEN, SPEC_OFFSETS, SPEC_SCALARS,
)

from test_torch_actions_host import CSRC, SHIM, existed_rows
from test_torch_kraft import PARAMS, _edges, _pair

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

DRIVER = """\
#include <vector>
#include "kraft_actions.cuh"
extern "C" int spec_len() { return KS_LEN; }
extern "C" void host_expand(const int* states, int C, const int* spec, const int* cand,
                            int A, int write, int* succ, bool* valid, int* rank, bool* ovf) {
  const int W = spec[KS_W], M = spec[KS_M];
  std::vector<int> scratch(KRaftFamily::scratch_slots(spec[KS_S]) * 2 * M);  // one state's
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      const int* cd = cand + 4 * a;
      Guard g;
      if (write) {
        for (int w = 0; w < W; ++w) o[w] = s[w];
        g = KRaftFamily::action<true>(spec, s, o, cd, nullptr);
      } else {
        const int slot = KRaftFamily::scratch_slot(cd);
        int* bag = slot >= 0 ? scratch.data() + slot * 2 * M : nullptr;
        g = KRaftFamily::action<false>(spec, s, nullptr, cd, bag);
      }
      valid[c * A + a] = g.valid;
      rank[c * A + a] = g.rank;
      ovf[c * A + a] = g.ovf;
    }
}
// the group apply's action: every (state, candidate) lane's successor row by
// a serial group of G members
extern "C" void host_group_apply(int G, const int* states, int C, const int* spec,
                                 const int* cand, int A, int* succ) {
  const int W = spec[KS_W];
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      for (int w = 0; w < W; ++w) o[w] = s[w];
      KRaftFamily::apply(GrpSerial{G}, spec, s, o, cand + 4 * a);
    }
}
extern "C" void host_predicate(const int* states, int C, const int* spec, int id, bool* ok) {
  for (int c = 0; c < C; ++c)
    ok[c] = KRaftFamily::predicate(spec, states + (long long)c * spec[KS_W], id);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_kraft_actions")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER)
    so = d / "libhost_kraft_actions.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_expand.argtypes = [P, ctypes.c_int, P, P, ctypes.c_int, ctypes.c_int, P, P, P, P]
    lib.host_predicate.argtypes = [P, ctypes.c_int, P, ctypes.c_int, P]
    lib.host_group_apply.argtypes = [ctypes.c_int, P, ctypes.c_int, P, P, ctypes.c_int, P]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _dst_states(tm, states, succs, valid, rank):
    """For the valid HandleMessage lanes of the ranks that run a CASE chain
    (HandleRVResp, HandleBQReq, HandleErrorFetchResponse): the arm each
    took, read off the record's destination server's new state — illegal,
    unattached, follower, or no change."""
    lay = tm.layout
    arms = set()
    for c, a in zip(*np.nonzero(valid & np.isin(rank, (
            kr.K_HANDLE_RVRESP, kr.K_HANDLE_BQREQ, kr.K_HANDLE_FETCH_ERR)))):
        m = tm.bindings[a][1][0]
        dst = int(tm.packer.unpack(states[c, lay.sl("msg_hi")][m],
                                   states[c, lay.sl("msg_lo")][m], "mdest"))
        if dst >= tm.p.n_servers:
            continue
        old, new = states[c, lay.sl("state")][dst], succs[c, a, lay.sl("state")][dst]
        ep_old, ep_new = (x[lay.sl("currentEpoch")][dst] for x in (states[c], succs[c, a]))
        arms.add("illegal" if new == kr.ILLEGAL and old != kr.ILLEGAL else
                 "unattached" if new == kr.UNATTACHED and ep_new > ep_old else
                 "follower" if new == kr.FOLLOWER and (old != kr.FOLLOWER or ep_new > ep_old)
                 else "no-op" if (new, ep_new) == (old, ep_old) else "other")
    return arms


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_actions_match_reference(lib, name):
    _jm, tm, _batch, _dense = _pair(name)
    assert lib.spec_len() == SPEC_LEN  # the header's KS_* enum and SPEC_SCALARS agree
    states, want = _edges(name)
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
    # the edge rows take every arm of the CASE chains, overflow both
    # chains, a ClientRequest and a success response's append
    arms = _dst_states(tm, states, want[0], want[1], want[2])
    assert {"illegal", "unattached", "follower", "no-op"} <= arms, arms
    hit = want[1] & want[3]
    for r in (kr.K_REQUESTVOTE, kr.K_BECOMELEADER, kr.K_CLIENTREQUEST, kr.K_HANDLE_FETCH_OK):
        assert (hit & (want[2] == r)).any(), r


@functools.lru_cache(maxsize=None)
def _group_rows(name):
    """kraft_edge_rows of the reachable batch and their existed_rows (a
    reply or a fetch request already in the bag), with their dense expand
    and the existed rows' lanes."""
    jm, tm, _batch, _dense = _pair(name)
    rows, want = _edges(name)
    ex, lanes = existed_rows(tm, rows, want, (
        kr.K_HANDLE_RVREQ, kr.K_HANDLE_BQREQ, kr.K_REJECT_FETCH, kr.K_DIVERGING_FETCH,
        kr.K_ACCEPT_FETCH, kr.K_SENDFETCH), GROUP_IDS["HandleMessage"])
    rows = np.ascontiguousarray(np.concatenate([rows, ex]))
    want = [np.asarray(x) for x in jax.device_get(jm.expand(rows))]
    base = len(rows) - len(ex)
    return rows, want, [(base + i, a) for i, a in lanes]


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("name", list(PARAMS))
def test_group_apply_matches_reference(lib, name, G):
    """``KRaftFamily::apply``, the action of the card's group apply (a tile
    of G threads a worklist lane), run with ``GrpSerial`` (the G members'
    shares of each bag put and multi-lane write in turn), against the
    dense expand bit for bit on every (row, candidate) lane; the rows reach
    both chains into full bags, a receipt's discard followed by an
    overflowing put, puts whose key existed and logs at max_log."""
    _jm, tm, _batch, _dense = _pair(name)
    rows, want, existed = _group_rows(name)
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, W = len(rows), tm.A, tm.layout.W
    succ = np.zeros((C, A, W), np.int32)
    lib.host_group_apply(G, _ptr(rows), C, _ptr(spec), _ptr(cand), A, _ptr(succ))
    assert np.array_equal(want[0], succ)
    valid, rank, ovf = want[1:]
    hit = valid & ovf
    for r in (kr.K_REQUESTVOTE, kr.K_BECOMELEADER, kr.K_CLIENTREQUEST, kr.K_HANDLE_FETCH_OK):
        assert (hit & (rank == r)).any(), r
    assert (hit & np.isin(rank, (kr.K_HANDLE_RVREQ, kr.K_HANDLE_BQREQ, kr.K_ACCEPT_FETCH))).any()
    lay = tm.layout
    assert existed
    for c, a in existed:  # the successor's bag gained no key
        assert np.array_equal(succ[c, a, lay.sl("msg_hi")], rows[c, lay.sl("msg_hi")])
        assert np.array_equal(succ[c, a, lay.sl("msg_lo")], rows[c, lay.sl("msg_lo")])


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_predicates_match_reference(lib, name):
    jm, tm, _batch, _dense = _pair(name)
    states, want = _edges(name)
    succs = np.ascontiguousarray(want[0].reshape(-1, tm.layout.W)[::7])
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    ids = dict(INVARIANT_IDS) | KRAFT_INVARIANT_IDS
    assert set(ids) == set(jm.invariants)
    for arr in (states, succs):
        for inv, iid in ids.items():
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(_ptr(arr), len(arr), _ptr(spec), iid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jm.invariants[inv](arr))), inv
        for v in range(tm.p.n_values):
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(_ptr(arr), len(arr), _ptr(spec), PRED_VALUE_AON + v, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jm._live_value_all_or_nothing(v, arr))), v


@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_spec_layout(name):
    _jm, tm, _batch, _dense = _pair(name)
    assert SPEC_LEN == len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
    assert MSG_FIELDS == tuple(tm.packer.fields)  # every record field, in packer order
    names = ("NoIllegalState", "TestInv", "ValueAllOrNothing(v1)")
    spec, cand, ids = tm.kernel_spec("cpu", names)
    spec = dict(zip(SPEC_SCALARS, spec.tolist()))
    lay = tm.layout
    assert spec["W"] == lay.W and spec["A"] == tm.A and spec["K"] == len(tm.ACTION_NAMES)
    for f in SPEC_OFFSETS:
        assert spec[f] == lay.fields[f].offset, f
    assert cand.shape == (tm.A, 4)
    assert [GROUP_IDS[b[0]] for b in tm.bindings] == cand[:, 0].tolist()
    assert ids.tolist() == [KRAFT_INVARIANT_IDS["NoIllegalState"], INVARIANT_IDS["TestInv"],
                            PRED_VALUE_AON]
    with pytest.raises(KeyError, match="no kernel predicate"):
        tm.kernel_spec("cpu", ("ValuesNotStuck",))

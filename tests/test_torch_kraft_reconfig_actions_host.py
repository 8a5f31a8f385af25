"""The device code of the KRaftWithReconfig kernels (raft_tpu_torch/csrc/
kreconfig_actions.cuh and slot_canon.cuh) against the JAX reference, on the
CPU.

As tests/test_torch_reconfig_actions_host.py does for config_actions.cuh:
the headers build with a host C++ compiler behind the shim of
tests/test_torch_actions_host.py. Each (state, candidate) pair goes through
``KReconfigFamily::action<false>`` (the guard, a chain lane with the
scratch the kernel gives it) and ``action<true>`` (the apply), each state
through ``KReconfigFamily::predicate`` (the invariants and the liveness
predicates), and each row through the slot canon's device code as the
kernel runs it, with serial groups at its own tiles
(tests/test_torch_slot_canon_host.py's ``host_slot_canon``; that file runs
every tile size); the results must equal the dense ``jax.vmap(_expand1)``,
the reference's invariants and liveness predicates and
``SlotCanonicalizer.fingerprints``
bit for bit (tolerance: none, the values are integers), on reachable
states and the edge rows of ``kreconfig_edge_rows``
(tests/test_torch_kernels_cuda.py): every receipt arm, chains that overflow
partway, logs at max_log. Skips without g++.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models import kraft_reconfig as ref_kr
from raft_tpu_torch.convert import fps_to_u64
from raft_tpu_torch.models import kraft_reconfig as kr
from raft_tpu_torch.ops.packing import EMPTY

from test_torch_actions_host import CSRC, SHIM
from test_torch_kernels_cuda import kreconfig_bag_rows
from test_torch_kraft_reconfig import FULLP, _edges, _pair, dense_expand, reachable
from test_torch_slot_canon_host import SLOT_DRIVER, host_fingerprints

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

DRIVER = """\
#include <vector>
#include "slot_canon.cuh"
extern "C" int spec_len() { return KC_LEN; }
extern "C" void host_expand(const int* states, int C, const int* spec, const int* cand, int A,
                            int write, int* succ, bool* valid, int* rank, bool* ovf) {
  typedef KReconfigFamily F;
  const int W = spec[KC_W], M = spec[KC_M];
  std::vector<int> scratch(F::scratch_slots(spec[KC_S]) * F::BAG_WORDS * M);  // one state's
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      const int* cd = cand + 4 * a;
      Guard g;
      if (write) {
        for (int w = 0; w < W; ++w) o[w] = s[w];
        g = F::action<true>(spec, s, o, cd, nullptr);
      } else {
        const int slot = F::scratch_slot(cd);
        int* bag = slot >= 0 ? scratch.data() + slot * F::BAG_WORDS * M : nullptr;
        g = F::action<false>(spec, s, nullptr, cd, bag);
      }
      valid[c * A + a] = g.valid;
      rank[c * A + a] = g.rank;
      ovf[c * A + a] = g.ovf;
    }
}
extern "C" void host_group_apply(int G, const int* states, int C, const int* spec,
                                 const int* cand, int A, int* succ) {
  const int W = spec[KC_W];
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      for (int w = 0; w < W; ++w) o[w] = s[w];
      KReconfigFamily::apply(GrpSerial{G}, spec, s, o, cand + 4 * a);
    }
}
extern "C" void host_predicate(const int* states, int C, const int* spec, int id, bool* ok) {
  for (int c = 0; c < C; ++c) ok[c] = KReconfigFamily::predicate(spec, states + c * spec[KC_W], id);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_kreconfig_actions")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER + SLOT_DRIVER)
    so = d / "libhost_kreconfig_actions.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.host_expand.argtypes = [P, I, P, P, I, I, P, P, P, P]
    lib.host_predicate.argtypes = [P, I, P, I, P]
    lib.host_group_apply.argtypes = [I, P, I, P, P, I, P]
    lib.host_slot_canon.argtypes = [P, ctypes.c_longlong, I, P, P, P, I, P, I, U, U, I, I, I, P]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_device_actions_match_reference(lib):
    _jm, tm, _batch, _dense = _pair()
    assert lib.spec_len() == kr.SPEC_LEN  # the header's KC_*/KM_* enums and SPEC_SCALARS agree
    states, want = _edges()
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
    # every Next disjunct fires on these rows, and the chains and appends overflow
    assert set(np.unique(want[2][want[1]]).tolist()) == set(range(len(tm.ACTION_NAMES)))
    hit = want[1] & want[3]
    for r in (kr.KR_REQUESTVOTE, kr.KR_BECOMELEADER, kr.KR_CLIENTREQUEST, kr.KR_ACCEPT_JOIN):
        assert (hit & (want[2] == r)).any(), r


def _existed_rows(tm, rows, want, limit=8):
    """Copies of ``rows`` in which a voter's fetch that the leader accepts
    (a valid AcceptFetchRequestFromVoter lane of ``want``, the dense expand
    of ``rows``) finds its reply already in the bag: the reply (the one key
    the successor's bag gains) put into a free slot beforehand, count 1.
    Returns (rows, lanes): each copy's (row, candidate) lane of that fetch,
    where the branch is disabled and the successor is the state itself."""
    lay, M = tm.layout, tm.p.msg_slots
    ws = [lay.sl(f"msg_w{k}") for k in range(tm.n_words)]
    cs = lay.sl("msg_cnt")
    cand = tm.kernel_spec("cpu")[1].numpy()
    succ, valid, rank, _ovf = want

    def keys(r):
        return [tuple(int(r[w][m]) for w in ws) for m in range(M)]

    out, lanes = [], []
    for c, a in zip(*np.nonzero(valid & (rank == kr.KR_ACCEPT_FETCH_VOTER))):
        before = keys(rows[c])
        new = [k for k in keys(succ[c, a]) if k[0] != EMPTY and k not in before]
        if len(new) != 1 or before[-1][0] != EMPTY:  # the reply, and a free slot for it
            continue
        req = before[cand[a, 1]]
        count = {k: int(n) for k, n in zip(before, rows[c][cs])}
        bag = sorted([k for k in before if k[0] != EMPTY] + new)
        r = rows[c].copy()
        words = np.full((len(ws), M), EMPTY)
        words[:, :len(bag)] = np.array(bag).T
        for k, w in enumerate(ws):
            r[w] = words[k]
        r[cs] = [count.get(k, 1) for k in bag] + [0] * (M - len(bag))
        m = bag.index(req)
        lanes.append((len(out), int(np.flatnonzero((cand[:, 0] == kr.GROUP_IDS["HandleMessage"])
                                                   & (cand[:, 1] == m))[0])))
        out.append(r)
        if len(out) == limit:
            break
    return np.stack(out).astype(np.int32), lanes


@functools.lru_cache(maxsize=None)
def _group_rows():
    """The rows the group apply is held on: kreconfig_edge_rows of the
    reachable batch (the reachable rows, chains into full and near-full
    bags, logs at max_log, every receipt arm, the forced rows),
    kreconfig_bag_rows (empty and full bags, unused slots with other
    words) and _existed_rows; with their dense expand and the existed
    rows' lanes (indices into the whole)."""
    jm, tm, batch = reachable()
    rows, want = _edges()
    bag = kreconfig_bag_rows(tm, batch, seed=4)
    ex, lanes = _existed_rows(tm, rows, want)
    more = np.concatenate([bag, ex])
    mwant = dense_expand(jm, more)
    base = len(rows) + len(bag)
    return (np.ascontiguousarray(np.concatenate([rows, more])),
            [np.concatenate(x) for x in zip(want, mwant)],
            [(base + i, a) for i, a in lanes])


@pytest.mark.parametrize("G", [1, 4, 8, 32])
def test_group_apply_matches_reference(lib, G):
    """``KReconfigFamily::apply``, the action of the card's group apply (a
    group of G threads a worklist lane), run with ``GrpSerial`` (the G
    members' shares of each bag put and multi-lane write in turn), against
    the dense expand bit for bit on every (row, candidate) lane."""
    _jm, tm, _batch, _dense = _pair()
    states, want, existed = _group_rows()
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, W = len(states), tm.A, tm.layout.W
    succ = np.zeros((C, A, W), np.int32)
    lib.host_group_apply(G, _ptr(states), C, _ptr(spec), _ptr(cand), A, _ptr(succ))
    assert np.array_equal(want[0], succ)
    # the rows reach the chains' overflows, both FetchResponse log installs,
    # a join at max_log, and accepted voters' fetches whose reply existed
    valid, rank, ovf = want[1:]
    for r in (kr.KR_REQUESTVOTE, kr.KR_BECOMELEADER, kr.KR_ACCEPT_JOIN):
        assert (valid & ovf & (rank == r)).any(), r
    for r in (kr.KR_HANDLE_FETCH_OK, kr.KR_HANDLE_FETCH_DIV):
        assert (valid & (rank == r)).any(), r
    assert existed
    for c, a in existed:
        assert not valid[c, a] and np.array_equal(succ[c, a], states[c])


def test_device_predicates_match_reference(lib):
    jm, tm, _batch, _dense = _pair()
    states, want = _edges()
    succs = np.ascontiguousarray(want[0].reshape(-1, tm.layout.W)[::5])
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    refs = dict(jm.invariants)
    for prop, insts in jm.liveness.items():
        for (_label, _p, fn), (_l, _tp, q) in zip(insts, tm.liveness[prop]):
            refs[q] = fn
    assert set(refs) == set(tm._pred_ids)
    for arr in (states, succs):
        for pred, fn in refs.items():
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(_ptr(arr), len(arr), _ptr(spec), tm._pred_ids[pred], _ptr(ok))
            assert np.array_equal(ok, np.asarray(fn(arr))), pred


@pytest.mark.parametrize("name", ["small", "full"])
def test_device_slot_canon_matches_reference(lib, name):
    """The slot canon's device code (one lane) against the reference's
    SlotCanonicalizer, symmetry on and off, seeds 0 and 3, on reachable
    rows and their successors."""
    jm, tm, batch = reachable(name)
    rows = np.ascontiguousarray(batch)
    if name == "small":
        _jm, _tm, _b, (succs, valid, _r, _o) = _pair()
        rows = np.ascontiguousarray(np.concatenate([rows, succs[valid][::4]]))
    for symmetry in (True, False):
        for seed in (0, 3):
            canon = tm.make_canonicalizer(symmetry, seed=seed)
            out = host_fingerprints(lib, tm, canon, rows, None, 16, 8)  # the kernel's tiles
            want = np.asarray(jax.device_get(
                jm.make_canonicalizer(symmetry, seed=seed).fingerprints(rows)))
            assert np.array_equal(fps_to_u64(torch.from_numpy(out)), want), (symmetry, seed)
            assert np.array_equal(fps_to_u64(canon.fingerprints(torch.from_numpy(rows))), want)


def test_kernel_spec_layout():
    _jm, tm, _batch, _dense = _pair()
    names = ("StatesMatchRoles", "TestInv", "ConfigAllOrNothing(2)", "CommittedValueOrNothing(v1)")
    spec, cand, ids = tm.kernel_spec("cpu", names)
    scal = dict(zip(kr.SPEC_SCALARS, spec.tolist()))
    lay = tm.layout
    assert (scal["S"], scal["W"], scal["A"], scal["K"], scal["NW"], scal["L"], scal["VL"]) == (
        tm.NS, lay.W, tm.A, len(tm.ACTION_NAMES), tm.n_words, tm.p.max_log, lay.view_len)
    for f in kr.SPEC_OFFSETS:
        assert scal[f] == lay.fields[f].offset, f
    for f in kr.SPEC_PARAMS:
        assert scal[f] == getattr(tm.p, f), f
    base = len(kr.SPEC_SCALARS)
    for k, f in enumerate(kr.MSG_FIELDS):
        assert spec[base + 3 * k: base + 3 * k + 3].tolist() == list(tm.packer.locate(f))
    assert tuple(kr.MSG_FIELDS) == tuple(tm.packer.fields)
    assert cand.shape == (tm.A, 4)
    assert [kr.GROUP_IDS[b[0]] for b in tm.bindings] == cand[:, 0].tolist()
    assert ids.tolist() == [7, 4, kr.PRED_CONFIG + 2, kr.PRED_VALUE]
    with pytest.raises(KeyError, match="no kernel predicate"):
        tm.kernel_spec("cpu", ("CommittedEntriesReachMajority",))
    # the full cfg's shapes fit the kernels' bounds
    full = kr.KRaftReconfigModel(kr.KRaftReconfigParams(**dataclasses.asdict(FULLP)))
    assert len(full.kernel_spec("cpu")[0]) == kr.SPEC_LEN

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
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models import kraft_reconfig as ref_kr
from raft_tpu_torch.convert import fps_to_u64
from raft_tpu_torch.models import kraft_reconfig as kr

from test_torch_actions_host import CSRC, SHIM
from test_torch_kraft_reconfig import FULLP, _edges, _pair, reachable
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

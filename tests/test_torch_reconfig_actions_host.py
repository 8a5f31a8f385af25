"""The device code of the reconfiguration kernels (raft_tpu_torch/csrc/
config_actions.cuh) against the JAX reference, on the CPU.

As tests/test_torch_kraft_actions_host.py does for kraft_actions.cuh: the
header builds with a host C++ compiler behind the shim of
tests/test_torch_actions_host.py. Each state goes through the group
guard's per-state work (actions_common.cuh ``guard_state`` over
``ConfigFamily<J>``: each member's lane alone, then the bag probes and
RequestVote's chains run by the group) and each (state, candidate) pair
through ``ConfigFamily<J>::apply`` (the action of the card's group apply),
both with ``GrpSerial``, which runs the G members' shares of each probe,
chain put and log install in turn, at G in {1, 4, 8, 32}; each state also
through ``ConfigFamily<J>::predicate`` (the invariants and
ReconfigurationCompletes' P and Q). The results must equal the dense
``jax.vmap(_expand1)``, the reference's invariants and its liveness
predicates bit for bit (tolerance: none, the values are integers), and the
guard's per-state sums (the enabled ranks, the valid-lane and fired counts,
terminal and overflow) the plain version's (``guard_plain``), on reachable
states and the edge rows of ``config_edge_rows``
(tests/test_torch_kernels_cuda.py): every HandleMessage arm, the snapshot
pair, the config appends, ResetWithSameIdentity, RequestVote chains that
overflow partway and logs at max_log; the guard also on
``config_chain_pushoff_rows`` (a full bag where the chain's first put
pushes off the key its second put names). At three servers and on the
five-server constants' (5 and 7 key words) at a small depth. Skips without
g++.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_tpu_torch.models import config_common as cc
from raft_tpu_torch.models.base import INVARIANT_IDS
from raft_tpu_torch.ops.expand import guard_plain

from conftest import collect_states
from test_torch_actions_host import CSRC, SHIM
from test_torch_canon_tiers_wide import PARAMS5
from test_torch_kernels_cuda import config_chain_pushoff_rows, config_edge_rows
from test_torch_reconfig import PARAMS, _edges, _models, _oracle, _pair, dense_expand

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

DRIVER = """\
#include <vector>
#include "config_actions.cuh"
extern "C" int spec_len() { return CS_LEN; }
// the group guard's per-state work on each state (live: c < n_live), a
// group of G: valid/rank/ovf [C, A], and per state its enabled-rank mask,
// valid lanes and overflow; fired [K] added into
template <bool J>
static void group_guard(int G, const int* states, int C, int n_live, const int* spec,
                        const int* cand, bool* valid, int* rank, bool* ovf, unsigned* en,
                        int* n_valid, bool* any_ovf, long long* fired) {
  typedef ConfigFamily<J> F;
  const int W = spec[CS_W], A = spec[CS_A];
  std::vector<int> scratch(F::MAX_WORDS * spec[CS_M]);  // the group's chain copy
  for (int c = 0; c < C; ++c) {
    const long long l0 = (long long)c * A;
    const GuardSums r = guard_state<F>(GrpSerial{G}, spec, states + (long long)c * W, cand,
                                       c < n_live, scratch.data(), valid + l0, rank + l0,
                                       ovf + l0, [&](int k, int n) { fired[k] += n; });
    en[c] = r.en;
    n_valid[c] = r.n_valid;
    any_ovf[c] = r.ovf;
  }
}
extern "C" void host_group_guard(int joint, int G, const int* states, int C, int n_live,
                                 const int* spec, const int* cand, bool* valid, int* rank,
                                 bool* ovf, unsigned* en, int* n_valid, bool* any_ovf,
                                 long long* fired) {
  if (joint) group_guard<true>(G, states, C, n_live, spec, cand, valid, rank, ovf, en, n_valid,
                               any_ovf, fired);
  else group_guard<false>(G, states, C, n_live, spec, cand, valid, rank, ovf, en, n_valid,
                          any_ovf, fired);
}
template <bool J>
static void group_apply(int G, const int* states, int C, const int* spec, const int* cand, int A,
                        int* succ) {
  const int W = spec[CS_W];
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < A; ++a) {
      const int* s = states + (long long)c * W;
      int* o = succ + ((long long)c * A + a) * W;
      for (int w = 0; w < W; ++w) o[w] = s[w];
      ConfigFamily<J>::apply(GrpSerial{G}, spec, s, o, cand + 4 * a);
    }
}
extern "C" void host_group_apply(int joint, int G, const int* states, int C, const int* spec,
                                 const int* cand, int A, int* succ) {
  if (joint) group_apply<true>(G, states, C, spec, cand, A, succ);
  else group_apply<false>(G, states, C, spec, cand, A, succ);
}
extern "C" void host_predicate(int joint, const int* states, int C, const int* spec, int id,
                               bool* ok) {
  for (int c = 0; c < C; ++c) {
    const int* s = states + (long long)c * spec[CS_W];
    ok[c] = joint ? JointFamily::predicate(spec, s, id) : ReconfigFamily::predicate(spec, s, id);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_config_actions")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(DRIVER)
    so = d / "libhost_config_actions.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_group_guard.argtypes = [I, I, P, I, I, P, P, P, P, P, P, P, P, P]
    lib.host_predicate.argtypes = [I, P, I, P, I, P]
    lib.host_group_apply.argtypes = [I, I, P, I, P, P, I, P]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _group_guard(lib, name, tm, states, n_live, G):
    """The group guard's per-state work on ``states`` (GrpSerial of G):
    (valid, rank, ovf, enabled-rank mask, valid lanes and overflow a state,
    fired a rank)."""
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, K = len(states), tm.A, len(tm.ACTION_NAMES)
    valid, rank, ovf = np.zeros((C, A), bool), np.zeros((C, A), np.int32), np.zeros((C, A), bool)
    en, n_valid, any_ovf = np.zeros(C, np.uint32), np.zeros(C, np.int32), np.zeros(C, bool)
    fired = np.zeros(K, np.int64)
    lib.host_group_guard(int(name == "joint"), G, _ptr(states), C, n_live, _ptr(spec),
                         _ptr(cand), _ptr(valid), _ptr(rank), _ptr(ovf), _ptr(en),
                         _ptr(n_valid), _ptr(any_ovf), _ptr(fired))
    return valid, rank, ovf, en, n_valid, any_ovf, fired


def _group_apply(lib, name, tm, states, G):
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, W = len(states), tm.A, tm.layout.W
    succ = np.zeros((C, A, W), np.int32)
    lib.host_group_apply(int(name == "joint"), G, _ptr(states), C, _ptr(spec), _ptr(cand), A,
                         _ptr(succ))
    return succ


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_actions_match_reference(lib, name):
    _jm, tm, _batch, _dense = _pair(name)
    assert lib.spec_len() == cc.SPEC_LEN  # the header's CS_*/CF_* enums and SPEC_SCALARS agree
    states, want = _edges(name)
    C = len(states)
    # the guard and the apply as groups of one
    valid, rank, ovf = _group_guard(lib, name, tm, states, C, 1)[:3]
    for label, w, g in zip(("valid", "rank", "ovf"), want[1:], (valid, rank, ovf)):
        assert np.array_equal(w, g), label
    assert np.array_equal(want[0], _group_apply(lib, name, tm, states, 1))
    # every Next disjunct fires on these rows, and RequestVote's chain,
    # ClientRequest and an accepted entry overflow
    assert set(np.unique(want[2][want[1]]).tolist()) == set(range(len(tm.ACTION_NAMES)))
    hit = want[1] & want[3]
    for r in (cc.R_REQUESTVOTE, cc.R_CLIENTREQUEST, cc.R_ACCEPT_AE):
        assert (hit & (want[2] == r)).any(), r


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_predicates_match_reference(lib, name):
    jm, tm, _batch, _dense = _pair(name)
    states, want = _edges(name)
    succs = np.ascontiguousarray(want[0].reshape(-1, tm.layout.W)[::5])
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    ids = {n: i for n, i in (dict(INVARIANT_IDS) | cc.CONFIG_PRED_IDS).items()}
    assert set(jm.invariants) <= set(ids)
    p_ref, q_ref = jm.liveness["ReconfigurationCompletes"][0][1:]
    refs = dict(jm.invariants) | {"ReconfigurationCompletes.P": p_ref,
                                  "ReconfigurationCompletes.Q": q_ref}
    joint = int(name == "joint")
    for arr in (states, succs):
        for pred, iid in ids.items():
            ok = np.zeros(len(arr), bool)
            lib.host_predicate(joint, _ptr(arr), len(arr), _ptr(spec), iid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(refs[pred](arr))), pred


@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_spec_layout(name):
    _jm, tm, _batch, _dense = _pair(name)
    names = ("MaxOneReconfigurationAtATime", "TestInv", "ReconfigurationCompletes.Q")
    spec, cand, ids = tm.kernel_spec("cpu", names)
    scal = dict(zip(cc.SPEC_SCALARS, spec.tolist()))
    lay = tm.layout
    assert (scal["W"], scal["A"], scal["K"], scal["NW"], scal["L"]) == (
        lay.W, tm.A, len(tm.ACTION_NAMES), tm.n_words, tm.p.max_log)
    extra = {f"log_x{k}": f"log_{n}" for k, n in enumerate(tm.ENTRY_FIELDS[4:])}
    for f in cc.SPEC_OFFSETS:
        want = lay.fields[extra.get(f, f)].offset if extra.get(f, f) in lay.fields else -1
        assert scal[f] == want, f
    # the message triples: the record fields, then e_* and l{k}_* by slot
    base = len(cc.SPEC_SCALARS)
    for k, f in enumerate(cc.MSG_FIELDS):
        assert spec[base + 3 * k: base + 3 * k + 3].tolist() == list(tm.packer.locate(f))
    e0 = base + 3 * (len(cc.MSG_FIELDS) + cc.ENTRY_SLOTS * (1 + 2))  # lane 2's first slot
    assert spec[e0:e0 + 3].tolist() == list(tm.packer.locate("l2_term"))
    assert cand.shape == (tm.A, 4)
    assert [cc.GROUP_IDS[b[0]] for b in tm.bindings] == cand[:, 0].tolist()
    assert ids.tolist() == [5, INVARIANT_IDS["TestInv"], 17]
    with pytest.raises(KeyError, match="no kernel predicate"):
        tm.kernel_spec("cpu", ("ReconfigurationCompletes",))


@functools.lru_cache(maxsize=None)
def _edges5(name):
    """config_edge_rows of reachable five-server states (PARAMS5, depth 4)
    and their dense expand."""
    jm, tm = _models(PARAMS5[name])
    batch = np.stack([jm.encode(s) for s in collect_states(_oracle(PARAMS5[name]), 4, cap=24)])
    rows = config_edge_rows(tm, batch.astype(np.int32), seed=len(name) + 5)
    return tm, rows, dense_expand(jm, rows)


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("servers", [3, 5])
@pytest.mark.parametrize("name", list(PARAMS))
def test_group_apply_matches_reference(lib, name, servers, G):
    if servers == 3:
        tm, (states, want) = _pair(name)[1], _edges(name)
    else:
        tm, states, want = _edges5(name)
        assert tm.n_words == {"reconfig": 5, "joint": 7}[name]
    assert np.array_equal(want[0], _group_apply(lib, name, tm, states, G))
    # the rows put into full and near-full bags, and install logs
    hit = want[1] & want[3]
    assert (hit & (want[2] == cc.R_REQUESTVOTE)).any()
    assert (want[1] & (want[2] == cc.R_ACCEPT_AE)).any()


@functools.lru_cache(maxsize=None)
def _pushoff(name, servers):
    """config_chain_pushoff_rows of reachable states, their dense expand."""
    jp = PARAMS[name] if servers == 3 else PARAMS5[name]
    jm, tm = _models(jp)
    base = _pair(name)[2][:12] if servers == 3 else _edges5(name)[1][:12]
    rows = config_chain_pushoff_rows(tm, base, seed=servers)
    return rows, dense_expand(jm, rows)


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("servers", [3, 5])
@pytest.mark.parametrize("name", list(PARAMS))
def test_group_guard_matches_reference(lib, name, servers, G):
    """The group guard's per-state work (GrpSerial of G) against the dense
    expand and the plain version: valid/rank/ovf a lane (a dead tail of 5
    states), each state's enabled ranks and terminal flag, the fired
    counts and the chunk's overflow, bit for bit."""
    if servers == 3:
        tm, (states, want) = _pair(name)[1], _edges(name)
    else:
        tm, states, want = _edges5(name)
    rows, pwant = _pushoff(name, servers)
    states = np.ascontiguousarray(np.concatenate([states, rows]))
    want = [np.concatenate([a, b]) for a, b in zip(want, pwant)]
    C, K = len(states), len(tm.ACTION_NAMES)
    n_live = C - 5
    valid, rank, ovf, en, n_valid, any_ovf, fired = _group_guard(lib, name, tm, states, n_live,
                                                                 G)
    live = np.arange(C) < n_live
    assert np.array_equal(want[1] & live[:, None], valid)
    assert np.array_equal(want[2], rank) and np.array_equal(want[3], ovf)
    ranks = np.where(valid, want[2], K)
    want_en = np.array([sum(1 << int(k) for k in set(r.tolist()) - {K}) for r in ranks])
    assert np.array_equal(want_en, en)
    assert np.array_equal(live & (n_valid == 0), live & ~valid.any(1))  # terminal
    assert np.array_equal(any_ovf, (valid & ovf).any(1))
    # the plain version's sums: fired and enabled per rank, n_gen, terminal
    cov = torch.zeros((K, 3), dtype=torch.int64)
    gp = guard_plain(tm, torch.from_numpy(states), n_live, cov)
    assert np.array_equal(gp[0].numpy(), valid) and np.array_equal(gp[1].numpy(), rank)
    assert np.array_equal(gp[2].numpy(), ovf)
    assert np.array_equal(cov[:, 1].numpy(), fired)
    assert np.array_equal(cov[:, 0].numpy(), [int((en >> k & 1).sum()) for k in range(K)])
    assert gp[3].tolist() == [int(n_valid.sum()), int((live & (n_valid == 0)).sum()),
                              int(any_ovf.any())]
    # the push-off rows: server 0's RequestVote stays enabled and overflows
    rv0 = [a for a, b in enumerate(tm.bindings) if b == ("RequestVote", (0,))]
    assert len(rv0) == 1
    tail = slice(C - len(rows), n_live)
    assert valid[tail, rv0[0]].all() and ovf[tail, rv0[0]].all()

"""The device code of the canon_memo kernel (csrc/canon_memo.cuh over
csrc/canon_tiers.cuh's hash parts), compiled for the host, against the JAX
reference's ``Canonicalizer`` (raw keys and the full-S! min of
``fingerprints``) and the port's plain ``fingerprints_memo_plain``, bit for
bit (tolerance: none; every value is a hash).

Each lane is computed by a serial group of G members (``CtSerial``: the G
shares run in turn and combined as a tile's butterflies combine them: the
raw hash's lanes and slots, a miss's permutations), at G = 1 to 32, on both
builds: the 2-word one (Raft at two and three
servers, KRaft's Nil-able mleader) and the general one (the four-server
AddRemove and JointConsensus stand-ins: N-word keys, the member-set bitmask
kind, P = 24), at small constants. The samples are reachable states and
their server-permuted copies. The C++ code below replays the kernel's memo
protocol serially (an invalid lane writes INT64_MAX and slot -1 and reads no
row, a valid one probes, a miss claims its slot and the highest lane wins,
hits are counted a state) to hold the host build to
``fingerprints_memo_plain`` on a worklist with an invalid tail.
"""

import ctypes
import dataclasses
import functools
import itertools
import math
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models.kraft import KRaftParams, cached_model as kraft_model
from raft_tpu.models.raft import RaftParams, cached_model as raft_model
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu.oracle.kraft_oracle import KRaftOracle
from raft_tpu.oracle.raft_oracle import oracle_for
from raft_tpu_torch.convert import fps_from_u64, params_from_reference
from raft_tpu_torch.models.kraft import KRaftModel
from raft_tpu_torch.models.raft import RaftModel, RaftParams as TorchRaftParams
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.symmetry import TIER_HEADER, Canonicalizer, msg_perm_spec, permute_states

from conftest import collect_states
from test_torch_actions_host import SHIM
from test_torch_canon_tiers import CSRC
from test_torch_reconfig import PARAMS4, _models as _config_models, _oracle as _config_oracle

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

RAFT = dict(n_values=1, max_elections=2, max_restarts=0, msg_slots=16)
LAYOUTS = ("raft2", "raft3", "kraft3", "addremove4", "joint4")
GROUPS = (1, 2, 4, 8, 16, 32)


@functools.lru_cache(maxsize=None)
def _sample(name):
    """(JAX model, port model, reachable rows followed by server-permuted
    copies of them, one permutation a block)."""
    rng = np.random.default_rng(5)
    if name.startswith("raft"):
        p = dict(RAFT, n_servers=int(name[-1]))
        jm, tm = raft_model(RaftParams(**p)), RaftModel(TorchRaftParams(**p))
        states = collect_states(oracle_for(jm.p), 8, cap=60)
    elif name == "kraft3":
        jp = KRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=40)
        jm, tm = kraft_model(jp), KRaftModel(params_from_reference(dataclasses.asdict(jp)))
        states = collect_states(KRaftOracle(3, 1, 2, 0), 8, cap=60)
    else:  # the four-server cfgs' constants at 24 message slots
        jp = dataclasses.replace(PARAMS4["reconfig" if name == "addremove4" else "joint"],
                                 msg_slots=24)
        jm, tm = _config_models(jp)
        oracle = _config_oracle(jp)
        states = collect_states(oracle, 8, cap=24)
        for _ in range(8):  # random walks reach deeper bags and member sets
            s = oracle.init_state()
            for d in range(15):
                succ = oracle.successors(s)
                if not succ:
                    break
                s = succ[rng.integers(len(succ))][1]
                if d % 3 == 2:
                    states.append(s)
    base = np.stack([jm.encode(s) for s in states]).astype(np.int32)
    S = tm.p.n_servers
    sigmas = [np.asarray(x) for x in itertools.permutations(range(S))][1:]
    pick = rng.choice(len(sigmas), min(len(sigmas), 6), replace=False)
    perm = np.concatenate([
        permute_states(tm.layout, tm.packer, part, sigmas[k], msg_perm_spec(tm))
        for part, k in zip(np.array_split(base, len(pick)), pick)])
    return jm, tm, np.ascontiguousarray(np.concatenate([base, perm]))


@functools.lru_cache(maxsize=None)
def _ref(name, seed=0):
    """The reference's (raw keys, canonical fingerprints) of the sample."""
    jm, _tm, batch = _sample(name)
    jc = JaxCanonicalizer.for_model(jm, symmetry=True, seed=seed)
    u64 = lambda a: fps_from_u64(np.asarray(jax.device_get(a)).reshape(-1))  # noqa: E731
    return u64(jc.raw_fingerprints(batch)), u64(jc.fingerprints(batch))


def _port(name, seed=0, symmetry=True) -> Canonicalizer:
    return Canonicalizer.for_model(_sample(name)[1], symmetry=symmetry, seed=seed)


# ---------------- csrc/canon_memo.cuh on the host ----------------

HOST_SRC = """\
#include <vector>
#include "canon_memo.cuh"
// raw keys and canonical fingerprints of every lane by a serial group of G
// shares
template <int NW>
void run(const int* spec, const int* states, int B, int W, int G, long long* raw,
         long long* canon) {
  CtSerial g{G};
  for (int b = 0; b < B; ++b) {
    const int* v = states + (long long)b * W;
    raw[b] = rt_enc(ct_raw<NW>(spec, v, g));
    canon[b] = rt_enc(cm_canon<NW>(spec, v, g));
  }
}
extern "C" void host_canon(const int* spec, const int* states, int B, int W, int G,
                           long long* raw, long long* canon) {
  if (spec[CT_GENERAL])
    run<0>(spec, states, B, W, G, raw, canon);
  else
    run<2>(spec, states, B, W, G, raw, canon);
}
// the kernel's memo protocol replayed lane by lane (ct_memo_tile, then the
// insert launch): fps, the memo updated in place, the hits a state
template <int NW>
long long memo_run(const int* spec, const int* states, const bool* valid, int B, int W, int G,
                   int sym, long long* memo, int mcap, long long* fps) {
  CtSerial g{G};
  std::vector<int> claim(mcap, -1), slot(B, -1);
  std::vector<long long> raw(B, RT_ENC_MAX);
  long long hits = 0;
  for (int b = 0; b < B; ++b) {
    fps[b] = RT_ENC_MAX;
    if (!valid[b]) continue;  // an invalid lane reads no row
    const int* v = states + (long long)b * W;
    const uint64_t r = ct_raw<NW>(spec, v, g);
    raw[b] = fps[b] = rt_enc(r);
    if (!sym) continue;
    const int s = rt_memo_slot(r, mcap);
    if (memo[2 * s] == raw[b] && raw[b] != RT_ENC_MAX) {
      fps[b] = memo[2 * s + 1];
      ++hits;
      continue;
    }
    fps[b] = rt_enc(cm_canon<NW>(spec, v, g));
    slot[b] = s;
    claim[s] = claim[s] > b ? claim[s] : b;
  }
  for (int b = 0; b < B; ++b)
    if (slot[b] >= 0 && claim[slot[b]] == b) {
      memo[2 * slot[b]] = raw[b];
      memo[2 * slot[b] + 1] = fps[b];
    }
  return hits;
}
extern "C" long long host_memo(const int* spec, const int* states, const bool* valid, int B,
                               int W, int G, int sym, long long* memo, int mcap, long long* fps) {
  return spec[CT_GENERAL] ? memo_run<0>(spec, states, valid, B, W, G, sym, memo, mcap, fps)
                          : memo_run<2>(spec, states, valid, B, W, G, sym, memo, mcap, fps);
}
extern "C" int host_nth_perm(int p, int S, int* sigma) {
  const CmPerm c = cm_nth_perm(p, S);
  for (int i = 0; i < S; ++i) sigma[i] = c[i];
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_memo")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "host_memo.cpp").write_text(HOST_SRC)
    so = d / "libhost_memo.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "host_memo.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_canon.argtypes = [P, P, I, I, I, P, P]
    lib.host_memo.argtypes = [P, P, P, I, I, I, I, P, I, P]
    lib.host_memo.restype = ctypes.c_longlong
    lib.host_nth_perm.argtypes = [I, I, P]
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_canon(lib, tc, batch, G):
    """(raw keys, canonical fingerprints) of ``batch`` by the host build."""
    spec = tc.tier_spec(memo=True)
    B, W = batch.shape
    raw, canon = np.zeros(B, np.int64), np.zeros(B, np.int64)
    lib.host_canon(_p(spec), _p(np.ascontiguousarray(batch)), B, W, G, _p(raw), _p(canon))
    return torch.from_numpy(raw), torch.from_numpy(canon)


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_build(name):
    # the 2-word build for hi/lo keys with plain or Nil-able fields, the
    # general one for N-word keys and member sets; P = S!
    tc = _port(name)
    spec = tc.tier_spec(memo=True)
    hdr = dict(zip(TIER_HEADER, spec[:len(TIER_HEADER)].tolist()))
    assert hdr["len"] == len(spec) and hdr["S"] == tc.S and tc.P == math.factorial(tc.S)
    assert hdr["general"] == int(name.endswith("4")) == int(tc.memo_general())
    if name == "kraft3":
        assert ("mleader", "server_nil") in tc.spec
    if hdr["general"]:
        assert any(k == "server_bitmask" for _f, k in tc.spec)


def test_nth_perm_enumerates_lexicographic_order(lib):
    for S in range(1, 5):
        sigma = np.zeros(4, np.int32)
        got = []
        for p in range(math.factorial(S)):
            lib.host_nth_perm(p, S, _p(sigma))
            got.append(tuple(sigma[:S].tolist()))
        assert got == list(itertools.permutations(range(S)))


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", LAYOUTS)
def test_host_canon_bit_identical(lib, name, G):
    # the G shares combined give the reference's raw keys and full-S!
    # fingerprints bit for bit; the permuted copies keep their fingerprints
    want_raw, want = _ref(name)
    batch = _sample(name)[2]
    raw, canon = _host_canon(lib, _port(name), batch, G)
    assert torch.equal(raw, want_raw)
    assert torch.equal(canon, want)
    n = len(batch) // 2
    assert torch.equal(canon[:n], canon[n:])


@pytest.mark.parametrize("name", ["raft3", "addremove4"])
def test_host_canon_seeded(lib, name):
    # the second hash family (--collision-audit): seeded salts and stream
    # xors computed from the spec
    want_raw, want = _ref(name, seed=0x5EED5EED)
    raw, canon = _host_canon(lib, _port(name, seed=0x5EED5EED), _sample(name)[2], 8)
    assert torch.equal(raw, want_raw) and torch.equal(canon, want)


@pytest.mark.parametrize("symmetry", [True, False], ids=["symmetry", "raw"])
@pytest.mark.parametrize("name", ["raft3", "kraft3", "joint4"])
def test_host_memo_protocol_equals_plain(lib, name, symmetry):
    # a worklist as the BFS gives it: a valid prefix, then an invalid tail;
    # cold, then warm through a 64-row memo: fingerprints (INT64_MAX on the
    # invalid lanes), memo rows and hits a state equal the plain version's
    tc = _port(name, symmetry=symmetry)
    batch = _sample(name)[2]
    B, W = batch.shape
    states = np.concatenate([batch, batch[::-1][: B // 2]])
    valid = np.arange(len(states)) < B
    mk = np.full((64, 2), INT64_MAX, np.int64)
    mp = torch.from_numpy(mk.copy())
    for G in (8, 32):  # the tiles of the two builds
        for _ in range(2):
            fps = np.zeros(len(states), np.int64)
            hk = lib.host_memo(_p(tc.tier_spec(memo=True)), _p(states), _p(valid), len(states), W,
                               G, int(symmetry), _p(mk), 64, _p(fps))
            fp, hp = tc.fingerprints_memo_plain(torch.from_numpy(states),
                                                torch.from_numpy(valid), mp)
            assert torch.equal(torch.from_numpy(fps), fp) and int(hk) == int(hp)
            assert torch.equal(torch.from_numpy(mk), mp)
            assert bool((fp[B:] == INT64_MAX).all())
    if symmetry:
        assert int(hp) > 0

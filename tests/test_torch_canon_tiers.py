"""The five-server canonical fingerprint of the port (raft_tpu_torch/ops/
symmetry.py: the signatures and the signature-admissible min, plain
PyTorch, and the device code of csrc/canon_tiers.cuh compiled for the
host) against the JAX reference's ``Canonicalizer`` (``_signatures``,
``fingerprints`` in its tiered auto mode, ``fingerprints_memo``), bit for
bit.

The samples are reachable states of the reference's ``raft5`` fixture
(tests/test_symmetry_v3.py: 5 servers, 2 values, MaxElections 2) and of a
six-server layout (the kernel takes 5 <= S <= CT_MAX_S), their
server-permuted copies, replicated Init states (one all-tied tie group:
the S! route) and depth-2 states whose tie pattern holds a group of three
or more that is not all-tied (the reference's tie-group-local route).
"""

import ctypes
import functools
import math
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu.oracle.raft_oracle import oracle_for
from raft_tpu_torch.convert import fps_from_u64
from raft_tpu_torch.models.raft import RaftModel, RaftParams as TorchRaftParams
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.symmetry import TIER_HEADER, Canonicalizer, permute_states

from conftest import collect_states
from test_torch_actions_host import SHIM

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

RAFT5 = dict(n_servers=5, n_values=2, max_elections=2, max_restarts=0, msg_slots=48)
LAYOUTS = {"raft5": RAFT5,
           "six_servers": dict(n_servers=6, n_values=1, max_elections=1, max_restarts=0,
                               msg_slots=24)}
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "raft_tpu_torch", "csrc")


@functools.lru_cache(maxsize=None)
def _models(layout="raft5"):
    p = LAYOUTS[layout]
    return cached_model(RaftParams(**p)), RaftModel(TorchRaftParams(**p))


@functools.lru_cache(maxsize=None)
def _batch(layout="raft5") -> np.ndarray:
    """Init replicas, depth-2 and depth-4 reachable states, and their
    server-permuted copies (one permutation per block of states)."""
    jm, tm = _models(layout)
    oracle = oracle_for(jm.p)
    deep = [jm.encode(s) for s in collect_states(oracle, 4, cap=90)]
    shallow = [jm.encode(s) for s in collect_states(oracle, 2, cap=60)]
    base = np.stack(deep + shallow).astype(np.int32)
    rng = np.random.default_rng(3)
    perm = np.concatenate([
        permute_states(tm.layout, tm.packer, part, rng.permutation(jm.p.n_servers))
        for part in np.array_split(base, 6)])
    init = np.repeat(jm.init_states(), 4, axis=0).astype(np.int32)
    return np.concatenate([init, base, perm])


def _u64(a) -> torch.Tensor:
    a = np.asarray(jax.device_get(a))
    return fps_from_u64(a.reshape(-1)).reshape(a.shape)


@functools.lru_cache(maxsize=None)
def _ref(seed=0, layout="raft5") -> dict:
    """The reference's signatures, raw keys and fingerprints of _batch()
    (one compile per hash family and layout)."""
    jm, _ = _models(layout)
    jc = JaxCanonicalizer(jm.layout, jm.packer, symmetry=True, seed=seed)
    batch = _batch(layout)
    return dict(sig=_u64(jax.jit(jc._signatures)(batch[:, :jc.VL])),
                raw=_u64(jc.raw_fingerprints(batch)), fps=_u64(jc.fingerprints(batch)),
                canon=jc)


def _port(seed=0, layout="raft5") -> Canonicalizer:
    _, tm = _models(layout)
    return Canonicalizer(tm.layout, tm.packer, seed=seed)


def test_sample_reaches_every_route():
    # the reference's own classification: the sample holds lanes of its
    # tie-group-local route and of its full S! route
    jc = _ref()["canon"]
    tiers = jax.jit(lambda v: jc._tier_pre(v, jc._signatures(v))[3:])
    is_local, is_full = tiers(_batch()[:, :jc.VL])
    assert np.asarray(is_local).sum() > 0 and np.asarray(is_full).sum() > 0


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=["raft", "six_servers"])
def test_signatures_bit_identical(layout):
    got = _port(layout=layout).signatures(torch.from_numpy(_batch(layout)))
    assert torch.equal(got, _ref(layout=layout)["sig"])


def test_signatures_equivariant():
    # sig(perm(x))[sigma[i]] == sig(x)[i]
    _, tm = _models()
    tc = _port()
    base = _batch()[4:60]
    sig = tc.signatures_plain(torch.from_numpy(base))
    for sigma in ([1, 2, 3, 4, 0], [4, 3, 2, 1, 0], [0, 2, 1, 4, 3]):
        psig = tc.signatures_plain(torch.from_numpy(
            permute_states(tm.layout, tm.packer, base, sigma)))
        assert torch.equal(psig[:, sigma], sig)


@pytest.mark.parametrize("seed,layout", [(0, "raft5"), (1, "raft5"), (0, "six_servers")],
                         ids=["raft", "seed1", "six_servers"])
def test_canon_bit_identical(seed, layout):
    tc = _port(seed=seed, layout=layout)
    assert tc.prune and tc.P == math.factorial(tc.S)
    batch = torch.from_numpy(_batch(layout))
    got = tc.canon_plain(batch)
    assert torch.equal(got, _ref(seed, layout)["fps"])
    assert torch.equal(tc.raw_fingerprints(batch), _ref(seed, layout)["raw"])
    # permuted copies share the fingerprints of their originals
    n = (len(batch) - 4) // 2
    assert torch.equal(got[4:4 + n], got[4 + n:])


def test_memo_path_bit_identical():
    # a memo hit returns exactly what the cold canon computed (the
    # reference's memo contract); the reference's own hit counts differ
    # by design (it also dedups equal raw keys inside a batch)
    tc = _port()
    batch = torch.from_numpy(_batch())
    valid = torch.ones(len(batch), dtype=torch.bool)
    valid[::7] = False
    want = torch.where(valid, _ref()["fps"], INT64_MAX)
    memo = torch.full((256, 2), INT64_MAX, dtype=torch.int64)
    cold, cold_hits = tc.fingerprints_memo(batch, valid, memo)
    assert torch.equal(cold, want) and int(cold_hits) == 0
    warm, warm_hits = tc.fingerprints_memo(batch, valid, memo)
    assert torch.equal(warm, want) and int(warm_hits) > 0


def test_positional_salts_match_reference_tables():
    # the hash positions of the lane descriptors (c0 + sigma[s1] m1 +
    # sigma[s2] m2, which csrc/canon_tiers.cuh computes per permutation)
    # give the reference's static per-permutation salt tables
    # (_build_direct, in the same group order: plain, val, bm lanes)
    tc = _port()
    dt = _ref()["canon"]._dt_full
    for k, stream in ((0, "pa"), (1, "pb")):
        want = np.concatenate([np.asarray(dt[f"{stream}_{g}"]) for g in ("plain", "val", "bm")],
                              axis=1).astype(np.int64)
        assert np.array_equal(tc._host["perm"][k], want)
    spec = tc.tier_spec()
    assert len(spec) == spec[TIER_HEADER.index("len")]


# ---------------- csrc/canon_tiers.cuh on the host ----------------

HOST_SRC = """\
#include "canon_tiers.cuh"
extern "C" int hdr_len() { return CT_HDR; }
// every lane by a group of G shares run in turn and combined (CtSerial)
template <int NW>
void run(const int* spec, const int* states, int B, int W, int G, long long* sig,
         long long* raw, long long* canon) {
  const int S = spec[CT_S];
  CtSerial g{G};
  for (int b = 0; b < B; ++b) {
    const int* v = states + (long long)b * W;
    uint64_t s[CT_MAX_S];
    ct_signatures<NW>(spec, v, s, g);
    for (int i = 0; i < S; ++i) sig[b * S + i] = rt_enc(s[i]);
    raw[b] = rt_enc(ct_raw<NW>(spec, v, g));
    canon[b] = rt_enc(ct_canon<NW>(spec, v, g));
  }
}
// the kernel's two builds: the general path (NW = 0) or the 2-word one
extern "C" void host_tiers(const int* spec, const int* states, int B, int W, int G,
                           long long* sig, long long* raw, long long* canon) {
  if (spec[CT_GENERAL])
    run<0>(spec, states, B, W, G, sig, raw, canon);
  else
    run<2>(spec, states, B, W, G, sig, raw, canon);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    d = tmp_path_factory.mktemp("host_tiers")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "host_tiers.cpp").write_text(HOST_SRC)
    so = d / "libhost_tiers.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "host_tiers.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.host_tiers.argtypes = [P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P, P]
    return lib


def _host_run(lib, tc, batch, G=1):
    """(signatures, raw keys, fingerprints) of ``batch`` by the host build,
    each lane's sums split into G shares and combined."""
    spec = tc.tier_spec()
    assert lib.hdr_len() == len(TIER_HEADER)  # the header's CT_* enum and TIER_HEADER agree
    B, W = batch.shape
    sig = np.zeros((B, tc.S), np.int64)
    raw = np.zeros(B, np.int64)
    canon = np.zeros(B, np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.host_tiers(p(spec), p(np.ascontiguousarray(batch)), B, W, G, p(sig), p(raw), p(canon))
    return torch.from_numpy(sig), torch.from_numpy(raw), torch.from_numpy(canon)


@pytest.mark.parametrize("seed,layout", [(0, "raft5"), (1, "raft5"), (0, "six_servers")],
                         ids=["raft", "seed1", "six_servers"])
def test_host_compiled_tiers_bit_identical(lib, seed, layout):
    sig, raw, canon = _host_run(lib, _port(seed, layout), _batch(layout))
    ref = _ref(seed, layout)
    assert torch.equal(sig, ref["sig"])
    assert torch.equal(raw, ref["raw"])
    assert torch.equal(canon, ref["fps"])


def test_host_compiled_enumerates_every_admissible_permutation(lib):
    # on all-tied Init lanes the admissible set is all 120 permutations:
    # the enumeration must reach the plain full-S! min
    _, tm = _models()
    tc = _port()
    init = np.repeat(tm.init_states(), 2, axis=0).astype(np.int32)
    _, _, canon = _host_run(lib, tc, init)
    full = tc._hash(torch.from_numpy(init)[:, :tc.VL], remap=True).min(dim=0).values
    assert torch.equal(canon, full)


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("layout", list(LAYOUTS), ids=["raft", "six_servers"])
def test_host_group_shares_bit_identical(lib, layout, G):
    # canon_tiered splits every hash and signature sum of a lane over a
    # group of G threads (the 2-word build G = 8): the G shares, combined,
    # give the reference's signatures, raw keys and fingerprints bit for bit
    sig, raw, canon = _host_run(lib, _port(0, layout), _batch(layout), G)
    ref = _ref(0, layout)
    assert torch.equal(sig, ref["sig"])
    assert torch.equal(raw, ref["raw"])
    assert torch.equal(canon, ref["fps"])

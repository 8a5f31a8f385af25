"""The device code of the slot_canon kernel (raft_tpu_torch/csrc/
slot_canon.cuh), compiled for the host, against the JAX reference's
``SlotCanonicalizer.fingerprints`` (raft_tpu/models/kraft_reconfig.py:2017)
and the port's plain ``fingerprints_plain``, bit for bit (tolerance: none;
every value is a hash).

``host_slot_canon`` replays the kernel with serial groups (``CtSerial``):
the block's tables, then per row an invalid row's INT64_MAX, or the row's
part by a group of G members and the sigmas split over G / GS sub-groups of
GS members in turn, the least pair hash of each, then the min across them.
It runs at G = 1 to 32 and at every sub-tile size GS the kernel takes (a
power of two dividing G), symmetry on and off, hash seeds 0 and 3, on
reachable rows of the reference tests' SMALLP constants and of the full cfg
(FULLP, P = 12 pairs), their host- and value-permuted copies (each pair's
remapped, slot-sorted rows), ``kreconfig_edge_rows``, and rows whose bags
are full (c = M), empty (c = 0), hold an unused slot with key words after
EMPTY (its rank among the unused slots) or a word 0 above EMPTY (every slot
ranked under each pair), with a worklist's valid prefix and invalid tail.
Skips without a host C++ compiler.
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.convert import fps_to_u64
from raft_tpu_torch.ops.hashing import INT64_MAX, seed_salts
from raft_tpu_torch.ops.packing import EMPTY

from test_torch_actions_host import CSRC, SHIM
from test_torch_kernels_cuda import kreconfig_bag_rows, kreconfig_edge_rows
from test_torch_kraft_reconfig import reachable

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

GROUPS = (1, 2, 4, 8, 16, 32)

# slot_canon.cu's kernel with serial groups (also built by
# tests/test_torch_kraft_reconfig_actions_host.py)
SLOT_DRIVER = """\
#include <vector>
#include "slot_canon.cuh"
extern "C" void host_slot_canon(const int* states, long long N, int W, const bool* valid,
                                const int* spec, const int* sig, int nsig, const int* tau,
                                int ntau, unsigned sa, unsigned sb, int seeded, int G, int GS,
                                long long* out) {
  const int M = spec[KC_M], NE = sc_n_lanes(spec), Q = G / GS;
  std::vector<int> sigp(nsig), taup(ntau), taba(NE), tabb(NE), list(M);
  std::vector<int> okeys(KC_MAX_S), buf(spec[KC_NW] * M);
  sc_tables(spec, sig, nsig, tau, ntau, sigp.data(), taup.data(), taba.data(), tabb.data(), 0,
            1);
  for (long long n = 0; n < N; ++n) {
    if (valid && !valid[n]) {
      out[n] = RT_ENC_MAX;
      continue;
    }
    const int* v = states + n * W;
    CtSerial gt{G};
    const ScRow row = sc_row(spec, v, list.data(), sa, sb, seeded, gt);
    uint64_t best = ~0ull;
    for (int q = 0; q < Q; ++q) {
      CtSerial gs{GS};
      const uint64_t h = sc_sigmas(spec, v, taba.data(), tabb.data(), sigp.data(), nsig,
                                   taup.data(), ntau, row, list.data(), okeys.data(), buf.data(),
                                   q, Q, sa, sb, seeded, gs);
      best = h < best ? h : best;
    }
    out[n] = rt_enc(best);
  }
}
"""


def build_slot_lib(d, driver):
    """Compile ``driver`` (which includes slot_canon.cuh) behind the host
    shim into d; returns the loaded library with host_slot_canon bound."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code for the CPU")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cpp").write_text(driver)
    so = d / "libhost_driver.so"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                          "-o", str(so), str(d / "driver.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    P, I, U, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    lib.host_slot_canon.argtypes = [P, L, I, P, P, P, I, P, I, U, U, I, I, I, P]
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def host_fingerprints(lib, tm, canon, rows, valid, G, GS):
    """host_slot_canon's enc fingerprints of rows (valid: bool [N] or None)."""
    spec = np.ascontiguousarray(tm.kernel_spec("cpu")[0].numpy())
    sig, tau = (np.ascontiguousarray(a) for a in (canon.sig_table, canon.tau_table))
    sa, sb = seed_salts(canon.seed)
    out = np.zeros(len(rows), np.int64)
    lib.host_slot_canon(_ptr(rows), len(rows), rows.shape[1], _ptr(valid), _ptr(spec),
                        _ptr(sig), len(sig), _ptr(tau), len(tau), sa, sb,
                        int(bool(canon.seed)), G, GS, _ptr(out))
    return out


@functools.lru_cache(maxsize=None)
def _rows(name):
    """(JAX model, port model, rows): reachable rows, a host- and
    value-permuted copy of each (under one other pair), edge rows and bag
    rows."""
    jm, tm, batch = reachable(name)
    canon = tm.make_canonicalizer(True)
    parts = np.arange(len(batch)) % (canon.P - 1) + 1
    perm = batch.copy()
    for k in range(1, canon.P):
        pick = parts == k
        perm[pick] = canon.canon_rows(torch.from_numpy(batch[pick]), k).numpy()
    rows = np.concatenate([batch, perm, kreconfig_edge_rows(tm, batch, seed=11),
                           kreconfig_bag_rows(tm, batch, seed=12)])
    return jm, tm, np.ascontiguousarray(rows.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _want(name, symmetry, seed):
    """(port canon, reference u64 fingerprints, plain enc fingerprints with
    the worklist mask, the worklist mask: a valid prefix with holes, then an
    invalid tail)."""
    jm, tm, rows = _rows(name)
    canon = tm.make_canonicalizer(symmetry, seed=seed)
    ref = np.asarray(jax.device_get(jm.make_canonicalizer(symmetry, seed=seed).fingerprints(rows)))
    n = len(rows)
    valid = np.arange(n) < n - n // 6
    valid[np.random.default_rng(seed).random(n) < 0.1] = False
    plain = canon.fingerprints(torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    return canon, ref, plain, valid


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_slot_lib(tmp_path_factory.mktemp("host_slot_canon"), SLOT_DRIVER)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", ["small", "full"])
def test_slot_canon_host_matches_reference(lib, name, G):
    """Every sub-tile size at this G, symmetry on and off, seeds 0 and 3:
    all rows against the reference, the worklist against the plain
    version (INT64_MAX on every invalid row)."""
    _jm, tm, rows = _rows(name)
    for symmetry in (True, False):
        for seed in (0, 3):
            canon, ref, plain, valid = _want(name, symmetry, seed)
            GS = G
            while GS >= 1:
                got = host_fingerprints(lib, tm, canon, rows, None, G, GS)
                assert np.array_equal(fps_to_u64(torch.from_numpy(got)), ref), (symmetry, seed, GS)
                work = host_fingerprints(lib, tm, canon, rows, valid, G, GS)
                assert np.array_equal(work, plain), (symmetry, seed, GS)
                assert (work[~valid] == INT64_MAX).all()
                GS //= 2


def test_bag_rows_reach_every_bag_path():
    """The rows hold empty and full bags, unused slots out of order and a
    word 0 above EMPTY, and the permuted copies differ from their rows."""
    _jm, tm, rows = _rows("full")
    lay, M = tm.layout, tm.p.msg_slots
    w0 = rows[:, lay.sl("msg_w0")]
    occ = (w0 != EMPTY).sum(1)
    assert (occ == 0).any() and (occ == M).any()
    assert (w0 > EMPTY).any()
    w1 = rows[:, lay.sl("msg_w1")]
    assert ((w0 == EMPTY) & (w1 != EMPTY)).any()
    _jm, _tm, batch = reachable("full")
    n = len(batch)
    assert (rows[n:2 * n] != batch).any(1).mean() > 0.5

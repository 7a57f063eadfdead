"""The hand-written verify kernel (cometbft_tpu_torch/csrc/ed25519_verify.cu).

On a machine without a card the CUDA kernel cannot run, but its source
also builds for the host (no ``__CUDACC__``): each block's 64 threads run
in lockstep, four per signature, and an exchange between the threads of a
quad reads their array.  So its field and point arithmetic, its exchanges
and its ragged edge are held here against the pure-Python oracle, and its
counted field multiplies against the numbers the roofline bound uses.  The
tests marked ``cuda`` run the kernel itself and skip where there is no
card.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import cuda_verify as tcv
from cometbft_tpu_torch.ops import ed25519_point as tep
from cometbft_tpu_torch.ops import fe25519 as tfe
from cometbft_tpu_torch.ops import verify as tov

from test_torch_verify import edge_set, oracle, random_mix

SRC = _build.CSRC_DIR / "ed25519_verify.cu"


def host_build(tmp_path_factory, src, *defines) -> ctypes.CDLL:
    """``src`` compiled for the host with g++ into a shared library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("hostbuild") / f"lib{src.stem}_host.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", "-shared", "-fPIC",
         *defines, "-o", str(out), str(src)],
        check=True,
        capture_output=True,
    )
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = host_build(tmp_path_factory, SRC, "-DED25519_TALLY")
    lib.ed25519_verify_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    lib.ed25519_verify_host.restype = ctypes.c_int
    lib.ed25519_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    return lib


def _host_verify(lib, pubs, msgs, sigs):
    arrays, structural = tov._pack(pubs, msgs, sigs, len(pubs))
    a = {k: np.ascontiguousarray(v, np.uint8) for k, v in arrays.items()}
    tbl = np.asarray(tcv.base_table_limbs(), np.int32)
    out = np.zeros(len(pubs), np.int32)
    lib.ed25519_verify_host(
        *(a[k].ctypes.data for k in ("a_bytes", "r_bytes", "s_bytes", "m_bytes", "s_ok")),
        tbl.ctypes.data, out.ctypes.data, len(pubs),
    )
    return (out != 0) & structural


def _tally(lib):
    mul, sq = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ed25519_tally(ctypes.byref(mul), ctypes.byref(sq))
    return mul.value, sq.value


@pytest.mark.parametrize("which", ["edge_set", "random_mix"])
def test_kernel_source_on_host_matches_oracle(host_lib, which):
    pubs, msgs, sigs = edge_set() if which == "edge_set" else random_mix(24, seed=8)
    _tally(host_lib)
    got = _host_verify(host_lib, pubs, msgs, sigs)
    np.testing.assert_array_equal(got, oracle(pubs, msgs, sigs))
    muls, squares = _tally(host_lib)
    assert muls == len(pubs) * tcv.FIELD_MULS_PER_SIG
    assert squares == len(pubs) * tcv.FIELD_SQUARES_PER_SIG


def _mixed(n):
    """The first ``n`` of edge_set + random_mix, repeated as needed."""
    p1, m1, s1 = edge_set()
    p2, m2, s2 = random_mix(16, seed=21)
    return ((p1 + p2) * 5)[:n], ((m1 + m2) * 5)[:n], ((s1 + s2) * 5)[:n]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 33])
def test_kernel_source_on_host_partial_blocks(host_lib, n):
    """Batches that fill a block's 16 quads, a warp's 8, only in part: the
    padding quads run every step on the last signature's bytes, their
    products are not counted and their results are not stored."""
    pubs, msgs, sigs = _mixed(n)
    _tally(host_lib)
    got = _host_verify(host_lib, pubs, msgs, sigs)
    np.testing.assert_array_equal(got, oracle(pubs, msgs, sigs))
    assert _tally(host_lib) == (n * tcv.FIELD_MULS_PER_SIG,
                                n * tcv.FIELD_SQUARES_PER_SIG)


def test_base_table_matches_niels_table():
    """The kernel's radix-2^25.5 base table holds the same field values as
    the plain version's 20x13-bit niels table."""
    kern = np.asarray(tcv.base_table_limbs(), np.int64).reshape(9, 3, 10)
    plain = tep._niels_base_table().astype(np.int64).reshape(3, 20, 9)
    for k in range(9):
        for c in range(3):
            v = sum(int(x) << off for x, off in zip(kern[k, c], tcv.LIMB_OFF))
            assert v == tfe.int_of_limbs(plain[c, :, k])
            assert v < ref.P


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 32, 33, 127, 129])
def test_kernel_matches_plain_and_oracle(card, n):
    pubs, msgs, sigs = _mixed(n)
    arrays, structural = tov._pack(pubs, msgs, sigs, n)
    t = tov.batch_to_device(arrays, card)
    before = tcv.launches
    kern = tcv.verify_core_cuda(**t)
    torch.cuda.synchronize()
    assert tcv.launches == before + 1
    plain = tov.verify_core(**t)
    assert torch.equal(kern, plain)
    np.testing.assert_array_equal(kern.cpu().numpy() & structural, oracle(pubs, msgs, sigs))


@pytest.mark.cuda
def test_kernel_rejects_malformed_inputs(card):
    good = torch.zeros((4, 32), dtype=torch.uint8, device=card)
    ok = torch.zeros(4, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        tcv.verify_core_cuda(good.int(), good, good, good, ok)
    with pytest.raises(ValueError):
        tcv.verify_core_cuda(good, good[:3], good, good, ok)
    with pytest.raises(ValueError):
        tcv.verify_core_cuda(good, good.cpu(), good, good, ok)

"""The measurement kernels of ``cometbft_tpu_torch.ops.profile``: the verify
kernel's stage builds (``-DED25519_STAGE``) and the field-op chains
(``csrc/fe_chain.cu``).

Their plain versions run here against Python integers and the JAX
package's field code called eagerly; both CUDA sources are also built for
the host with g++ and held against the same references.  Tests marked
``cuda`` launch the kernels and skip where there is no card.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import cuda_verify as tcv
from cometbft_tpu_torch.ops import profile as pf
from cometbft_tpu_torch.ops import verify as tov

from test_torch_cuda_verify import SRC, _mixed, host_build

K = 24
LANES = 16


@pytest.fixture(scope="module")
def chain_lib(tmp_path_factory):
    lib = host_build(tmp_path_factory, _build.CSRC_DIR / "fe_chain.cu")
    lib.fe_chain_host.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int]
    lib.fe_chain_host.restype = ctypes.c_int
    return lib


def _want(x: torch.Tensor, op: str, k: int):
    return [pf.chain_reference(pf.int_of_limbs10(row), op, k) for row in x.numpy()]


def _got(y) -> list:
    return [pf.int_of_limbs10(row) for row in np.asarray(y)]


@pytest.mark.parametrize("op", sorted(pf.CHAIN_OPS))
def test_chain_source_on_host_matches_python(chain_lib, op):
    x = pf.chain_input(LANES, seed=3)
    xs = x.numpy().copy()
    out = np.zeros_like(xs)
    rc = chain_lib.fe_chain_host(pf.CHAIN_OPS[op], K, xs.ctypes.data,
                                 out.ctypes.data, LANES)
    assert rc == 0
    assert _got(out) == _want(x, op, K)
    assert (out >= 0).all()  # canonical limbs


@pytest.mark.parametrize("op", sorted(pf.CHAIN_OPS))
def test_chain_plain_matches_python_and_jax(op):
    x = pf.chain_input(LANES, seed=4)
    got = pf.fe_chain_plain(x, op, K)
    assert _got(got) == _want(x, op, K)
    # a shorter chain on the JAX package's field code, called eagerly
    x, k = x[:8], 6
    a = jfe.F(jnp.asarray(pf._limbs10_to_13(x).numpy()), 0, jfe.MASK)
    y = jfe.red(a)
    for _ in range(k):
        if op == "mul":
            y = jfe.red(jfe.mul(y, a))
        elif op == "square":
            y = jfe.red(jfe.square(y))
        else:
            y = jfe.red(jfe.add(y, a))
    jax_limbs = torch.from_numpy(np.asarray(jfe.freeze(y)).astype(np.int32))
    torch.testing.assert_close(pf._limbs13_to_10(jax_limbs),
                               pf.fe_chain_plain(x, op, k), rtol=0, atol=0)


def test_limb_conversions_round_trip():
    x = pf.chain_input(64, seed=5)
    v13 = pf._limbs10_to_13(x)
    assert v13.shape == (20, 64)
    assert int(v13.max()) <= 8191 and int(v13.min()) >= 0
    torch.testing.assert_close(pf._limbs13_to_10(v13), x, rtol=0, atol=0)


def test_chain_rejects_bad_input():
    with pytest.raises(ValueError):
        pf.fe_chain(torch.zeros((4, 9), dtype=torch.int32), "mul", 2)
    with pytest.raises(ValueError):
        pf.fe_chain(torch.zeros((4, 10), dtype=torch.int64), "mul", 2)
    with pytest.raises(ValueError):
        pf.fe_chain(torch.zeros((4, 10), dtype=torch.int32), "cube", 2)
    # the wrapper measures the card: a CPU tensor is refused, not computed
    with pytest.raises(ValueError, match="CUDA"):
        pf.fe_chain(pf.chain_input(4, seed=7), "mul", 2)


def _host_stage(lib, pubs, msgs, sigs):
    arrays, _ = tov._pack(pubs, msgs, sigs, len(pubs))
    a = {k: np.ascontiguousarray(v, np.uint8) for k, v in arrays.items()}
    tbl = np.asarray(tcv.base_table_limbs(), np.int32)
    out = np.zeros(len(pubs), np.int32)
    lib.ed25519_verify_host(
        *(a[k].ctypes.data for k in ("a_bytes", "r_bytes", "s_bytes", "m_bytes", "s_ok")),
        tbl.ctypes.data, out.ctypes.data, len(pubs),
    )
    return out, tov.batch_to_device(arrays, "cpu")


@pytest.mark.parametrize("stage", sorted(pf.STAGES))
def test_stage_source_on_host_matches_plain_decompress(tmp_path_factory, stage):
    """A stage build returns ok_A | ok_R << 1 (bit 2 only keeps the stage's
    work alive), the plain version ``_decompress_pair``'s bits."""
    lib = host_build(tmp_path_factory, SRC, f"-DED25519_STAGE={stage}",
                     "-DED25519_TALLY")
    lib.ed25519_verify_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    lib.ed25519_tally.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    pubs, msgs, sigs = _mixed(19)
    out, t = _host_stage(lib, pubs, msgs, sigs)
    muls, squares = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ed25519_tally(ctypes.byref(muls), ctypes.byref(squares))
    assert (muls.value, squares.value) == tuple(19 * w for w in pf.STAGE_WORK[stage])
    want = pf.decompress_oks(t["a_bytes"], t["r_bytes"])
    np.testing.assert_array_equal(out & 3, want.numpy())
    assert (want.numpy() == 3).any() and (want.numpy() != 3).any()


def test_stage_rejects_unknown_stage():
    pubs, msgs, sigs = _mixed(2)
    arrays, _ = tov._pack(pubs, msgs, sigs, 2)
    t = tov.batch_to_device(arrays, "cpu")
    with pytest.raises(ValueError, match="stage must be"):
        pf.verify_stage(4, **t)
    with pytest.raises(ValueError, match="CUDA"):
        pf.verify_stage(1, **t)


def test_build_names_and_flags():
    names = _build.sources()
    assert {"ed25519_verify", "fe_chain"} <= set(names)
    assert {f"ed25519_verify_stage{k}" for k in pf.STAGES} <= set(names)
    for k in pf.STAGES:
        stem, flags = _build.VARIANTS[f"ed25519_verify_stage{k}"]
        assert stem == "ed25519_verify" and flags == (f"-DED25519_STAGE={k}",)
    # each build's flags are in its library's name hash
    paths = {_build.lib_path(n) for n in names}
    assert len(paths) == len(names)
    assert set(pf.launches) == {pf.CHAIN} | {f"ed25519_verify_stage{k}" for k in pf.STAGES}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(pf.CHAIN_OPS))
def test_chain_kernel_matches_plain_and_python(card, op):
    x = pf.chain_input(300, seed=6)
    before = pf.launches[pf.CHAIN]
    got = pf.fe_chain(x.to(card), op, K)
    assert pf.launches[pf.CHAIN] == before + 1
    torch.testing.assert_close(got.cpu(), pf.fe_chain_plain(x, op, K), rtol=0, atol=0)
    assert _got(got.cpu())[:32] == _want(x[:32], op, K)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(pf.STAGES))
@pytest.mark.parametrize("n", [1, 5, 33])
def test_stage_kernel_matches_plain_decompress(card, stage, n):
    pubs, msgs, sigs = _mixed(n)
    arrays, _ = tov._pack(pubs, msgs, sigs, n)
    t = tov.batch_to_device(arrays, card)
    got = pf.verify_stage(stage, **t)
    want = pf.decompress_oks(t["a_bytes"], t["r_bytes"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)

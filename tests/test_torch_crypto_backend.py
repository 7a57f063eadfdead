"""``COMETBFT_TPU_CRYPTO_BACKEND`` in the port, against the JAX package.

The variable is the operator's request and is read first, as the JAX
``default_backend`` and ``create_batch_verifier`` read it: ``cpu`` gives
the CPU verifier for every key type (``CpuBatchVerifier`` for Ed25519,
the secp256k1 verifier on the CPU) and closes the trust gate, so nothing
fused or scheduled runs and no tree is hashed on the card; ``gpu`` and
``tpu`` ask for the card; ``auto`` or unset keep the default (the card, or
a raise without one); any other value raises ``ValueError``.  Run with no
card (``torch.cuda.is_available`` patched False where it matters).
"""

import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey as JSecp
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as TPriv
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey as TSecp
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.verifysched import service as tservice

VAR = "COMETBFT_TPU_CRYPTO_BACKEND"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    monkeypatch.setattr(jbatch, "_DEFAULT_BACKEND", None)


def _keys():
    seed = b"\x09" * 32
    return ((JPriv.from_seed(seed).pub_key(), TPriv.from_seed(seed).pub_key()),
            (JSecp.from_secret(b"backend").pub_key(),
             TSecp.from_secret(b"backend").pub_key()))


def test_cpu_gives_the_cpu_verifier_for_every_key_type(no_card, monkeypatch):
    monkeypatch.setenv(VAR, "cpu")
    (jed, ted), (jsecp, tsecp) = _keys()
    assert tbatch.default_backend() == jbatch.default_backend() == "cpu"
    jv, tv = jbatch.create_batch_verifier(jed), tbatch.create_batch_verifier(ted)
    assert type(jv).__name__ == type(tv).__name__ == "CpuBatchVerifier"
    jv, tv = jbatch.create_batch_verifier(jsecp), tbatch.create_batch_verifier(tsecp)
    assert type(jv).__name__ == type(tv).__name__ == "Secp256k1BatchVerifier"
    assert jv._backend == "cpu" and tv.device == "cpu"
    # the CPU verifier verifies, with no card
    priv = TPriv.from_seed(b"\x09" * 32)
    tv = tbatch.create_batch_verifier(ted)
    tv.add(ted, b"m", priv.sign(b"m"))
    tv.add(ted, b"n", priv.sign(b"m"))
    assert tv.verify() == (False, [True, False])


def test_cpu_closes_the_gates(no_card, monkeypatch):
    monkeypatch.setenv(VAR, "cpu")
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda:0"})  # a trusted card
    assert not tservice.backend_trusted() and not tservice.scheduler_active()
    assert not tval.fused_verify_eligible([])
    monkeypatch.delenv(VAR)
    assert tservice.backend_trusted()


def test_explicit_arguments_win_over_the_variable(no_card, monkeypatch):
    monkeypatch.setenv(VAR, "cpu")
    (_, ted), (_, tsecp) = _keys()
    v = tbatch.create_batch_verifier(ted, device="cpu")
    assert isinstance(v, tbatch.GpuBatchVerifier) and v.device == "cpu"
    assert tbatch.create_batch_verifier(tsecp, device="cpu").device == "cpu"


@pytest.mark.parametrize("value", ["gpu", "tpu", "auto", None])
def test_card_requests_raise_without_a_card(no_card, monkeypatch, value):
    if value is None:
        monkeypatch.delenv(VAR, raising=False)
    else:
        monkeypatch.setenv(VAR, value)
    (_, ted), _ = _keys()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.default_backend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.create_batch_verifier(ted)
    assert not tservice.backend_trusted()  # no self-check has passed


@pytest.mark.parametrize("value", ["GPU", "cuda", "xla", "0"])
def test_unknown_value_raises(no_card, monkeypatch, value):
    monkeypatch.setenv(VAR, value)
    (_, ted), (_, tsecp) = _keys()
    with pytest.raises(ValueError, match="COMETBFT_TPU_CRYPTO_BACKEND"):
        tbatch.default_backend()
    with pytest.raises(ValueError):
        tbatch.create_batch_verifier(ted)
    with pytest.raises(ValueError):
        tbatch.create_batch_verifier(tsecp)
    with pytest.raises(ValueError):
        tservice.backend_trusted()

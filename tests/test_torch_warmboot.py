"""The port's build cache and warm-boot pass (``ops/_build``,
``ops/warm_stats``, ``ops/warmboot``), at the family seam as the JAX
package's tests drive theirs: ``warmboot._warm_family`` replaced by a
recorder, so no kernel is built here.

* an OPEN breaker skips its family; a failed family records a breaker
  failure and a demotion, logs a WARNING, and the pass goes on; the
  counters; ``run()`` never raises; ``start()`` runs once per process;
* ``enabled()``: off in a CPU process, on when the operator asks for the
  card or the trust gate is open, an explicit ``COMETBFT_TPU_WARMBOOT``
  first; an empty bucket variable skips its family;
* the hooks themselves on ``device="cpu"`` (the kernels' plain versions,
  the host libraries built here by ``g++``): the three signature hooks
  fill the batch seam's latches and a second call runs no check; the
  tree, AEAD and ladder hooks pass their known answers;
* ``_build``'s per-library status: ``hit`` and ``error:<Type>``;
* the verify scheduler's dispatcher kicks ``ensure_started``.
"""

import logging
import threading

import numpy as np
import pytest

from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.ops import _build, warm_stats, warmboot
from cometbft_tpu_torch.verifysched import service as tservice

FAMILIES = [f for f, _, _ in warmboot.FAMILIES]
LIBS = {"ed25519": ["host_prep", "ed25519_verify"], "secp256k1": ["secp256k1_verify"],
        "bls": ["bls12381", "bls_g1"], "tree": ["sha256_tree"],
        "aead": ["chacha20_poly1305"], "x25519": ["x25519_ladder"]}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for env in ("COMETBFT_TPU_WARMBOOT", "COMETBFT_TPU_CRYPTO_BACKEND",
                *(e for _, _, e in warmboot.FAMILIES if e)):
        monkeypatch.delenv(env, raising=False)
    tbh.reset()
    warm_stats.reset()
    warmboot.reset()
    yield
    tbh.reset()
    warm_stats.reset()
    warmboot.reset()


@pytest.fixture
def seam(monkeypatch):
    """``_warm_family`` recorded: every family answers {its libraries:
    "hit"}, except those named in ``fail``, which raise."""
    calls, fail = [], {}

    def warm(family):
        calls.append(family)
        if family in fail:
            raise fail[family]
        return dict.fromkeys(LIBS[family], "hit")

    monkeypatch.setattr(warmboot, "_warm_family", warm)
    return calls, fail


def test_every_family_warmed_in_order(seam):
    calls, _ = seam
    report = warmboot.run()
    assert calls == FAMILIES
    assert report["statuses"] == {lib: "hit" for f in FAMILIES for lib in LIBS[f]}
    assert (report["warmed"], report["failures"], report["pruned"]) == (8, 0, 0)
    assert set(report["family_seconds"]) == set(FAMILIES)
    snap = warm_stats.snapshot()
    assert (snap["warm_runs"], snap["shapes_warmed"], snap["warm_failures"]) == (1, 8, 0)
    assert snap["warm_seconds"] == pytest.approx(report["seconds"])


def test_an_open_breaker_skips_its_family(seam):
    calls, _ = seam
    tbh.registry().breaker("secp_device").trip("dead card")
    report = warmboot.run()
    assert "secp256k1" not in calls and len(calls) == 5
    assert report["statuses"]["secp256k1"] == "skipped:breaker-open"
    assert report["failures"] == 0 and tbh.snapshot()["demotions"] == 0


def test_a_failed_family_demotes_and_the_pass_goes_on(seam, caplog):
    calls, fail = seam
    fail["aead"] = RuntimeError("chacha20_poly1305 launch failed: CUDA error 719")
    with caplog.at_level(logging.WARNING, logger="cometbft_tpu_torch.crypto"):
        report = warmboot.run()
    assert calls == FAMILIES  # x25519 still warmed after the failure
    assert report["statuses"]["aead"] == "error:RuntimeError"
    assert report["statuses"]["x25519_ladder"] == "hit"
    assert (report["warmed"], report["failures"]) == (7, 1)
    snap = tbh.snapshot()
    assert snap["demotions"] == 1
    assert snap["breakers"]["aead_device"]["failures_total"] == 1
    assert snap["breakers"]["aead_device"]["state"] == tbh.CLOSED
    assert warm_stats.snapshot()["warm_failures"] == 1
    assert any("aead" in r.getMessage() and r.levelno == logging.WARNING
               for r in caplog.records)


def test_run_never_raises(seam):
    _, fail = seam
    for family in FAMILIES:
        fail[family] = ValueError(family)
    report = warmboot.run()
    assert report["failures"] == 6 and report["warmed"] == 0
    assert tbh.snapshot()["demotions"] == 6


def test_start_runs_once_per_process(seam, monkeypatch):
    calls, _ = seam
    monkeypatch.setattr(warmboot, "enabled", lambda: True)
    gate = threading.Event()
    real = warmboot.run
    monkeypatch.setattr(warmboot, "run", lambda: gate.wait(10) and real())
    t = warmboot.start()
    assert warmboot.start() is t  # running: not started again
    gate.set()
    t.join(10)
    warmboot.ensure_started()  # completed: not run again
    assert warmboot.start() is t and not t.is_alive()
    assert calls == FAMILIES and warm_stats.snapshot()["warm_runs"] == 1


def test_enabled(monkeypatch):
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    assert not warmboot.enabled()  # a CPU process: no card, no request
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")
    assert not warmboot.enabled()
    for value in ("gpu", "tpu"):
        monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", value)
        assert warmboot.enabled()
    monkeypatch.setenv("COMETBFT_TPU_WARMBOOT", "0")
    assert not warmboot.enabled()  # explicit wins
    monkeypatch.delenv("COMETBFT_TPU_CRYPTO_BACKEND")
    monkeypatch.setenv("COMETBFT_TPU_WARMBOOT", "1")
    assert warmboot.enabled()
    monkeypatch.delenv("COMETBFT_TPU_WARMBOOT")
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", {"cuda"})  # the gate open
    assert warmboot.enabled()


def test_disabled_start_is_a_no_op(seam, monkeypatch):
    monkeypatch.setattr(tbatch, "_SELF_CHECKED", set())
    assert not warmboot.enabled() and warmboot.start() is None
    warmboot.ensure_started()
    assert seam[0] == []


@pytest.mark.parametrize("env,skipped", [
    ("COMETBFT_TPU_WARMBOOT_SECP_BUCKETS", ["secp256k1"]),
    ("COMETBFT_TPU_WARMBOOT_BLS_BUCKETS", ["bls"]),
    ("COMETBFT_TPU_WARMBOOT_MERKLE_BUCKETS", ["tree"]),
    ("COMETBFT_TPU_WARMBOOT_TRANSPORT_BUCKETS", ["aead", "x25519"]),
])
def test_an_empty_bucket_variable_skips_its_family(seam, monkeypatch, env, skipped):
    monkeypatch.setenv(env, " , ")
    assert [f for f, _ in warmboot.matrix()] == [f for f in FAMILIES if f not in skipped]
    warmboot.run()
    assert seam[0] == [f for f in FAMILIES if f not in skipped]
    monkeypatch.setenv(env, "1,2")  # a value keeps it
    assert [f for f, _ in warmboot.matrix()] == FAMILIES


def test_the_hooks_fill_the_latches_on_the_cpu(monkeypatch):
    """The real hooks on ``device="cpu"``: the signature families' checks
    run the plain versions and latch the device; a second call runs no
    check; the planes' known answers pass.  No CUDA library is loaded."""
    from cometbft_tpu_torch.ops import bls_g1, chacha_aead, secp_verify
    from cometbft_tpu_torch.ops import sha256_tree, verify, x25519_ladder

    for latch in ("_SELF_CHECKED", "_SECP_SELF_CHECKED", "_BLS_SELF_CHECKED"):
        monkeypatch.setattr(tbatch, latch, set())
    hooks = [(verify.warm_kernels, "_SELF_CHECKED", "gpu_self_check", ["host_prep"]),
             (secp_verify.warm_ladder, "_SECP_SELF_CHECKED", "secp_self_check", []),
             (bls_g1.warm_kernels, "_BLS_SELF_CHECKED", "bls_self_check", ["bls12381"])]
    for hook, latch, check, libs in hooks:
        assert list(hook("cpu")) == libs
        assert getattr(tbatch, latch) == {"cpu"}

    def never(dev):
        raise AssertionError("a latched device was checked again")

    for hook, latch, check, libs in hooks:
        monkeypatch.setattr(tbatch, check, never)
        hook("cpu")
    for hook in (sha256_tree.warm_kernels, chacha_aead.warm_kernels,
                 x25519_ladder.warm_ladder):
        assert hook("cpu") == {}
    assert all(s in ("hit", "built")
               for s in _build.statuses([native.NAME, native.BLS_NAME]).values())


def test_a_wrong_known_answer_raises(monkeypatch):
    from cometbft_tpu_torch.ops import chacha_aead

    real = chacha_aead.device_pass
    monkeypatch.setattr(chacha_aead, "device_pass", lambda op, frames, dev: [
        (ct[:-1] + bytes([ct[-1] ^ 1]), tag) for ct, tag in real(op, frames, dev)])
    with pytest.raises(tbatch.SelfCheckError):
        chacha_aead.warm_kernels("cpu")


def test_build_status_hit_and_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_INFO", {})
    _build.build_all([native.NAME])  # built here by g++ already
    assert _build.info(native.NAME) == {"build": "hit"}
    assert warm_stats.snapshot()["libs_hit"] == 1

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError):
        _build.build_all(["fe_chain"])
    assert _build.info("fe_chain") == {"build": "error:RuntimeError"}
    assert warm_stats.snapshot()["build_failures"] == 1
    assert _build.statuses([native.NAME, "fe_chain", "x"]) == {
        native.NAME: "hit", "fe_chain": "error:RuntimeError", "x": None}


def test_the_scheduler_kicks_warm_boot(monkeypatch):
    from cometbft_tpu_torch.ops import supervisor

    kicked = threading.Event()
    monkeypatch.setattr(warmboot, "ensure_started", kicked.set)
    supervisor.set_device_runner(
        lambda tier, pubs, msgs, sigs, lanes: np.ones(lanes, dtype=bool))
    sched = tservice.VerifyScheduler(device="cpu")
    try:
        sched.submit(b"\1" * 32, b"m", b"\2" * 64)
        assert kicked.wait(10)
    finally:
        sched.close()
        supervisor.clear_device_runner()

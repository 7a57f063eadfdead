"""The port's transport plane (``ops/chacha_aead``, ``ops/x25519_ladder``,
``p2p/``) against the JAX package's and the RFC vectors.

* The plain versions: ``aead_core`` equals the JAX ``_seal_fn`` /
  ``_open_fn`` and ``ladder_core`` the JAX ``_ladder_fn`` (on a bit tensor
  cut to 8 rows), bit for bit, all called eagerly under
  ``jax.disable_jit()`` (jitted on the CPU, XLA takes minutes); the full
  255-row ladder equals ``aead_ref.x25519`` and the RFC 7748 vectors, the
  AEAD the RFC 8439 inputs with empty AAD at the block edges.  The packing
  and the bucket rules equal the JAX package's.
* The plane's semantics: the prefix on the first bad tag, the kill
  switches, routing under the minimum batch, the runner seam on a faulty
  runner (on a card path ``BackendError``, on the CPU the host tiers,
  counted), a reject the reference accepts raising.
* The handshake pool: concurrent dials in one flush, shedding to the sync
  path (the host on the CPU, one supervised pass on a card path), a
  flush the kernel did not serve raising on a card path.
* ``SecretConnection`` pairs: round trips, ``write_msg``/``read_msg``, the
  tampered frame's prefix and sticky error, and wire bytes equal to the
  JAX package's (``transportplane.seal_frames``, and a JAX stream carried
  into the port by ``convert.half_duplex_from``).
"""

import hashlib
import os
import socket
import struct
import threading

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import aead_ref as jaead
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
from cometbft_tpu.ops import chacha_aead as jca
from cometbft_tpu.ops import x25519_ladder as jxl
from cometbft_tpu.p2p import handshake_pool as jpool
from cometbft_tpu.p2p import secret_connection as jsc
from cometbft_tpu.p2p import transportplane as jplane
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import aead_ref
from cometbft_tpu_torch.crypto import backend_health as tbh
from cometbft_tpu_torch.crypto.backend_health import BackendError
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import chacha_aead as ca
from cometbft_tpu_torch.ops import dispatch_stats as tds
from cometbft_tpu_torch.ops import x25519_ladder as xl
from cometbft_tpu_torch.p2p import handshake_pool, transportplane
from cometbft_tpu_torch.p2p import transport_stats as tstats
from cometbft_tpu_torch.p2p.secret_connection import (
    SecretConnection,
    SecretConnectionError,
)

from test_torch_cuda_transport import (
    ALICE_PRIV,
    ALICE_PUB,
    BOB_PRIV,
    BOB_PUB,
    EDGE_LENS,
    P,
    RFC7748,
    RFC8439_AAD,
    RFC8439_KEY,
    RFC8439_NONCE,
    RFC8439_PT,
    SHARED,
    vector_pairs,
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # both packages' gates closed whatever other tests of the process left
    monkeypatch.setenv("COMETBFT_TPU_CRYPTO_BACKEND", "cpu")

    def scrub():
        handshake_pool.reset_pool()
        ca.clear_aead_runner()
        xl.clear_ladder_runner()
        tstats.reset()
        tbh.reset()
        tds.reset()

    scrub()
    yield
    scrub()


def _key(tag: str) -> bytes:
    return hashlib.sha256(tag.encode()).digest()


def _frames(tag: str, lens):
    return [(_key(f"{tag}-key-{i}"), transportplane.nonce_bytes(i),
             os.urandom(n)) for i, n in enumerate(lens)]


def host_aead_runner(op, frames):
    """The host tier as a runner."""
    return ca._host_pass(op, frames)


# -- the plain versions against the JAX package ------------------------------


@pytest.fixture(scope="module")
def jax_aead_case():
    """8 lanes x 2 blocks of mixed lengths, packed by the JAX package, and
    its seal and open run eagerly (~6 s each on the CPU)."""
    rng = np.random.default_rng(12)
    lens = (0, 1, 15, 16, 17, 64, 100, 128)
    frames = [(rng.bytes(32), rng.bytes(12), rng.bytes(n)) for n in lens]
    assert jca._bucket_shape(frames) == ca._bucket_shape(frames) == (8, 2)
    packed = jca._pack_frames(frames, 8, 2)
    with jax.disable_jit():
        seal = [np.asarray(x) for x in jca._seal_fn(*packed)]
        sealed_words = packed[:2] + (seal[0], packed[3])
        opened = [np.asarray(x) for x in jca._open_fn(*sealed_words)]
    return frames, packed, seal, sealed_words, opened


def test_pack_frames_equals_jax(jax_aead_case):
    frames, packed, *_ = jax_aead_case
    ours = ca._pack_frames(frames, 8, 2)
    for theirs, mine in zip(packed, ours):
        assert np.array_equal(np.ascontiguousarray(theirs).view(np.int32), mine)


def test_aead_core_equals_jax_seal_and_open(jax_aead_case):
    frames, packed, seal, sealed_words, opened = jax_aead_case
    t = lambda a: torch.from_numpy(np.array(a).view(np.int32))  # noqa: E731
    out, tag = ca.aead_core(*map(t, packed), seal=True)
    assert np.array_equal(out.numpy(), seal[0].view(np.int32))
    assert np.array_equal(tag.numpy(), seal[1].view(np.int32))
    out, tag = ca.aead_core(*map(t, sealed_words), seal=False)
    assert np.array_equal(out.numpy(), opened[0].view(np.int32))
    assert np.array_equal(tag.numpy(), opened[1].view(np.int32))
    # and the words are the reference's bytes
    got = ca._unpack_outputs(seal[0].view(np.int32), seal[1].view(np.int32), frames)
    assert got == ca._host_pass("seal", frames)


def test_ladder_core_equals_jax_ladder_on_a_truncated_bit_tensor():
    """The JAX ladder scans over however many rows ``bits`` has: 8 rows of
    the clamped scalars' bits at 8 lanes (~25 s eagerly, the inversion's
    254 squares included)."""
    rng = np.random.default_rng(13)
    pairs = [(rng.bytes(32), rng.bytes(32)) for _ in range(6)] + vector_pairs()[4:6]
    bits, us = jxl._pack_pairs(pairs, 8)
    scalars, our_us = xl._pack_pairs(pairs, 8)
    assert np.array_equal(xl.bits_of_scalars(torch.from_numpy(scalars)).numpy(), bits)
    assert np.array_equal(our_us, us)
    with jax.disable_jit():
        want = np.asarray(jxl._ladder_fn(bits[:8], us))
    got = xl.ladder_core(torch.from_numpy(bits[:8]), torch.from_numpy(our_us))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_full_ladder_equals_reference_and_rfc7748():
    pairs = vector_pairs()
    scalars, us = xl._pack_pairs(pairs, len(pairs))
    got = xl.ladder_plain(torch.from_numpy(scalars), torch.from_numpy(us)).numpy()
    want = xl.host_exchange(pairs)
    assert [got[i].tobytes() for i in range(len(pairs))] == want
    assert want[:2] == [bytes.fromhex(w) for _, _, w in RFC7748]
    assert want[2:4] == [ALICE_PUB, SHARED]
    assert want[6:8] == [bytes(32), bytes(32)]  # low order: zero


def test_bytes_of_limbs_and_bucket_lanes():
    vals = [0, 1, P - 1, 2**255 - 20, 0x1234567890ABCDEF << 190]
    limbs = torch.from_numpy(np.array(
        [[(v >> (13 * j)) & 0x1FFF for v in vals] for j in range(20)], np.int32))
    got = xl.bytes_of_limbs(limbs).numpy()
    assert [got[i].tobytes() for i in range(len(vals))] == \
        [v.to_bytes(32, "little") for v in vals] == jxl._limbs_to_bytes(limbs.numpy(), len(vals))
    for n in (0, 1, 7, 8, 9, 33, 256, 257):
        assert xl.bucket_lanes(n) == jxl.bucket_lanes(n)


def test_bucket_shape_equals_jax():
    for lens in ([0], [1] * 9, [2048] * 4, [2049], [64] * 1024, [64] * 1025,
                 [1024] * 256, [1024] * 257, [1000, 10, 0]):
        frames = [(bytes(32), bytes(12), bytes(n)) for n in lens]
        assert ca._bucket_shape(frames) == jca._bucket_shape(frames), lens


# -- the AEAD on the RFC inputs and at the block edges --------------------------


def test_rfc8439_vector_and_empty_aad():
    ref = aead_ref.ChaCha20Poly1305Ref(RFC8439_KEY)
    with_aad = ref.encrypt(RFC8439_NONCE, RFC8439_PT, RFC8439_AAD)
    assert with_aad[:16].hex() == "d31a8d34648e60db7b86afbc53ef7ec2"
    assert with_aad[-16:].hex() == "1ae10b594f09e26a7e902ecbd0600691"
    want = ref.encrypt(RFC8439_NONCE, RFC8439_PT, b"")
    assert want[:-16] == with_aad[:-16]
    frame = (RFC8439_KEY, RFC8439_NONCE, RFC8439_PT)
    assert ca.seal_frames([frame], device="cpu") == [want]
    assert ca.open_frames([(RFC8439_KEY, RFC8439_NONCE, want)], device="cpu") == [RFC8439_PT]
    assert jca.seal_frames([frame]) == [want]


def test_block_edges_plain_and_host_tiers_equal_the_reference():
    frames = _frames("edge", EDGE_LENS)
    want = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, p, b"") for k, n, p in frames]
    assert ca.seal_frames(frames, device="cpu") == want
    assert [c + t for c, t in ca._host_pass("seal", frames)] == want
    sealed = [(k, n, s) for (k, n, _), s in zip(frames, want)]
    assert ca.open_frames(sealed, device="cpu") == [p for _, _, p in frames]
    assert tds.tier_counts(ca.AEAD)["torch"] == (2, 2 * len(frames))


def test_tampered_tags_and_ciphertexts_reject_on_the_plain_version():
    frames = _frames("tamper", (100, 17, 64, 0, 1024))
    sealed = ca.seal_frames(frames, device="cpu")
    work = [(k, n, s) for (k, n, _), s in zip(frames, sealed)]
    work[1] = (work[1][0], work[1][1], work[1][2][:-1] + bytes([work[1][2][-1] ^ 1]))
    work[2] = (work[2][0], work[2][1], bytes([work[2][2][0] ^ 0x80]) + work[2][2][1:])
    work[4] = (_key("other"), work[4][1], work[4][2])
    opened = ca.open_frames(work + [(work[0][0], work[0][1], b"short")], device="cpu")
    assert opened == [frames[0][2], None, None, frames[3][2], None, None]
    snap = tstats.snapshot()
    assert snap["bad_tags"] == 4 and snap["reject_confirms"] == 3


# -- routing, switches and the runner seam ------------------------------------------


def test_gate_closed_goes_to_host_and_switches_pin_it(monkeypatch):
    frames = _frames("gate", (10, 20))
    want = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, p, b"") for k, n, p in frames]
    assert not ca.device_active()
    assert ca.seal_frames(frames) == want  # no device named, the gate closed
    assert tds.tier_counts(ca.AEAD)["host"] == (1, 2)
    monkeypatch.setenv("COMETBFT_TPU_AEAD_DEVICE", "0")
    assert not ca.device_active("cpu")
    assert ca.seal_frames(frames, device="cpu") == want
    assert tds.tier_counts(ca.AEAD) == {"cuda": (0, 0), "torch": (0, 0), "host": (2, 4)}
    monkeypatch.setenv("COMETBFT_TPU_X25519_DEVICE", "0")
    assert xl.exchange_batch([(ALICE_PRIV, BOB_PUB)], device="cpu") == [SHARED]
    assert tds.tier_counts(xl.X25519)["host"] == (1, 1)


def test_oversize_batches_go_to_the_host_counted(monkeypatch):
    frames = _frames("big", (2049, 10))
    want = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, p, b"") for k, n, p in frames]
    assert ca.seal_frames(frames, device="cpu") == want
    assert tds.tier_counts(ca.AEAD_OVERSIZE)["host"] == (1, 2)
    monkeypatch.setenv("COMETBFT_TPU_X25519_MAX_LANES", "1")
    pairs = [(ALICE_PRIV, BOB_PUB), (BOB_PRIV, ALICE_PUB)]
    assert xl.exchange_batch(pairs, device="cpu") == [SHARED, SHARED]
    assert tds.tier_counts(xl.X25519_OVERSIZE)["host"] == (1, 2)


def test_min_batch_and_kill_switch_routing(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_AEAD_MIN_BATCH", "8")
    assert not transportplane.batch_active(7) and transportplane.batch_active(8)
    hd = convert.half_duplex_from(type("HD", (), {"_key": _key("mb"), "nonce": 5})(),
                                  device="cpu")
    datas = [b"x" * 40] * 7
    serial = hd.seal_batch(datas)
    assert tstats.snapshot()["frames"] == {"batched": 0, "serial": 7}
    assert tds.tier_counts(ca.AEAD)["torch"] == (0, 0)
    hd.nonce = 5
    monkeypatch.setenv("COMETBFT_TPU_AEAD_MIN_BATCH", "4")
    assert hd.seal_batch(datas) == serial  # batched, the same bytes
    assert tds.tier_counts(ca.AEAD)["torch"] == (1, 7)
    monkeypatch.setenv("COMETBFT_TPU_AEAD", "0")
    assert not transportplane.batch_active(100)


@pytest.mark.parametrize("mode", ["raise", "wrong_shape"])
def test_faulty_runner_raises_on_a_card_path_and_steps_down_on_the_cpu(mode, caplog):
    frames = _frames("fault", (200, 0, 64, 1024))
    want = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, p, b"") for k, n, p in frames]

    def faulty(op, fs):
        if mode == "wrong_shape":
            return host_aead_runner(op, fs)[:-1]
        raise RuntimeError("injected fault")

    ca.set_aead_runner(faulty)
    with pytest.raises(BackendError):
        ca.seal_frames(frames)  # device None: the card's rule
    assert "did not serve a call" in caplog.text
    assert ca.seal_frames(frames, device="cpu") == want
    assert tds.tier_counts(ca.AEAD) == {"cuda": (0, 0), "torch": (0, 0), "host": (1, 4)}
    snap = tstats.snapshot()
    assert snap["device_fallbacks"] == 1 and snap["dispatches"]["host"] == 1
    assert tbh.registry().breaker(ca.BREAKER).stats()["failures_total"] == 2


def test_the_host_tier_counts_each_pass_once():
    frames = _frames("host", (100, 7))
    want = [aead_ref.ChaCha20Poly1305Ref(k).encrypt(n, p, b"") for k, n, p in frames]
    assert ca.seal_frames(frames) == want  # the gate is closed: the host tier
    sealed = [(k, n, s) for (k, n, _), s in zip(frames, want)]
    assert ca.open_frames(sealed) == [p for _, _, p in frames]
    assert tstats.snapshot()["dispatches"] == {"device": 0, "host": 2}
    assert tds.tier_counts(ca.AEAD)["host"] == (2, 4)


def test_a_reject_that_the_reference_accepts_raises():
    frames = _frames("confirm", (64, 64))
    sealed = ca.seal_frames(frames, device="cpu")

    def tag_corruptor(op, fs):
        return [(pt, bytes(16)) for pt, _ in host_aead_runner(op, fs)]

    ca.set_aead_runner(tag_corruptor)
    for device in (None, "cpu"):
        with pytest.raises(BackendError):
            ca.open_frames([(k, n, s) for (k, n, _), s in zip(frames, sealed)], device)
    assert tstats.snapshot()["reject_confirms"] == 2
    assert tbh.registry().breaker(ca.BREAKER).stats()["failures_total"] == 2
    ca.set_aead_runner(host_aead_runner)  # a true reject is still a reject
    bad = sealed[0][:-1] + bytes([sealed[0][-1] ^ 4])
    assert ca.open_frames([(frames[0][0], frames[0][1], bad)]) == [None]


def test_ladder_runner_faults_and_malformed_results():
    pairs = [(ALICE_PRIV, BOB_PUB)] * 3
    xl.set_ladder_runner(lambda ps: xl.host_exchange(ps)[:-1])
    with pytest.raises(BackendError):
        xl.exchange_batch(pairs)
    assert xl.exchange_batch(pairs, device="cpu") == [SHARED] * 3
    assert tds.tier_counts(xl.X25519)["host"] == (1, 3)
    with pytest.raises(ValueError):
        xl.exchange_batch([(ALICE_PRIV, BOB_PUB[:31])], device="cpu")


def test_exchange_batch_on_the_plain_version():
    pairs = vector_pairs()[:3]
    assert xl.exchange_batch(pairs, device="cpu") == xl.host_exchange(pairs)
    assert tds.tier_counts(xl.X25519)["torch"] == (1, 3)
    assert tstats.snapshot()["hs_lanes"] == 8


# -- the transport plane -------------------------------------------------------------


def test_plane_prefix_stops_at_the_first_bad_tag_and_matches_jax():
    key = _key("plane")
    payloads = [os.urandom(80 + i) for i in range(8)]
    sealed = transportplane.seal_frames(key, 100, payloads, device="cpu")
    assert sealed == jplane.seal_frames(key, 100, payloads)  # JAX host tier
    tampered = list(sealed)
    tampered[3] = tampered[3][:-1] + bytes([tampered[3][-1] ^ 1])
    assert transportplane.open_frames(key, 100, tampered, device="cpu") == (payloads[:3], 3)
    assert transportplane.open_frames(key, 100, sealed, device="cpu") == (payloads, None)
    assert transportplane.nonce_bytes(7) == jplane.nonce_bytes(7)


# -- the handshake pool ----------------------------------------------------------------


def test_concurrent_dials_coalesce_into_one_flush():
    calls = []

    def counting(pairs):
        calls.append(len(pairs))
        return xl.host_exchange(pairs)

    xl.set_ladder_runner(counting)
    pool = handshake_pool.HandshakePool(flush_us=50000.0, queue_cap=64, max_batch=64)
    pairs = [(_key(f"pool-{i}"), aead_ref.x25519(_key(f"peer-{i}"), xl.BASE_U))
             for i in range(12)]
    try:
        pool.pause()
        futs = [pool.submit(s, u) for s, u in pairs]
        pool.resume()
        got = [f.result(timeout=30) for f in futs]
    finally:
        pool.close()
    assert got == xl.host_exchange(pairs) and calls == [12]
    snap = tstats.snapshot()
    assert sum(snap["hs_flushes"].values()) == 1 and snap["hs_flush_items"] == 12
    assert snap["hs_queue_depth"] == 0
    assert tds.tier_counts(xl.X25519)["cuda"] == (1, 12)  # device None: the card's tier


def test_rfc7748_dh_through_the_pool_and_exchange_many():
    xl.set_ladder_runner(xl.host_exchange)
    assert handshake_pool.active()
    assert handshake_pool.public_key(ALICE_PRIV) == ALICE_PUB
    assert handshake_pool.exchange(BOB_PRIV, ALICE_PUB) == SHARED
    assert handshake_pool.exchange_many([(ALICE_PRIV, BOB_PUB), (BOB_PRIV, xl.BASE_U)]) \
        == [SHARED, BOB_PUB]
    assert tstats.snapshot()["handshakes"] == {"pool": 4, "sync": 0}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_queue_full_sheds_to_the_sync_path(monkeypatch, device):
    """Shed: on a card path (device None) one direct supervised pass, on
    the CPU the host reference; both counted."""
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE_QUEUE", "1")
    passes = []
    xl.set_ladder_runner(lambda ps: passes.append(len(ps)) or xl.host_exchange(ps))
    pool = handshake_pool.get_pool()
    pool.pause()
    try:
        blocker = pool.submit(_key("blocker"), BOB_PUB, device)
        assert handshake_pool.exchange(ALICE_PRIV, BOB_PUB, device) == SHARED
        snap = tstats.snapshot()
        assert snap["hs_shed"] == 1 and snap["handshakes"]["sync"] == 1
        if device is None:
            assert passes == [1] and tds.tier_counts(xl.X25519)["cuda"] == (1, 1)
        else:
            assert passes == [] and tds.tier_counts(xl.X25519)["host"] == (1, 1)
    finally:
        pool.resume()
    assert blocker.result(timeout=30) == aead_ref.x25519(_key("blocker"), BOB_PUB)


def test_timed_out_dial_sheds(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE_TIMEOUT_S", "0.05")
    xl.set_ladder_runner(xl.host_exchange)
    pool = handshake_pool.get_pool()
    pool.pause()
    try:
        assert handshake_pool.exchange(ALICE_PRIV, BOB_PUB, "cpu") == SHARED
    finally:
        pool.resume()
    snap = tstats.snapshot()
    assert snap["hs_shed"] == 1 and snap["handshakes"] == {"pool": 0, "sync": 1}


def test_a_flush_the_kernel_did_not_serve_raises_on_a_card_path():
    def exploding(pairs):
        raise RuntimeError("injected ladder fault")

    xl.set_ladder_runner(exploding)
    with pytest.raises(BackendError):
        handshake_pool.exchange(ALICE_PRIV, BOB_PUB)
    # on the CPU the host answers below the plain version
    assert handshake_pool.exchange(ALICE_PRIV, BOB_PUB, "cpu") == SHARED
    assert tds.tier_counts(xl.X25519)["host"] == (1, 1)


def test_handshake_kill_switch_goes_sync(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE", "0")
    assert not handshake_pool.active("cpu")
    assert handshake_pool.exchange(ALICE_PRIV, BOB_PUB) == SHARED
    assert handshake_pool.public_key(ALICE_PRIV) == ALICE_PUB
    assert tds.tier_counts(xl.X25519)["host"] == (2, 2)


# -- SecretConnection --------------------------------------------------------------------


def _pair(tag, device=None, cls=SecretConnection, key=Ed25519PrivKey):
    priv1, priv2 = key.from_seed(_key(tag + "-1")), key.from_seed(_key(tag + "-2"))
    s1, s2 = socket.socketpair()
    out = {}
    kw = {} if cls is jsc.SecretConnection else {"device": device}
    t = threading.Thread(target=lambda: out.__setitem__("b", cls(s2, priv2, **kw)))
    t.start()
    a = cls(s1, priv1, **kw)
    t.join(60)
    return a, out["b"]


def test_secret_connection_round_trip_on_the_host():
    a, b = _pair("rt")
    assert b.remote_pub_key.bytes() == Ed25519PrivKey.from_seed(_key("rt-1")).pub_key().bytes()
    datas = [os.urandom(40 + i) for i in range(10)]
    a.write_frames(datas)
    assert [b.read_frame() for _ in datas] == datas
    big = os.urandom(300 * 1024)
    t = threading.Thread(target=lambda: a.write_msg(big))
    t.start()
    assert b.read_msg() == big
    t.join(30)
    assert tstats.snapshot()["frames"]["batched"] >= 2 * 10
    assert tds.tier_counts(ca.AEAD)["torch"] == (0, 0)  # the gate is closed
    a.close()
    b.close()


def test_secret_connection_on_the_plain_versions(monkeypatch):
    """device="cpu": both handshakes' ladders through the pool on the
    plain ladder (two flushes, ~2.5 s; a loaded CPU must not turn a slow
    flush into a shed dial), the frames on the plain AEAD."""
    monkeypatch.setenv("COMETBFT_TPU_HANDSHAKE_TIMEOUT_S", "300")
    a, b = _pair("plain", device="cpu")
    datas = [os.urandom(1024) for _ in range(16)]
    a.write_frames(datas)
    assert [b.read_frame() for _ in datas] == datas
    b.write_msg(b"pong" * 700)
    assert a.read_msg() == b"pong" * 700
    assert tds.tier_counts(xl.X25519)["torch"][1] == 4
    assert tds.tier_counts(ca.AEAD)["torch"][0] >= 2  # the two seals, at least
    assert tstats.snapshot()["handshakes"] == {"pool": 4, "sync": 0}


def test_tampered_frame_delivers_the_prefix_then_a_sticky_error():
    a, b = _pair("tamper")
    sealed = [a._send.seal(m) for m in (b"one", b"two", b"bad-after-here", b"never")]
    sealed[2] = sealed[2][:-1] + bytes([sealed[2][-1] ^ 1])
    a._sock.sendall(b"".join(struct.pack(">I", len(s)) + s for s in sealed))
    assert b.read_frame() == b"one"
    assert b.read_frame() == b"two"
    for _ in range(2):
        with pytest.raises(SecretConnectionError):
            b.read_frame()
    assert tstats.snapshot()["frames"]["batched"] >= 4


@pytest.mark.parametrize("pool", [True, False])
def test_a_low_order_peer_point_fails_the_handshake(pool):
    """A peer whose ephemeral key is a low-order point (0) makes the shared
    secret all zero: the handshake raises ``ValueError``, through the
    pool and on the direct path alike."""
    if pool:
        xl.set_ladder_runner(xl.host_exchange)
    assert handshake_pool.active() == pool
    s1, s2 = socket.socketpair()
    s2.sendall(bytes(32))
    with pytest.raises(ValueError):
        SecretConnection(s1, Ed25519PrivKey.from_seed(_key("low")))
    assert len(s2.recv(64)) == 32  # our ephemeral went out first
    s1.close()
    s2.close()


def test_wire_bytes_equal_the_jax_package_across_carried_streams():
    """A JAX SecretConnection pair; each direction's next frames sealed
    by the port (``half_duplex_from``) are what the JAX side opens, and
    the port opens what the JAX side seals."""
    a, b = _pair("wire", cls=jsc.SecretConnection, key=JEd25519PrivKey)
    datas = [os.urandom(1024) for _ in range(8)]
    send = convert.half_duplex_from(a._send, device="cpu")
    ours = send.seal_batch(datas)
    assert ours == a._send.seal_batch(datas)  # the JAX stream at the same nonces
    recv = convert.half_duplex_from(b._recv, device="cpu")
    assert recv.open_batch(ours) == (datas, None)
    assert b._recv.open_batch(ours) == (datas, None)
    assert send.nonce == a._send.nonce and recv.nonce == b._recv.nonce
    jpool.reset_pool()


def test_priv_key_from_and_derive_secrets():
    from cometbft_tpu_torch.p2p import secret_connection as tsc

    jkey = JEd25519PrivKey.from_seed(_key("node"))
    key = convert.priv_key_from(jkey)
    assert key.pub_key().bytes() == jkey.pub_key().bytes()
    assert key.sign(b"m") == jkey.sign(b"m")
    lo, hi = _key("e1"), _key("e2")
    assert tsc.derive_secrets(SHARED, lo, hi) == jsc.derive_secrets(SHARED, lo, hi)
    assert tsc.derive_secrets(SHARED, hi, lo) == jsc.derive_secrets(SHARED, hi, lo)
    with pytest.raises(ValueError):
        convert.priv_key_from(type("K", (), {"type_": "secp256k1"})())


def test_aead_ref_is_the_jax_reference():
    for n in (0, 1, 64, 1000):
        k, nc, d = os.urandom(32), os.urandom(12), os.urandom(n)
        assert aead_ref.ChaCha20Poly1305Ref(k).encrypt(nc, d, b"x") == \
            jaead.ChaCha20Poly1305Ref(k).encrypt(nc, d, b"x")
    s, u = os.urandom(32), os.urandom(32)
    assert aead_ref.x25519(s, u) == jaead.x25519(s, u)

"""Import audit: the port (``cometbft_tpu_torch/``) and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``cometbft_tpu``.

An AST scan checks every import statement, and the native sources
(``csrc/``) include only system headers and each other; a subprocess then
runs gossip-time ``Vote.verify`` through the verify scheduler, the
supervisor and the plain version on the CPU (the C++ packer included),
a secp256k1 batch through its verifier, the supervisor's single-tier
call and the plain ECDSA version, a BLS12-381 batch through its verifier
(the host library, the supervisor's single-tier call and the plain G1
ladder), and a validator-set hash at the tree
plane's width (on the host and on the plain tree version), and a
``SecretConnection`` round trip on the plain versions of the transport
kernels (the handshake's ladders through the pool, frames through the
plane), and a node's apply path (``tests/torch_chain``: genesis, the
KVStore app through ``LocalClient``, two blocks cut into part sets, saved
in the block store and applied by ``BlockExecutor`` over ``MemKV``, the
LastCommit through the plain version), and the consensus core
(``tests/torch_sim``: four validators on the seeded virtual-time network,
three heights, one of them crashed and rebuilt from its stores, its WAL
replayed), and the network (``tests/torch_net``: two switches on
``device="cpu"`` over loopback, their dial through the handshake pool and
the AEAD plane, a message each way on an echo channel, and a joiner's
blocksync of three heights from a serving node, its commits through the
plain version), and checks that neither name reached ``sys.modules``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_net.py"
]
CSRC = ROOT / "cometbft_tpu_torch" / "csrc"
NATIVE_FILES = sorted(p for p in CSRC.iterdir() if p.suffix in (".cpp", ".cu", ".cuh", ".h"))


def _forbidden(name: str) -> bool:
    return (
        name == "jax"
        or name.startswith("jax.")
        or name.startswith("jaxlib")
        or name == "cometbft_tpu"
        or name.startswith("cometbft_tpu.")
    )


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for need in (
        "chip_smoke.py",
        "cometbft_tpu_torch/ops/cuda_verify.py",
        "cometbft_tpu_torch/ops/verify.py",
        "cometbft_tpu_torch/types/validation.py",
        "cometbft_tpu_torch/convert.py",
        "cometbft_tpu_torch/native.py",
        "cometbft_tpu_torch/crypto/sigcache.py",
        "cometbft_tpu_torch/crypto/backend_health.py",
        "cometbft_tpu_torch/ops/dispatch_stats.py",
        "cometbft_tpu_torch/ops/supervisor.py",
        "cometbft_tpu_torch/verifysched/service.py",
        "cometbft_tpu_torch/verifysched/stats.py",
        "cometbft_tpu_torch/types/vote.py",
        "cometbft_tpu_torch/crypto/secp256k1.py",
        "cometbft_tpu_torch/ops/fpgen.py",
        "cometbft_tpu_torch/ops/wcurve.py",
        "cometbft_tpu_torch/ops/secp_verify.py",
        "cometbft_tpu_torch/ops/cuda_secp.py",
        "cometbft_tpu_torch/crypto/merkle.py",
        "cometbft_tpu_torch/ops/sha256_tree.py",
        "cometbft_tpu_torch/ops/cuda_sha256.py",
        "cometbft_tpu_torch/proofserve/plane.py",
        "cometbft_tpu_torch/types/light.py",
        "cometbft_tpu_torch/light/verifier.py",
        "cometbft_tpu_torch/crypto/bls12381.py",
        "cometbft_tpu_torch/ops/fp381.py",
        "cometbft_tpu_torch/ops/bls_g1.py",
        "cometbft_tpu_torch/ops/cuda_bls.py",
        "cometbft_tpu_torch/crypto/aead_ref.py",
        "cometbft_tpu_torch/ops/chacha_aead.py",
        "cometbft_tpu_torch/ops/cuda_aead.py",
        "cometbft_tpu_torch/ops/x25519_ladder.py",
        "cometbft_tpu_torch/ops/cuda_x25519.py",
        "cometbft_tpu_torch/p2p/transport_stats.py",
        "cometbft_tpu_torch/p2p/transportplane.py",
        "cometbft_tpu_torch/p2p/handshake_pool.py",
        "cometbft_tpu_torch/p2p/secret_connection.py",
        "cometbft_tpu_torch/version.py",
        "cometbft_tpu_torch/utils/fail.py",
        "cometbft_tpu_torch/libs/log.py",
        "cometbft_tpu_torch/libs/sync.py",
        "cometbft_tpu_torch/abci/types.py",
        "cometbft_tpu_torch/abci/application.py",
        "cometbft_tpu_torch/abci/kvstore.py",
        "cometbft_tpu_torch/abci/client.py",
        "cometbft_tpu_torch/types/params.py",
        "cometbft_tpu_torch/types/genesis.py",
        "cometbft_tpu_torch/types/block.py",
        "cometbft_tpu_torch/types/part_set.py",
        "cometbft_tpu_torch/types/evidence.py",
        "cometbft_tpu_torch/types/codec.py",
        "cometbft_tpu_torch/types/events.py",
        "cometbft_tpu_torch/libs/pubsub.py",
        "cometbft_tpu_torch/libs/storage_stats.py",
        "cometbft_tpu_torch/libs/diskguard.py",
        "cometbft_tpu_torch/store/kv.py",
        "cometbft_tpu_torch/store/block_store.py",
        "cometbft_tpu_torch/state/state.py",
        "cometbft_tpu_torch/state/store.py",
        "cometbft_tpu_torch/state/execution.py",
        "cometbft_tpu_torch/evidence/stats.py",
        "cometbft_tpu_torch/evidence/verify.py",
        "cometbft_tpu_torch/evidence/pool.py",
        "cometbft_tpu_torch/mempool/clist_mempool.py",
        "cometbft_tpu_torch/libs/service.py",
        "cometbft_tpu_torch/libs/clist.py",
        "cometbft_tpu_torch/txingest/stats.py",
        "cometbft_tpu_torch/config/config.py",
        "cometbft_tpu_torch/consensus/ticker.py",
        "cometbft_tpu_torch/types/vote_set.py",
        "cometbft_tpu_torch/consensus/types.py",
        "cometbft_tpu_torch/consensus/messages.py",
        "cometbft_tpu_torch/consensus/wal.py",
        "cometbft_tpu_torch/consensus/state.py",
        "cometbft_tpu_torch/consensus/replay.py",
        "cometbft_tpu_torch/privval/file_pv.py",
        "cometbft_tpu_torch/proxy/multi_app_conn.py",
        "cometbft_tpu_torch/sim/clock.py",
        "cometbft_tpu_torch/sim/network.py",
        "cometbft_tpu_torch/sim/node.py",
        "cometbft_tpu_torch/sim/invariants.py",
        "cometbft_tpu_torch/libs/flowrate.py",
        "cometbft_tpu_torch/p2p/node_info.py",
        "cometbft_tpu_torch/p2p/conn.py",
        "cometbft_tpu_torch/p2p/peer.py",
        "cometbft_tpu_torch/p2p/reactor.py",
        "cometbft_tpu_torch/p2p/transport.py",
        "cometbft_tpu_torch/p2p/switch.py",
        "cometbft_tpu_torch/p2p/pex.py",
        "cometbft_tpu_torch/node/nodekey.py",
        "cometbft_tpu_torch/consensus/reactor.py",
        "cometbft_tpu_torch/mempool/reactor.py",
        "cometbft_tpu_torch/evidence/reactor.py",
        "cometbft_tpu_torch/blocksync/stats.py",
        "cometbft_tpu_torch/blocksync/pool.py",
        "cometbft_tpu_torch/blocksync/reactor.py",
        "tests/torch_net.py",
    ):
        assert need in names
    assert {p.name for p in NATIVE_FILES} >= {
        "host_prep.cpp", "ed25519_verify.cu", "secp256k1_verify.cu",
        "sha256_tree.cu", "bls12381.cpp", "bls_g1.cu", "chacha20_poly1305.cu",
        "x25519_ladder.cu"}


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[p.relative_to(ROOT).as_posix() for p in PORT_FILES]
)
def test_no_jax_import(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert bad == [], f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", NATIVE_FILES, ids=[p.relative_to(ROOT).as_posix() for p in NATIVE_FILES]
)
def test_native_sources_include_nothing_outside_csrc(path):
    local = {p.name for p in NATIVE_FILES}
    for line in path.read_text().splitlines():
        if not line.lstrip().startswith("#include"):
            continue
        target = line.split("#include", 1)[1].strip()
        ok = target.startswith("<") or target.strip('"') in local
        assert ok and "cometbft_tpu/" not in target and "jax" not in target, line


_PROBE = r"""
import sys
import threading
import time
from cometbft_tpu_torch.ops import verify as ov
import cometbft_tpu_torch.convert, cometbft_tpu_torch.types.validation
import cometbft_tpu_torch.ops.cuda_verify, cometbft_tpu_torch.ops._build
import cometbft_tpu_torch.crypto.sigcache
# gossip-time Vote.verify, a good vote and one whose signature is of other
# bytes, through the verify scheduler (opened on the CPU), the supervisor
# and the plain version: both ride one flush
from cometbft_tpu_torch import verifysched
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types.basic import PRECOMMIT_TYPE, BlockID, Timestamp
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.verifysched import service
real_trusted = service.backend_trusted
service.backend_trusted = lambda: True
sched = service._SCHED = service.VerifyScheduler(device="cpu")
priv = Ed25519PrivKey.from_seed(b"\x05" * 32)
votes = [Vote(PRECOMMIT_TYPE, 1, 0, BlockID(), Timestamp(1, k),
              priv.pub_key().address(), 0) for k in range(2)]
for v in votes:
    v.signature = priv.sign(v.sign_bytes("audit-chain"))
votes[1].signature = votes[0].signature
got = [None, None]
sched.pause()
peers = [threading.Thread(target=lambda k=k: got.__setitem__(
    k, votes[k].verify("audit-chain", priv.pub_key()))) for k in range(2)]
for t in peers:
    t.start()
while sched.pending() < 2:
    time.sleep(0.001)
sched.resume()
for t in peers:
    t.join(120)
assert got == [True, False], got
from cometbft_tpu_torch import native
assert native.lib.cache_info().currsize == 1  # packed by the C++ library
from cometbft_tpu_torch.ops import dispatch_stats
assert dispatch_stats.tier_counts()["torch"] == (1, 2)  # one plain verify
assert verifysched.stats.snapshot()["submitted"]["consensus"] == 2
verifysched.reset_scheduler()
# a secp256k1 batch: the verifier, the supervisor's single-tier call, host
# prep and the plain version of the ECDSA kernel
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
import cometbft_tpu_torch.ops.cuda_secp
spriv = Secp256k1PrivKey.from_secret(b"audit")
bv = batch.create_batch_verifier(spriv.pub_key(), backend="cpu")
for m in (b"a", b"b"):
    bv.add(spriv.pub_key(), m, spriv.sign(b"a"))
assert bv.verify() == (False, [True, False])
assert dispatch_stats.tier_counts("secp256k1")["torch"] == (1, 2)
# a BLS12-381 batch: the host library's checks, hashes and pairing, the
# supervisor's single-tier call and the plain G1 ladder (two of three
# signatures good, so the combination fails and each is verified alone)
from cometbft_tpu_torch.crypto.keys import Bls12381PrivKey
import cometbft_tpu_torch.ops.cuda_bls
bprivs = [Bls12381PrivKey.from_secret(b"audit-%d" % k) for k in range(3)]
bv = batch.create_batch_verifier(bprivs[0].pub_key(), backend="cpu")
for k, p in enumerate(bprivs):
    bv.add(p.pub_key(), b"bls %d" % k, p.sign(b"bls %d" % min(k, 1)))
assert bv.verify() == (False, [True, True, False])
assert dispatch_stats.tier_counts("bls12_381")["torch"] == (1, 3)
# a validator-set hash at the tree plane's width (the gate is closed on a
# machine with no trusted card: the host), the plain tree version, and the
# light verifier's module
service.backend_trusted = real_trusted
import cometbft_tpu_torch.light.verifier
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.ops import sha256_tree
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
vals = ValidatorSet([Validator(Ed25519PrivKey.from_seed(bytes([i]) * 32).pub_key(), 1)
                     for i in range(40)])
leaves = [v.simple_encode() for v in vals.validators]
root = vals.hash()
assert root == merkle.hash_from_byte_slices(leaves)
assert sha256_tree.tree_root(leaves, device="cpu") == root
assert dispatch_stats.tier_counts("merkle") == {
    "cuda": (0, 0), "torch": (1, 40), "host": (1, 40)}
# a SecretConnection pair on the plain versions of the transport kernels:
# both handshakes' ladders through the pool, 16 frames through the plane
import os, socket
os.environ["COMETBFT_TPU_HANDSHAKE_TIMEOUT_S"] = "300"  # a slow flush, not a shed
from cometbft_tpu_torch.p2p.secret_connection import SecretConnection
import cometbft_tpu_torch.ops.cuda_aead, cometbft_tpu_torch.ops.cuda_x25519
s1, s2 = socket.socketpair()
ends = {}
t = threading.Thread(target=lambda: ends.__setitem__("b", SecretConnection(
    s2, Ed25519PrivKey.from_seed(b"\x07" * 32), device="cpu")))
t.start()
a = SecretConnection(s1, priv, device="cpu")
t.join(120)
frames = [bytes([k]) * 1024 for k in range(16)]
a.write_frames(frames)
assert [ends["b"].read_frame() for _ in frames] == frames
assert ends["b"].remote_pub_key == priv.pub_key()
assert dispatch_stats.tier_counts("x25519")["torch"][1] == 4
assert dispatch_stats.tier_counts("aead")["torch"][1] >= 16
from cometbft_tpu_torch.p2p import handshake_pool
handshake_pool.reset_pool()
# a node's apply path: two heights over MemKV, the LastCommit of height 2
# through the plain version on the CPU
sys.path.insert(0, "tests")
import torch_chain
cpu = {"device": "cpu"}
chain, rec = torch_chain.drive("cometbft_tpu_torch", heights=2, evidence_at=0,
                               executor_kw=cpu, pool_kw=cpu)
assert chain.block_store.height() == 2 and chain.state.last_block_height == 2
assert chain.state_store.load().to_json() == chain.state.to_json() == rec[-1][0]
assert chain.block_store.load_block(2).hash() == chain.state.last_block_id.hash
assert dispatch_stats.tier_counts()["torch"] == (2, 5)  # the votes', the commit's
# the consensus core: four validators on the seeded virtual-time network,
# three heights, node 1 crashed at height 2 and rebuilt from its stores
# (the Handshaker and its WAL's replay)
import tempfile
import torch_sim
with tempfile.TemporaryDirectory() as d:
    c = torch_sim.Cluster("cometbft_tpu_torch", d, txs_per_height=8, device="cpu")
    assert c.run(2), c.heights()
    c.crash(1)
    c.restart(1)
    assert c.run(3), c.heights()
    assert not c.checker.violations and c.checker.commits_verified >= 12
    assert len({tuple(n["blocks"]) for n in c.chain(3).values()}) == 1
    c.stop()
# the network: two switches on the CPU over loopback, each with an echo
# reactor; the joiner dials the server (ladders through the pool, frames
# through the plane), a message goes each way, and the joiner blocksyncs
# three heights of the server's chain, its commits through the plain
# version (one fused prefetch of the window, then the cache)
import torch_net
from cometbft_tpu_torch.config.config import P2PConfig
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
dispatch_stats.reset()
echoed = []

class Echo(Reactor):
    def __init__(self):
        super().__init__("Echo")
    def get_channels(self):
        return [ChannelDescriptor(0x77, priority=1, send_queue_capacity=10)]
    def receive(self, chan_id, peer, msg):
        echoed.append(msg)
        if msg == b"ping":
            peer.try_send(0x77, b"pong")

server, _ = torch_chain.drive("cometbft_tpu_torch", heights=4, evidence_at=0,
                              executor_kw=cpu, pool_kw=cpu)
import cometbft_tpu_torch.crypto.sigcache as sc
sc.reset_cache()
joiner = torch_chain.Chain("cometbft_tpu_torch", executor_kw=cpu, pool_kw=cpu)
nodes = []
try:
    for name, chain, sync in ((b"srv", server, False), (b"joiner", joiner, True)):
        nodes.append(torch_net.build(
            "cometbft_tpu_torch", torch_net.node_key("cometbft_tpu_torch", name),
            torch_chain.CHAIN_ID, p2p_config=P2PConfig(pex=False), state=chain.state,
            block_exec=chain.executor, block_store=chain.block_store, block_sync=sync,
            device="cpu", extra_reactors=[("ECHO", Echo())]))
    srv, jn = nodes
    srv.start()
    jn.start([srv.address])
    assert jn.wait_peers(1, 120) and srv.wait_peers(1, 120)
    assert jn.switch.peers_list()[0].try_send(0x77, b"ping")
    bs = jn.reactors["BLOCKSYNC"]
    deadline = time.time() + 180
    while (bs.syncing or len(echoed) < 2) and time.time() < deadline:
        time.sleep(0.02)
    assert sorted(echoed) == [b"ping", b"pong"], echoed
    assert not bs.syncing and joiner.block_store.height() == 3, joiner.block_store.height()
    assert [joiner.block_store.load_block(h).hash() for h in (1, 2, 3)] == [
        server.block_store.load_block(h).hash() for h in (1, 2, 3)]
    assert bs.state.app_hash == server.block_store.load_block(4).header.app_hash
    assert dispatch_stats.tier_counts("x25519")["torch"][1] == 4
    assert dispatch_stats.tier_counts("aead")["torch"][0] >= 1
    assert dispatch_stats.snapshot()["fused_batches"] >= 1
finally:
    for n in nodes:
        n.stop()
    handshake_pool.reset_pool()
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "cometbft_tpu" or m.startswith("cometbft_tpu."))
print("LEAKED", leaked)
"""


def test_port_runs_without_jax_in_sys_modules():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=str(ROOT),
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout

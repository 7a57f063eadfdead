"""The port's ``crypto/proof_op.py`` held to the JAX package's: key paths,
``proofs_from_map`` roots and ``ProofOps`` bytes over maps drawn from one
``random.Random`` seed, and the verdict of every chain (accepted, or the
error class and message) through both runtimes, with each package also
verifying the other's encoded chains.  The cases include the JAX file's
two fixes: a chain whose operators produce no root is refused, and an
existence proof of an empty value is no absence proof.  Tolerance: exact
bytes and exact verdicts.
"""

import random

import pytest

from cometbft_tpu.crypto import proof_op as jpo
from cometbft_tpu_torch.crypto import proof_op as tpo

SEED = 20261024
PKGS = (jpo, tpo)


def _store(rng: random.Random, n: int) -> dict:
    return {b"k%03d" % rng.randrange(1000): rng.randbytes(rng.randrange(0, 40))
            for _ in range(n)}


def _verdict(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class and text are the verdict
        return ("refused", type(e).__name__, str(e))
    return ("accepted",)


def _hexpath(*keys) -> str:
    return "".join("/x:" + k.hex() for k in keys)


@pytest.mark.parametrize("path", [
    "/App/IBC/x:010203", "/a%2Fb%20c", "/x:", "/", "no-leading-slash", "/x:zz", "",
    "/caf%C3%A9/x:ff",
])
def test_key_paths_equal_jax(path):
    got = [_verdict(lambda p=p: p.key_path_to_keys(path)) for p in PKGS]
    assert got[0] == got[1]
    if got[0] == ("accepted",):
        assert tpo.key_path_to_keys(path) == jpo.key_path_to_keys(path)
    for enc in (tpo.KEY_ENCODING_URL, tpo.KEY_ENCODING_HEX, 7):
        key = b"a/b c"
        built = [_verdict(lambda p=p: str(p.KeyPath().append_key(key, enc))) for p in PKGS]
        assert built[0] == built[1]
        if built[0] == ("accepted",):
            assert str(tpo.KeyPath().append_key(key, enc)) == str(
                jpo.KeyPath().append_key(key, enc))


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_roots_and_proof_ops_bytes_equal_jax(n):
    kvs = _store(random.Random(SEED + n), n)
    (jroot, jops), (troot, tops) = jpo.proofs_from_map(kvs), tpo.proofs_from_map(kvs)
    assert troot == jroot and sorted(tops) == sorted(jops)
    for k in kvs:
        tb, jb = tpo.ProofOps(ops=[tops[k].proof_op()]).encode(), jpo.ProofOps(
            ops=[jops[k].proof_op()]).encode()
        assert tb == jb
        back = tpo.ProofOps.decode(jb)
        assert back.encode() == jb
        assert tpo.value_op_decoder(back.ops[0]).proof_op().data == jops[k].proof_op().data


def _chains(pkg, rng):
    """(name, ProofOps, root, check) for both packages from one draw: check
    is (how, keypath, value) run through the default runtime."""
    store = _store(rng, 9)
    store[b"empty"] = b""
    k = sorted(store)[3]
    sroot, sops = pkg.proofs_from_map(store)
    outer = {b"app": sroot, b"other": rng.randbytes(32)}
    oroot, oops = pkg.proofs_from_map(outer)
    one = pkg.ProofOps(ops=[sops[k].proof_op()])
    two = pkg.ProofOps(ops=[sops[k].proof_op(), oops[b"app"].proof_op()])
    empty = pkg.ProofOps(ops=[sops[b"empty"].proof_op()])
    return [
        ("single", one, sroot, ("value", _hexpath(k), store[k])),
        ("wrong value", one, sroot, ("value", _hexpath(k), store[k] + b"!")),
        ("wrong key", one, sroot, ("value", _hexpath(b"k999"), store[k])),
        ("wrong root", one, oroot, ("value", _hexpath(k), store[k])),
        ("two trees", two, oroot, ("value", _hexpath(b"app", k), store[k])),
        ("two trees reversed", two, oroot, ("value", _hexpath(k, b"app"), store[k])),
        ("unconsumed path", one, sroot, ("value", _hexpath(b"extra", k), store[k])),
        ("exhausted path", two, oroot, ("value", _hexpath(k), store[k])),
        ("bad path", one, sroot, ("value", "x:" + k.hex(), store[k])),
        ("no operators", pkg.ProofOps(ops=[]), sroot, ("value", _hexpath(k), store[k])),
        ("unknown op", pkg.ProofOps(ops=[pkg.ProofOp("iavl:v", k, b"")]), sroot,
         ("value", _hexpath(k), store[k])),
        ("empty value", empty, sroot, ("value", _hexpath(b"empty"), b"")),
        # ADVICE fix: an existence proof of an empty value is no absence proof
        ("absence from an empty value", empty, sroot, ("absence", _hexpath(b"empty"), None)),
    ]


def _run(pkg, ops, root, check):
    how, keypath, value = check
    prt = pkg.default_proof_runtime()
    if how == "absence":
        return _verdict(lambda: prt.verify_absence(ops, root, keypath))
    return _verdict(lambda: prt.verify_value(ops, root, keypath, value))


@pytest.mark.parametrize("seed", [1, 2])
def test_chain_verdicts_equal_jax(seed):
    jc, tc = _chains(jpo, random.Random(SEED * seed)), _chains(tpo, random.Random(SEED * seed))
    verdicts = {}
    for (name, jops, jroot, check), (_, tops, troot, _) in zip(jc, tc):
        assert tops.encode() == jops.encode() and troot == jroot, name
        want = _run(jpo, jops, jroot, check)
        assert _run(tpo, tops, troot, check) == want, name
        # each package verifies the other's bytes alike
        assert _run(tpo, tpo.ProofOps.decode(jops.encode()), jroot, check) == want, name
        assert _run(jpo, jpo.ProofOps.decode(tops.encode()), troot, check) == want, name
        verdicts[name] = want[0]
    assert verdicts["single"] == verdicts["two trees"] == verdicts["empty value"] == "accepted"
    assert verdicts["absence from an empty value"] == "refused"
    assert sum(v == "refused" for v in verdicts.values()) == len(verdicts) - 3


def test_a_chain_with_no_root_is_refused_alike():
    """ADVICE fix: operators that leave no root refuse the chain, in both."""
    out = []
    for pkg in PKGS:
        class Swallow:
            def get_key(self):
                return b""

            def run(self, args):
                return []

        prt = pkg.ProofRuntime()
        prt.register_op_decoder("swallow", lambda pop: Swallow())
        ops = pkg.ProofOps(ops=[pkg.ProofOp("swallow", b"", b"")])
        out.append(_verdict(lambda: prt.verify_value(ops, b"\x00" * 32, "/", b"v")))
        out.append(_verdict(lambda: prt.register_op_decoder("swallow", None)))
    assert out[:2] == out[2:]
    assert out[0] == ("refused", "ProofError", "proof operators produced no root")

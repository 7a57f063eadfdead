"""Import audit: the port (``cometbft_tpu_torch/``) and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``cometbft_tpu``.

An AST scan checks every import statement, and the native sources
(``csrc/``) include only system headers and each other; a subprocess then
runs a small verify through the port on the CPU (its C++ packer included)
and checks that neither name reached ``sys.modules``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
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
    ):
        assert need in names
    assert {p.name for p in NATIVE_FILES} >= {"host_prep.cpp", "ed25519_verify.cu"}


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
import numpy as np
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import verify as ov
import cometbft_tpu_torch.convert, cometbft_tpu_torch.types.validation
import cometbft_tpu_torch.ops.cuda_verify, cometbft_tpu_torch.ops._build
seed = b"\x05" * 32
pub, msg = ref.pubkey_from_seed(seed), b"audit"
sig = ref.sign(seed, msg)
bits = ov.verify_batch([pub, pub], [msg, msg + b"!"], [sig, sig], device="cpu")
assert list(bits) == [True, False], bits
from cometbft_tpu_torch import native
assert native.lib.cache_info().currsize == 1  # packed by the C++ library
import cometbft_tpu_torch.crypto.sigcache
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

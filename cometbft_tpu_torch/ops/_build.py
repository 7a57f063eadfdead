"""Build the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` at first use.

Each build is one source compiled into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  A build is named: ``<stem>`` is ``csrc/<stem>.cu`` as it
is, and the names in ``VARIANTS`` compile a source with extra ``-D`` flags
(the verify kernel's stage builds).  Libraries go to
``cometbft_tpu_torch/build/``, named by a hash of the sources and that
build's flags, so an edited source is rebuilt and an unchanged one is not.
Only sources in the repository are built; a missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
]


# build name -> (source stem, extra flags): the verify kernel stopped after
# decompression, after its table and after the Straus walk (ED25519_STAGE,
# see csrc/ed25519_verify.cu), for the stage profile in ``ops.profile``.
VARIANTS = {
    f"ed25519_verify_stage{k}": ("ed25519_verify", (f"-DED25519_STAGE={k}",))
    for k in (1, 2, 3)
}


def sources() -> list[str]:
    """Names of every build: the kernels in ``csrc/`` (``<name>.cu``) and
    the variants."""
    return sorted({p.stem for p in CSRC_DIR.glob("*.cu")} | set(VARIANTS))


def _recipe(name: str) -> tuple[str, tuple]:
    return VARIANTS.get(name, (name, ()))


def _digest(name: str) -> str:
    flags = [*NVCC_FLAGS, *_recipe(name)[1]]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built on this machine"
    )


def build_all(names: "list[str] | None" = None) -> dict:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: seconds} for the ones
    compiled; raises with the compiler's output if any fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        stem, defines = _recipe(name)
        src = CSRC_DIR / f"{stem}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        tmp = lib_path(name).with_suffix(f".so.tmp{os.getpid()}")
        procs[name] = (
            subprocess.Popen(
                [compiler, *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    seconds, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of build ``name`` (built first if needed)."""
    build_all([name])
    return ctypes.CDLL(str(lib_path(name)))


def build_log(name: str) -> str:
    """nvcc's output for the last build of ``name`` (ptxas resource usage)."""
    p = log_path(name)
    return p.read_text() if p.exists() else ""

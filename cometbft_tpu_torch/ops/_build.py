"""Build the port's native sources (``csrc/``) at first use.

Each build is one source compiled into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  A build is named: ``<stem>`` is ``csrc/<stem>.cu`` (a
kernel, built by ``nvcc``) or ``csrc/<stem>.cpp`` (host code, built by
``g++``, also on a machine without CUDA) as it is, and the names in
``VARIANTS`` compile a kernel source with extra ``-D`` flags (the verify
kernel's stage builds).  Libraries go to ``cometbft_tpu_torch/build/``,
named by a hash of the sources and that build's flags, so an edited
source is rebuilt and an unchanged one is not.  Only sources in the
repository are built; a missing compiler or a failed build raises.

The directory is the build cache: a library built by an earlier process
(or an earlier call) is found, not rebuilt.  Each build's outcome in this
process is kept for the warm-boot pass (``ops/warmboot``) to read, the
counterpart of the JAX package's ``ops/aot_cache`` info dicts: ``status``
is ``hit`` (found built), ``built`` (compiled now; ``info`` has its
seconds) or ``error:<Type>``, and the counters are in ``ops/warm_stats``.
"""

from __future__ import annotations

import ctypes
import fcntl
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
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


# build name -> (source stem, extra flags): the verify kernel stopped after
# decompression, after its table and after the Straus walk (ED25519_STAGE,
# see csrc/ed25519_verify.cu), for the stage profile in ``ops.profile``.
VARIANTS = {
    f"ed25519_verify_stage{k}": ("ed25519_verify", (f"-DED25519_STAGE={k}",))
    for k in (1, 2, 3)
}


def sources() -> list[str]:
    """Names of every build: the kernels in ``csrc/`` (``<name>.cu``), the
    variants, and the host libraries (``<name>.cpp``)."""
    return sorted(
        {p.stem for p in CSRC_DIR.glob("*.cu")}
        | set(VARIANTS)
        | {p.stem for p in CSRC_DIR.glob("*.cpp")}
    )


def _recipe(name: str) -> tuple[str, tuple]:
    return VARIANTS.get(name, (name, ()))


def is_host(name: str) -> bool:
    """True for a host library (``csrc/<name>.cpp``, built by ``g++``)."""
    return (CSRC_DIR / f"{name}.cpp").exists()


def _digest(name: str) -> str:
    if is_host(name):
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update((CSRC_DIR / f"{name}.cpp").read_bytes())
        return h.hexdigest()[:16]
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


def gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH: the host library cannot be built"
    )


def _command(name: str, out: Path) -> list[str]:
    if is_host(name):
        src = CSRC_DIR / f"{name}.cpp"
        return [gxx(), *GXX_FLAGS, "-o", str(out), str(src)]
    stem, defines = _recipe(name)
    src = CSRC_DIR / f"{stem}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return [nvcc(), *NVCC_FLAGS, *defines, "-o", str(out), str(src)]


_INFO: "dict[str, dict]" = {}  # build name -> its outcome in this process


def _record(name: str, outcome: str, seconds: "float | None" = None) -> None:
    """Keep a build's first outcome in this process (an error may be
    followed by a success), and count it."""
    from cometbft_tpu_torch.ops import warm_stats

    prev = _INFO.get(name)
    if prev is None or prev["build"].startswith("error"):
        _INFO[name] = ({"build": outcome} if seconds is None
                       else {"build": outcome, "build_s": seconds})
        warm_stats.record_build(outcome, seconds)


def info(name: str) -> dict:
    """The outcome of build ``name`` in this process: {"build": "hit"},
    {"build": "built", "build_s": seconds} or {"build": "error:<Type>"};
    empty before its first build."""
    return dict(_INFO.get(name, {}))


def statuses(names) -> "dict[str, str | None]":
    """{name: its build status in this process, None before its first
    build}."""
    return {n: _INFO.get(n, {}).get("build") for n in names}


def build_all(names: "list[str] | None" = None) -> dict:
    """Compile every named source that is not built yet, one compiler per
    source, all started together (under a lock, so that processes sharing
    the build directory build each library once).  Returns {name: seconds}
    for the ones compiled; raises with the compiler's output if any
    fails."""
    names = sources() if names is None else names
    try:
        if not all(lib_path(n).exists() for n in names):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                return _compile([n for n in names if not lib_path(n).exists()])
    except Exception as e:
        for n in names:
            if not lib_path(n).exists():
                _record(n, f"error:{type(e).__name__}")
        raise
    finally:
        for n in names:
            if lib_path(n).exists():
                _record(n, "hit")
    return {}


def _compile(todo: list[str]) -> dict:
    tmps = {n: lib_path(n).with_suffix(f".so.tmp{os.getpid()}") for n in todo}
    # raises before any starts, naming a missing nvcc before a missing g++
    commands = {n: _command(n, tmps[n]) for n in sorted(todo, key=is_host)}
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        procs[name] = (
            subprocess.Popen(
                commands[name],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmps[name],
        )
    seconds, failed = {}, []
    # host libraries first: they finish first, so their seconds are their own
    for name in sorted(procs, key=lambda n: not is_host(n)):
        proc, tmp = procs[name]
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        _record(name, "built", seconds[name])
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return seconds


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of build ``name`` (built first if needed)."""
    build_all([name])
    return ctypes.CDLL(str(lib_path(name)))


def occupancy(name: str) -> dict:
    """The launch resources of kernel ``name`` on the current card, from
    the library's ``<name>_occupancy``: resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads per
    block, and registers, local memory bytes per thread and static shared
    memory bytes per block of the compiled kernel."""
    fn = getattr(load(name), f"{name}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(5)]
    rc = fn(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {rc}")
    keys = ("blocks_per_sm", "threads", "regs", "local_bytes", "shared_bytes")
    return dict(zip(keys, (v.value for v in vals)))


def build_log(name: str) -> str:
    """The compiler's output for the last build of ``name`` (for a kernel,
    ptxas resource usage)."""
    p = log_path(name)
    return p.read_text() if p.exists() else ""

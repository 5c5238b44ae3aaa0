"""Build, load and count the port's CUDA kernels.

Each library is one CUDA C++ source under `ops/csrc/` with a plain C
interface, holding one or more kernels (`KERNELS` maps each kernel to its
library). At first use it is compiled by `nvcc` into a shared library
under `euler_tpu_torch/_build/<name>-<hash>/` and loaded with ctypes; the
hash covers the source, the nvcc version and the flags, so an edit or a
new toolkit builds anew. A file lock serialises concurrent builds of one library.
`build_all` starts one nvcc per source, all at once.

A failed build raises: no caller falls back to the plain version.

`LAUNCHES` counts launches per kernel name. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")

# library name → source under csrc/
SOURCES = {
    "gather_weighted_sum": "gather_weighted_sum.cu",
    "paged_gather": "paged_gather.cu",
    "paged_cdf_count": "paged_cdf_count.cu",
    "topk_score": "topk_score.cu",
}

# kernel name → the library that holds it
KERNELS = {
    "gather_weighted_sum": "gather_weighted_sum",
    "gather_weighted_sum_dx": "gather_weighted_sum",
    "paged_gather": "paged_gather",
    "paged_gather_dequant": "paged_gather",
    "paged_cdf_count": "paged_cdf_count",
    "paged_topk_score": "topk_score",
    "paged_topk_select": "topk_score",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _paths(name: str, nvcc: str) -> tuple[str, str, str]:
    """(source, build dir, library file) for one library."""
    src = os.path.join(CSRC, SOURCES[name])
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    bdir = os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")
    return src, bdir, os.path.join(bdir, f"lib{name}.so")


def library_path(name: str) -> str:
    return _paths(name, nvcc_path())[2]


def build_all(names=None) -> dict[str, dict]:
    """Compile every named library (default: all) that is not built yet, one nvcc process per source, all started together.
    Returns {name: {"seconds", "built", "log"}}; raises RuntimeError
    naming each source that failed to compile."""
    nvcc = nvcc_path()
    names = list(SOURCES) if names is None else list(names)
    jobs = {}
    out = {}
    try:
        for name in names:
            src, bdir, lib = _paths(name, nvcc)
            os.makedirs(bdir, exist_ok=True)
            lock = open(os.path.join(bdir, "lock"), "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(lib):
                fcntl.flock(lock, fcntl.LOCK_UN)
                lock.close()
                out[name] = {"seconds": 0.0, "built": False,
                             "log": _read(os.path.join(bdir, "build.log"))}
                continue
            tmp = f"{lib}.tmp-{os.getpid()}"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs[name] = (proc, lock, tmp, lib, bdir, time.perf_counter())
        failed = []
        for name, (proc, lock, tmp, lib, bdir, t0) in jobs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            with open(os.path.join(bdir, "build.log"), "w") as f:
                f.write(log)
            if proc.returncode == 0:
                os.replace(tmp, lib)
            else:
                failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            out[name] = {"seconds": seconds, "built": True, "log": log}
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    finally:
        for proc, lock, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fcntl.flock(lock, fcntl.LOCK_UN)
            lock.close()
    return out


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def source(name: str) -> str:
    """The text of library `name`'s CUDA source."""
    return _read(os.path.join(CSRC, SOURCES[name]))


def build_variant(name: str, tag: str, subs: dict[str, str]) -> tuple[str, str]:
    """(library file, nvcc log) of a copy of library `name`'s source in
    which every match of each regex of `subs` (each must match) is
    replaced by its value, built into `BUILD_ROOT/<name>-<tag>/`. Tuning scripts
    use it to time other values of a source's constants; the port's own
    kernels never load such a copy. Raises if nvcc fails."""
    text = source(name)
    for pattern, repl in subs.items():
        text, hits = re.subn(pattern, repl, text)
        if not hits:
            raise RuntimeError(f"{SOURCES[name]}: {pattern!r} matches nothing")
    bdir = os.path.join(BUILD_ROOT, f"{name}-{tag}")
    os.makedirs(bdir, exist_ok=True)
    src = os.path.join(bdir, SOURCES[name])
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(bdir, f"lib{name}.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"CUDA kernel build failed: {src} (nvcc exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    return lib, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The named library (a key of SOURCES), built first if needed; one
    handle per process."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib

"""Build, load and count the port's CUDA kernels.

Each library is one CUDA C++ source under `ops/csrc/` with a plain C
interface, holding one or more kernels (`KERNELS` maps each kernel to its
library). At first use it is compiled by `nvcc` into a shared library
under `euler_tpu_torch/_build/<name>-<hash>/` and loaded with ctypes; the
hash covers the source, the nvcc version and the flags, so an edit or a
new toolkit builds anew. A file lock serialises concurrent builds of one library.
`build_all` starts one nvcc per source, all at once.

A failed build raises: no caller falls back to the plain version.

`build_host` builds a C++ source with the host compiler the same way
(hashed directory, file lock, temporary file renamed into place): the
native graph engine (`graph/native.py`) is built so.

`LAUNCHES` counts launches per kernel name. Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels. A CUDA graph's capture calls the wrappers but
launches nothing, and its replays launch without calling them: the
capture runs under `uncounted_launches`, and each replay adds what it
recorded (`add_launches`), so the counts stay launches on the card.
"""

from __future__ import annotations

import contextlib
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
    "paged_sample_hop": "paged_sample_hop.cu",
    "topk_score": "topk_score.cu",
}

# kernel name → the library that holds it
KERNELS = {
    "gather_weighted_sum": "gather_weighted_sum",
    "gather_weighted_sum_dx": "gather_weighted_sum",
    "paged_gather": "paged_gather",
    "paged_gather_dequant": "paged_gather",
    "paged_cdf_count": "paged_cdf_count",
    "paged_sample_hop": "paged_sample_hop",
    "paged_topk_score": "topk_score",
    "paged_topk_select": "topk_score",
}

# the host compiler's flags for a C++ library with a plain C interface
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
# every read and write of LAUNCHES holds this lock: wrappers launch from
# several threads at once (a fleet's dispatchers, a Prefetcher's workers)
_LAUNCHES_LOCK = threading.Lock()
# per thread: the collectors of the captures open on that thread
_CAPTURES = threading.local()
# capture stream handle -> its capture's collector: the autograd engine
# runs a captured backward's kernels on a thread of its own, on the
# stream of their forward
_STREAM_CAPTURES: dict[int, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def _collector() -> dict | None:
    """The innermost capture open on this thread; else, on a thread whose
    current stream is being captured, that stream's capture; else None."""
    stack = getattr(_CAPTURES, "stack", None)
    if stack:
        return stack[-1]
    if _STREAM_CAPTURES:
        import torch

        if torch.cuda.is_current_stream_capturing():
            return _STREAM_CAPTURES.get(torch.cuda.current_stream().cuda_stream)
    return None


def count_launch(name: str) -> None:
    add_launches({name: 1})


def add_launches(counts: dict[str, int]) -> None:
    """Count launches: one replay of a captured CUDA graph, or (through
    `count_launch`) one wrapper's launch. Inside a capture (`_collector`)
    they go to the capture's collector instead."""
    into = _collector()
    with _LAUNCHES_LOCK:
        target = LAUNCHES if into is None else into
        for name, n in counts.items():
            target[name] = target.get(name, 0) + n


@contextlib.contextmanager
def uncounted_launches(stream=None):
    """Collects into the yielded dict the counts added inside the block by
    this thread and, when the capture's CUDA `stream` is given, by any
    thread launching on that stream while it is captured (autograd's
    backward thread); `LAUNCHES` is left to other work (a graph capture:
    the calls record launches, and launch nothing). Launches counted
    meanwhile by other threads stay in `LAUNCHES`, and none of them enter
    the dict."""
    counted: dict[str, int] = {name: 0 for name in LAUNCHES}
    stack = getattr(_CAPTURES, "stack", None)
    if stack is None:
        stack = _CAPTURES.stack = []
    key = None if stream is None else stream.cuda_stream
    stack.append(counted)
    if key is not None:
        with _LAUNCHES_LOCK:
            _STREAM_CAPTURES[key] = counted
    try:
        yield counted
    finally:
        stack.pop()
        if key is not None:
            with _LAUNCHES_LOCK:
                del _STREAM_CAPTURES[key]


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    with _LAUNCHES_LOCK:
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


def _build_dir(name: str, src: str, compiler: str, flags) -> str:
    """`BUILD_ROOT/<name>-<hash>`: the hash covers the source, the
    compiler's `--version` and the flags, so an edit or a new toolchain
    builds anew."""
    version = subprocess.run(
        [compiler, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(version.encode())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")


def _paths(name: str, nvcc: str) -> tuple[str, str, str]:
    """(source, build dir, library file) for one library."""
    src = os.path.join(CSRC, SOURCES[name])
    bdir = _build_dir(name, src, nvcc, NVCC_FLAGS)
    return src, bdir, os.path.join(bdir, f"lib{name}.so")


def _lock(bdir: str):
    """The build directory's lock file, held exclusively."""
    os.makedirs(bdir, exist_ok=True)
    lock = open(os.path.join(bdir, "lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    return lock


def _unlock(lock) -> None:
    fcntl.flock(lock, fcntl.LOCK_UN)
    lock.close()


def _install(returncode: int, log: str, tmp: str, lib: str, bdir: str) -> bool:
    """Keep a compiler's log beside its library and, when it succeeded,
    rename its output into place (atomically: a reader sees no library or
    a whole one). Returns whether it succeeded."""
    with open(os.path.join(bdir, "build.log"), "w") as f:
        f.write(log)
    if returncode == 0:
        os.replace(tmp, lib)
    return returncode == 0


def cxx_path() -> str:
    """The host C++ compiler: $CXX, else g++ on $PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"no host C++ compiler: {cxx!r} is not on $PATH")
    return found


def build_host(name: str, src: str, cxx: str | None = None) -> str:
    """Build the C++ source `src` with the host compiler (`cxx`, default
    `cxx_path()`) and CXX_FLAGS into `BUILD_ROOT/<name>-<hash>/lib<name>.so`
    unless it is built already; returns the library's path. Raises
    RuntimeError when the compiler fails."""
    cxx = cxx or cxx_path()
    bdir = _build_dir(name, src, cxx, CXX_FLAGS)
    lib = os.path.join(bdir, f"lib{name}.so")
    lock = _lock(bdir)
    try:
        if not os.path.exists(lib):
            tmp = f"{lib}.tmp-{os.getpid()}-{threading.get_ident()}"
            proc = subprocess.run([cxx, *CXX_FLAGS, src, "-o", tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if not _install(proc.returncode, proc.stdout, tmp, lib, bdir):
                raise RuntimeError(f"C++ build failed: {src} ({cxx} exit {proc.returncode}):\n"
                                   f"{proc.stdout}")
    finally:
        _unlock(lock)
    return lib


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
            lock = _lock(bdir)
            if os.path.exists(lib):
                _unlock(lock)
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
            if not _install(proc.returncode, log, tmp, lib, bdir):
                failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            out[name] = {"seconds": seconds, "built": True, "log": log}
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    finally:
        for proc, lock, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            _unlock(lock)
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

"""Build and load the hand-written CUDA kernels: the port's persistent
kernel cache.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with nvcc
(with the shared ``csrc/*.cuh`` headers) into its own shared library,
loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <dir>/lib<name>-<digest>.so \\
         csrc/<name>.cu

The digest covers the source, the shared headers, the flags and the
toolkit (``nvcc --version``'s output), so an edited source or another
nvcc rebuilds and an unchanged one is reused.  Beside each library its
sidecar ``lib<name>-<digest>.ptxas`` keeps nvcc's report (ptxas's
registers, shared memory and spills), so a reused library reports what
its build did; a library without its sidecar is a miss and is rebuilt.
Every file is written under a temporary name and renamed into place, so
two processes that build at once never read a torn file.

The directory is the one ``jit.compile_cache`` arms
(``FLAGS_compile_cache_dir``: ``auto`` = ``build/kernels`` beside the
package).  Nothing is built when the package is imported: ``load``
builds at a kernel's first CUDA launch, and ``build`` compiles several
sources at once, one nvcc process each.  ``STATS`` counts hits, misses
and nvcc processes (``compile_cache.cache_stats``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build", "load", "BUILD_LOG", "STATS", "build_dir",
           "sidecar"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

SOURCES = tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))

# name -> {"seconds": wall time of the nvcc run (0.0 if reused),
#          "ptxas": nvcc's register/shared-memory report (from the sidecar
#          if reused), "path": library, "cached": reused or built}
BUILD_LOG: Dict[str, dict] = {}
# hits (libraries reused), misses (libraries built) and nvcc processes
# started (builds and toolkit queries) in this process
STATS: Dict[str, int] = {"hits": 0, "misses": 0, "nvcc_runs": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_toolkit: Dict[str, str] = {}


def build_dir() -> Path:
    """The kernel cache's directory, armed at first use."""
    from ...jit.compile_cache import ensure_initialized
    return Path(ensure_initialized())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            f"kernels are compiled from source at first use and need the "
            f"CUDA toolkit")
    return found


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _toolkit_version(nvcc: str, out_dir: Path) -> str:
    """``nvcc --version``'s output, asked once a toolkit binary: kept in
    the cache directory under a name made from the binary's path, inode,
    size and modification time, so a warm start runs no nvcc at all."""
    st = os.stat(nvcc)
    ident = hashlib.sha256(f"{os.path.realpath(nvcc)}:{st.st_ino}:"
                           f"{st.st_size}:{st.st_mtime_ns}".encode()
                           ).hexdigest()[:16]
    if ident in _toolkit:
        return _toolkit[ident]
    cached = out_dir / f"nvcc-{ident}.version"
    if cached.exists():
        text = cached.read_text()
    else:
        STATS["nvcc_runs"] += 1
        text = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        _write_atomic(cached, text.encode())
    _toolkit[ident] = text
    return text


def _target(name: str, toolkit: str, out_dir: Path) -> Path:
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        raise ValueError(f"no kernel source {src}")
    # the shared headers are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_NVCC_FLAGS).encode()
                            + toolkit.encode()).hexdigest()
    return out_dir / f"lib{name}-{digest[:16]}.so"


def sidecar(library: Path) -> Path:
    """The file beside ``library`` that holds its nvcc report."""
    return library.with_suffix(".ptxas")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all) whose library or sidecar
    is missing, all nvcc processes started together; raises with nvcc's
    output if any fails.  Returns ``BUILD_LOG`` entries for the names."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with _lock:
        toolkit = _toolkit_version(nvcc, out_dir)
    procs = {}
    for name in names:
        target = _target(name, toolkit, out_dir)
        report = sidecar(target)
        if target.exists() and report.exists():
            with _lock:
                if BUILD_LOG.get(name, {}).get("path") != str(target):
                    STATS["hits"] += 1
                    BUILD_LOG[name] = {"seconds": 0.0, "cached": True,
                                       "ptxas": report.read_text(),
                                       "path": str(target)}
            # the sidecar's mtime is the library's last use (sweep's LRU)
            os.utime(report)
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        with _lock:
            STATS["nvcc_runs"] += 1
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        # the sidecar first: whoever sees the library sees its report
        _write_atomic(sidecar(target), text.encode())
        os.replace(tmp, target)
        with _lock:
            STATS["misses"] += 1
            BUILD_LOG[name] = {"seconds": seconds, "cached": False,
                               "ptxas": text, "path": str(target)}
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: BUILD_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(BUILD_LOG[name]["path"])
        _LIBS[name] = lib
    return lib

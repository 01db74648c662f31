"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with nvcc
(with the shared ``csrc/*.cuh`` headers) into its own shared library,
loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built when the
package is imported: ``load`` builds at a kernel's first CUDA launch, and
``build`` compiles several sources at once, one nvcc process each.  The
build directory is ``build/kernels`` beside the package, or
``$PADDLE_TPU_TORCH_BUILD_DIR``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build", "load", "BUILD_LOG"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

SOURCES = tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))

# name -> {"seconds": wall time of the nvcc run (0.0 if reused),
#          "ptxas": nvcc's register/shared-memory report, "path": library}
BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


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


def _target(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    if not src.exists():
        raise ValueError(f"no kernel source {src}")
    # the shared headers are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all) whose library is missing,
    all nvcc processes started together; raises with nvcc's output if any
    fails.  Returns ``BUILD_LOG`` entries for the names."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "",
                                        "path": str(target)})
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
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
        os.replace(tmp, target)
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": text,
                           "path": str(target)}
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

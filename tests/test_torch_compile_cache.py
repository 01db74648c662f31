"""The persistent half of the port's ``jit/compile_cache.py`` and the
kernel-library cache under it (``ops/cuda/_build.py``), on the CPU: a
fake ``nvcc`` script under a temporary ``CUDA_HOME`` writes the output
file and a ptxas-like report, so no GPU and no toolkit are needed.
``resolve_cache_dir`` for ``auto``, a path and the reference's disabled
values; a library's nvcc report kept in its sidecar and read back on a
warm start (no nvcc process at all); a missing sidecar and another
toolkit each rebuild; a second process with the same directory builds
nothing; ``sweep``'s LRU eviction (a library with its report), as the
reference's ``test_sweep_evicts_least_recently_used``; ``cache_stats``;
``FLAGS_compile_cache_min_compile_secs`` keeps refusing other values."""

import json
import os
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest

from paddle_tpu_torch import flags
from paddle_tpu_torch.jit import compile_cache as cc
from paddle_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if sys.argv[1] == "--version":
    print("nvcc: fake CUDA compiler, release {version}")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"\\x7fELF fake library " + sys.argv[-1].encode())
print("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'")
print("ptxas info    : Used 42 registers, 8 bytes spill stores")
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """A CUDA_HOME whose nvcc is FAKE_NVCC, a fresh cache directory, and
    ``_build``'s per-process state emptied (as in a new process)."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"

    def install(version):
        nvcc = home / "bin" / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                         version=version))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        # another toolkit: another binary (size and mtime)
        os.utime(nvcc, ns=(time.time_ns(), time.time_ns() + len(version)))

    install("12.8")
    monkeypatch.setenv("CUDA_HOME", str(home))
    new_process(monkeypatch)
    cache = tmp_path / "cache"
    flags.set_flags({"compile_cache_dir": str(cache)})
    yield cache, log, install
    flags.set_flags({"compile_cache_dir": "auto"})


def new_process(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "STATS",
                        {"hits": 0, "misses": 0, "nvcc_runs": 0})
    monkeypatch.setattr(_build, "_toolkit", {})


def runs(log):
    return log.read_text().splitlines() if log.exists() else []


def test_resolve_cache_dir_auto_path_and_off(tmp_path):
    assert flags.get_flags("compile_cache_dir") == "auto"
    assert cc.resolve_cache_dir() == str(ROOT / "build" / "kernels")
    try:
        flags.set_flags({"compile_cache_dir": str(tmp_path / "k")})
        assert cc.resolve_cache_dir() == str(tmp_path / "k")
        assert cc.ensure_initialized() == str(tmp_path / "k")
        assert (tmp_path / "k").is_dir()
        assert _build.build_dir() == tmp_path / "k"
        dirs = set()
        for off in ("off", "none", "", "0", "false", "disabled"):
            flags.set_flags({"compile_cache_dir": off})
            dirs.add(cc.resolve_cache_dir())
        # one fresh temporary directory for this process
        (tmp,) = dirs
        assert Path(tmp).is_dir() and not tmp.startswith(str(ROOT))
        other = subprocess.run(
            [sys.executable, "-c",
             "from paddle_tpu_torch.jit import compile_cache as cc;"
             "print(cc.resolve_cache_dir())"],
            env=dict(os.environ, PYTHONPATH=str(ROOT),
                     FLAGS_compile_cache_dir="off"),
            capture_output=True, text=True, timeout=120, check=True)
        assert other.stdout.strip() not in ("", tmp)
    finally:
        flags.set_flags({"compile_cache_dir": "auto"})
    assert _build.build_dir() == ROOT / "build" / "kernels"


def test_report_kept_beside_the_library_and_read_on_a_warm_start(
        fake_toolkit, monkeypatch):
    cache, log, _ = fake_toolkit
    cold = _build.build(["fused_update"])["fused_update"]
    lib = Path(cold["path"])
    assert not cold["cached"] and lib.parent == cache
    assert "Used 42 registers, 8 bytes spill stores" in cold["ptxas"]
    assert _build.sidecar(lib).read_text() == cold["ptxas"]
    assert len(runs(log)) == 2                  # --version, the compile
    assert _build.STATS == {"hits": 0, "misses": 1, "nvcc_runs": 2}
    assert not list(cache.glob("*.tmp"))
    new_process(monkeypatch)
    warm = _build.build(["fused_update"])["fused_update"]
    assert warm["cached"] and warm["path"] == cold["path"]
    assert warm["ptxas"] == cold["ptxas"]
    assert len(runs(log)) == 2, "a warm start runs no nvcc"
    assert _build.STATS == {"hits": 1, "misses": 0, "nvcc_runs": 0}
    stats = cc.cache_stats()
    assert stats["dir"] == str(cache)
    assert (stats["hits"], stats["misses"], stats["requests"]) == (1, 0, 1)
    assert stats["bytes"] == lib.stat().st_size + \
        _build.sidecar(lib).stat().st_size


def test_missing_sidecar_or_another_toolkit_rebuilds(fake_toolkit,
                                                     monkeypatch):
    cache, log, install = fake_toolkit
    first = Path(_build.build(["rpa_decode"])["rpa_decode"]["path"])
    _build.sidecar(first).unlink()
    new_process(monkeypatch)
    again = _build.build(["rpa_decode"])["rpa_decode"]
    assert not again["cached"] and again["path"] == str(first)
    assert _build.sidecar(first).exists()
    assert len([r for r in runs(log) if "-o" in r]) == 2
    install("13.0")
    new_process(monkeypatch)
    other = _build.build(["rpa_decode"])["rpa_decode"]
    assert not other["cached"] and other["path"] != str(first)
    assert len(list(cache.glob("librpa_decode-*.so"))) == 2
    assert len(list(cache.glob("nvcc-*.version"))) == 2


def test_a_second_process_builds_nothing(fake_toolkit):
    cache, log, _ = fake_toolkit
    _build.build()
    built = len(runs(log))
    assert built == len(_build.SOURCES) + 1
    child = subprocess.run(
        [sys.executable, "-c",
         "import json; from paddle_tpu_torch.ops.cuda import _build;"
         "from paddle_tpu_torch.jit import compile_cache as cc;"
         "logs = _build.build();"
         "print(json.dumps([cc.cache_stats(), _build.STATS,"
         " {n: e['ptxas'] for n, e in logs.items()}]))"],
        env=dict(os.environ, PYTHONPATH=str(ROOT),
                 FLAGS_compile_cache_dir=str(cache)),
        capture_output=True, text=True, timeout=120, check=True)
    stats, counts, reports = json.loads(child.stdout.strip().splitlines()[-1])
    assert stats["hits"] == len(_build.SOURCES) and stats["misses"] == 0
    assert counts["nvcc_runs"] == 0 and len(runs(log)) == built
    assert reports == {n: _build.BUILD_LOG[n]["ptxas"]
                       for n in _build.SOURCES}


def test_sweep_evicts_least_recently_used(tmp_path):
    d = tmp_path / "cache"
    d.mkdir()
    now = time.time()
    for i, (name, age) in enumerate([("old", 300), ("mid", 200),
                                     ("new", 100)]):
        lib = d / f"lib{name}-deadbeef{i}.so"
        lib.write_bytes(b"x" * 900)
        report = d / f"lib{name}-deadbeef{i}.ptxas"
        report.write_bytes(b"r" * 100)
        os.utime(lib, (now - age, now - age))
        os.utime(report, (now - age, now - age))
    # a hit touches the report: "old" was used last
    os.utime(d / "libold-deadbeef0.ptxas", (now, now))
    (d / "nvcc-0123.version").write_text("nvcc")
    try:
        flags.set_flags({"compile_cache_dir": str(d)})
        assert cc.sweep(max_bytes=0) == []
        evicted = cc.sweep(max_bytes=2000)
        assert evicted == [str(d / "libmid-deadbeef1.so")]
        assert not (d / "libmid-deadbeef1.ptxas").exists()
        left = sorted(p.name for p in d.iterdir())
        assert left == ["libnew-deadbeef2.ptxas", "libnew-deadbeef2.so",
                        "libold-deadbeef0.ptxas", "libold-deadbeef0.so",
                        "nvcc-0123.version"]
        stats = cc.cache_stats()
        assert stats["dir"] == str(d) and stats["bytes"] == 2000
        assert cc.sweep(max_bytes=1000, cache_dir=str(d)) == \
            [str(d / "libnew-deadbeef2.so")]
    finally:
        flags.set_flags({"compile_cache_dir": "auto"})


def test_unwritable_directory_falls_back_to_a_temporary_one(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.warns(UserWarning, match="not writable"):
        d = cc.initialize(str(blocker / "cache"))
    try:
        assert Path(d).is_dir() and d != str(blocker / "cache")
    finally:
        cc.initialize()


def test_min_compile_secs_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="compile-time threshold"):
        flags.set_flags({"compile_cache_min_compile_secs": 0.0})
    assert flags.get_flags("compile_cache_min_compile_secs") == 1.0

"""Named-failpoint fault-injection registry (counterpart of
``paddle_tpu/utils/failpoint.py``, a copy of its stdlib-only code: same
spec grammar, modes, determinism and ``FLAGS_fault_injection`` arming).
The port fires ``serving.step`` in ``ServingEngine.step``; the other
names of :data:`REGISTERED` belong to modules not ported yet.  A fire is
not flight-recorded until the port has its telemetry (ROADMAP A5).

The host-side runtime (TCPStore rendezvous, RPC, checkpoint IO, dataloader
workers, elastic heartbeat) carries recovery paths that production traffic
exercises only when infrastructure actually fails.  This module makes those
failures *provokable* and *deterministic*: code marks interesting sites with
a named failpoint, and a single spec string (``FLAGS_fault_injection`` /
the env var of the same name) arms any subset of them.

Spec syntax — points separated by ``;``, options per point by ``,``::

    <name>=<mode>[,p=<prob>][,arg=<float>][,n=<max_fires>][;<name>=...]

Modes
    ``error``      raise :class:`FailpointError` at the site
    ``delay``      sleep ``arg`` seconds (default 0.05), then continue
    ``hang_once``  sleep ``arg`` seconds (default 30) on the FIRST fire
                   only — models a wedged peer that later recovers
    ``corrupt``    return the string ``"corrupt"`` to the site, which then
                   damages its own payload (sites that have no payload
                   treat it as a no-op)

Examples::

    FLAGS_fault_injection="store.client.req=error,p=0.1"
    FLAGS_fault_injection="rpc.server.handle=hang_once,arg=0.5;ckpt.shard.write=corrupt"

Zero-overhead contract: when nothing is armed the module attribute
:data:`ACTIVE` is ``None``, and every instrumented site guards itself with
``if _fp.ACTIVE: _fp.inject("name")`` — a single module-dict lookup per
call on the hot path, no function call, no string hashing.

Determinism: each armed point draws from its own ``random.Random`` seeded
from the framework seed (``paddle.seed`` via ``core.random_state`` when
that module is already loaded; the ``FLAGS_fault_injection_seed`` env var
otherwise — e.g. in worker subprocesses) XOR'd with a CRC of the point name.  Re-running a job with the same
seed and spec injects the same faults at the same call ordinals.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import zlib
from random import Random
from typing import Dict, Optional

__all__ = [
    "FailpointError",
    "FailpointSpec",
    "ACTIVE",
    "configure",
    "disable",
    "failpoints",
    "get",
    "inject",
    "stats",
    "REGISTERED",
]

# The failpoint vocabulary: every name fired via ``inject(...)`` anywhere
# in the reference must appear here, and every entry must be fired by some
# site and exercised by at least one chaos test — all three directions
# are enforced statically by the registry-consistency checker
# (``python -m tools.pt_lint``), which reads this LITERAL dict with
# ``ast.literal_eval`` (never an import), mirroring
# telemetry/names.py REGISTERED.  Arming an unknown name via the spec
# string stays permitted at runtime: that is how a chaos test discovers
# a missing site.
REGISTERED = {
    "ckpt.shard.read": "checkpoint shard read (load_state_dict)",
    "ckpt.shard.write": "checkpoint shard write (save_state_dict)",
    "comm.quant": "quantized-collective encode/decode path",
    "dataloader.worker": "dataloader worker-loop body (io/worker.py)",
    "device.step.oom": "captured-train-step device OOM (jit/api.py)",
    "elastic.heartbeat": "elastic agent heartbeat to the store",
    "elastic.step": "elastic training-loop step body",
    "quant.dequant": "host int8 block dequantize (quantize/core.py)",
    "rpc.call": "client-side RPC invocation",
    "rpc.server.handle": "server-side RPC dispatch",
    "serving.admit": "serving admission-control decision point",
    "serving.migration.corrupt": "KV-block migration payload integrity",
    "serving.prefix_evict": "serving prefix-cache block eviction",
    "serving.step": "serving engine decode-step body",
    "store.client.req": "TCPStore client request round-trip",
    "store.server.serve": "TCPStore server accept/serve loop",
}


class FailpointError(ConnectionError):
    """Error raised by an armed ``error``-mode failpoint.

    Subclasses :class:`ConnectionError` (hence :class:`OSError`) so the
    injected fault travels the same ``except``/retry paths a real
    infrastructure failure would — no production code special-cases it.
    """


def _base_seed() -> int:
    """Framework seed without forcing an import of the random state.

    ``core.random_state`` is consulted only when some other code already
    imported it; subprocess workers fall back to the
    ``FLAGS_fault_injection_seed`` env var so parent and child agree.
    """
    rs = sys.modules.get("paddle_tpu_torch.core.random_state")
    if rs is not None and hasattr(rs, "current_seed"):
        try:
            return int(rs.current_seed())
        except Exception:  # noqa: BLE001 — seed source is best-effort
            pass
    try:
        return int(os.environ.get("FLAGS_fault_injection_seed", "0"))
    except ValueError:
        return 0


_MODES = ("error", "delay", "hang_once", "corrupt")


class FailpointSpec:
    """One armed failpoint: mode + probability + fire budget + RNG."""

    __slots__ = ("name", "mode", "prob", "arg", "max_fires",
                 "evaluated", "fired", "_rng", "_lock")

    def __init__(self, name: str, mode: str, prob: float = 1.0,
                 arg: Optional[float] = None,
                 max_fires: Optional[int] = None) -> None:
        if mode not in _MODES:
            raise ValueError(
                f"failpoint '{name}': unknown mode {mode!r} "
                f"(expected one of {_MODES})")
        self.name = name
        self.mode = mode
        self.prob = float(prob)
        self.arg = arg
        if mode == "hang_once" and max_fires is None:
            max_fires = 1
        self.max_fires = max_fires
        self.evaluated = 0
        self.fired = 0
        self._rng = Random(_base_seed() ^ zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def fire(self) -> Optional[str]:
        """Evaluate this point once; return the mode fired or ``None``.

        ``error`` raises instead of returning; ``delay``/``hang_once``
        sleep before returning their mode name.
        """
        with self._lock:
            self.evaluated += 1
            if self.max_fires is not None and self.fired >= self.max_fires:
                return None
            if self.prob < 1.0 and self._rng.random() >= self.prob:
                return None
            self.fired += 1
        _record_fire(self)
        if self.mode == "error":
            raise FailpointError(
                f"failpoint '{self.name}' injected a fault "
                f"(fire #{self.fired})")
        if self.mode == "delay":
            time.sleep(self.arg if self.arg is not None else 0.05)
        elif self.mode == "hang_once":
            time.sleep(self.arg if self.arg is not None else 30.0)
        return self.mode


def _record_fire(spec: "FailpointSpec") -> None:
    """Where the reference flight-records a fire and counts it
    (``failpoint.fires_total``); the port's telemetry is ROADMAP A5."""


# None when fault injection is disabled (the common case); a dict of
# name -> FailpointSpec when armed.  Sites read this ATTRIBUTE as their
# fast-path guard: ``if _fp.ACTIVE: _fp.inject("point")``.
ACTIVE: Optional[Dict[str, FailpointSpec]] = None

_config_lock = threading.Lock()
_current_spec: str = ""


def _parse(spec: str) -> Dict[str, FailpointSpec]:
    points: Dict[str, FailpointSpec] = {}
    for chunk in spec.replace("\n", ";").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        head, _, opts = chunk.partition(",")
        name, sep, mode = head.partition("=")
        if not sep or not name.strip() or not mode.strip():
            raise ValueError(
                f"bad failpoint clause {chunk!r} "
                f"(expected '<name>=<mode>[,p=..][,arg=..][,n=..]')")
        kwargs: Dict[str, object] = {}
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            k, sep, v = opt.partition("=")
            if not sep:
                raise ValueError(f"bad failpoint option {opt!r} in {chunk!r}")
            k = k.strip()
            if k == "p":
                kwargs["prob"] = float(v)
            elif k == "arg":
                kwargs["arg"] = float(v)
            elif k == "n":
                kwargs["max_fires"] = int(v)
            else:
                raise ValueError(
                    f"unknown failpoint option {k!r} in {chunk!r}")
        name = name.strip()
        points[name] = FailpointSpec(name, mode.strip(), **kwargs)
    return points


def configure(spec: Optional[str]) -> None:
    """Arm the failpoints described by ``spec`` (None/"" disarms all).

    Also mirrors the value into ``FLAGS_fault_injection`` when the flag
    registry is importable, so ``get_flags`` reflects reality.
    """
    global ACTIVE, _current_spec
    with _config_lock:
        if not spec:
            ACTIVE = None
            _current_spec = ""
        else:
            ACTIVE = _parse(spec)
            _current_spec = spec
    try:
        from ..flags import set_flags
        set_flags({"fault_injection": spec or ""})
    except Exception:  # noqa: BLE001 — flags registry may not be loaded
        pass


def disable() -> None:
    configure(None)


def active_spec() -> str:
    return _current_spec


def get(name: str) -> Optional[FailpointSpec]:
    active = ACTIVE
    return active.get(name) if active else None


def inject(name: str) -> Optional[str]:
    """Evaluate failpoint ``name``; returns the fired mode (or ``None``).

    Callers guard with ``if _fp.ACTIVE:`` first so this function is never
    reached when fault injection is off.
    """
    active = ACTIVE
    if not active:
        return None
    spec = active.get(name)
    if spec is None:
        return None
    return spec.fire()


def stats() -> Dict[str, Dict[str, int]]:
    """Per-point evaluation/fire counters (for tests and diagnostics)."""
    active = ACTIVE
    if not active:
        return {}
    return {n: {"evaluated": s.evaluated, "fired": s.fired}
            for n, s in active.items()}


class failpoints:
    """Context manager arming a spec and restoring the previous one.

    >>> with failpoints("store.client.req=error,p=0.1"):
    ...     flaky_path()
    """

    def __init__(self, spec: Optional[str]) -> None:
        self._spec = spec
        self._prev: str = ""

    def __enter__(self) -> "failpoints":
        self._prev = active_spec()
        configure(self._spec)
        return self

    def __exit__(self, *exc) -> bool:
        configure(self._prev or None)
        return False


def corrupt_bytes(data: bytes, rng: Optional[Random] = None) -> bytes:
    """Flip one byte of ``data`` (helper for ``corrupt``-mode sites)."""
    if not data:
        return data
    rng = rng or Random(_base_seed())
    i = rng.randrange(len(data))
    out = bytearray(data)
    out[i] ^= 0xFF
    return bytes(out)


# Arm from the environment at import time so subprocesses (dataloader
# workers, launch children) inherit the parent's fault plan without any
# plumbing — FLAGS_fault_injection travels through os.environ.  A typo'd
# spec must not make `import paddle_tpu_torch` impossible: warn and stay
# disarmed instead of raising.
_env_spec = os.environ.get("FLAGS_fault_injection", "")
if _env_spec:
    try:
        configure(_env_spec)
    except ValueError as _e:
        import logging as _logging
        _logging.getLogger("paddle_tpu_torch.failpoint").warning(
            "ignoring malformed FLAGS_fault_injection=%r: %s",
            _env_spec, _e)

# `paddle.set_flags({"fault_injection": ...})` must arm/disarm points
# just like the env var: hook the registry.  configure() itself mirrors
# into the flag, so the hook skips already-applied values (no recursion).
try:
    from ..flags import on_flag_set as _on_flag_set

    def _flag_hook(value: str) -> None:
        if value == _current_spec:
            return
        try:
            configure(value or None)
        except ValueError as e:
            # keep flag and armed state consistent: roll the flag back to
            # the last good spec instead of reporting a spec that never
            # armed (the rollback re-enters this hook and no-ops)
            import logging as _logging
            _logging.getLogger("paddle_tpu_torch.failpoint").warning(
                "ignoring malformed fault_injection flag %r: %s", value, e)
            from ..flags import set_flags as _set_flags
            _set_flags({"fault_injection": _current_spec})

    _on_flag_set("fault_injection", _flag_hook)
except Exception:  # noqa: BLE001 — flags registry unavailable mid-import
    pass

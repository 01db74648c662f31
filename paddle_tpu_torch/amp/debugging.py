"""Numerical debugging (counterpart of ``paddle_tpu/amp/debugging.py``):
``check_numerics``, operator stats collection and the tensor checker.

The reference runs these over its numerics monitor
(``paddle_tpu/telemetry/numerics.py``), which the port does not have yet.
The port keeps the part these functions need here: a monitor armed by
``FLAGS_check_numerics`` ("off", "stats", "full") that the op registry's
``apply`` calls after every op (``ops/op.py`` ``NUMERICS_HOOK``; disarmed,
one attribute check a call).

* "stats": the first floating output of each op call is probed on the
  device (absmax and rms over its finite values, NaN and Inf counts), the
  probes summed a name at a time without a host read; :func:`operator_stats`
  reads them, as ``{op: {absmax, rms, nan, inf, first, first_bad}}``
  (``first``: the op's first call's index in the window; ``first_bad``:
  its first call with a non-finite output, else 2^30).
* "full": every op output is checked on the host, and the first op that
  turns finite inputs into a non-finite output raises
  :class:`NonFiniteError` naming it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..flags import get_flags, on_flag_set, set_flags
from ..ops import op as _op

__all__ = ["check_numerics", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "operator_stats", "DebugMode", "TensorCheckerConfig",
           "enable_tensor_checker", "disable_tensor_checker",
           "NonFiniteError", "tensor_stats"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class NonFiniteError(FloatingPointError):
    """The first op whose output went non-finite: ``op``, ``where``
    ("forward") and ``stats`` (the output's and the float inputs')."""

    def __init__(self, msg: str, op: str = "?", where: str = "forward",
                 stats: Optional[dict] = None) -> None:
        super().__init__(msg)
        self.op = op
        self.where = where
        self.stats = stats or {}


def _probe(x: torch.Tensor):
    """(absmax, rms, nan count, inf count) of ``x`` (in float32) as 0-dim
    device tensors; absmax and rms over the finite values only."""
    xf = x.detach().float()
    nan = torch.isnan(xf).sum(dtype=torch.int32)
    inf = torch.isinf(xf).sum(dtype=torch.int32)
    finite = torch.where(torch.isfinite(xf), xf, 0.0).abs()
    if xf.numel() == 0:
        zero = torch.zeros((), device=xf.device)
        return zero, zero, nan, inf
    return finite.max(), finite.square().mean().sqrt(), nan, inf


def tensor_stats(tensor) -> Dict:
    """Host view of one tensor's stats (reads the device)."""
    t = torch.as_tensor(tensor)
    absmax, rms, nan, inf = _probe(t)
    return {"absmax": float(absmax), "rms": float(rms), "nan": int(nan),
            "inf": int(inf), "numel": t.numel(), "dtype": str(t.dtype),
            "shape": list(t.shape)}


def _first_float(out):
    for o in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            return o
    return None


# first_bad of an op whose outputs stayed finite
_NO_BAD = 1 << 30


class _Monitor:
    """One armed session: ``mode`` "stats" or "full"."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self._calls = 0
        # name -> [first call, absmax, rms, nan, inf, first bad call]
        # (device scalars but the first)
        self._pending: Dict[str, list] = {}
        self.op_stats: Dict[str, dict] = {}

    def begin_sample_window(self) -> None:
        self._calls = 0
        self._pending = {}

    def on_op(self, name: str, args, out) -> None:
        o = _first_float(out)
        if o is not None:
            if self.mode == "full":
                self._check_now(name, args, o)
            absmax, rms, nan, inf = _probe(o)
            bad = torch.where(nan + inf > 0, self._calls, _NO_BAD)
            ent = self._pending.get(name)
            if ent is None:
                self._pending[name] = [self._calls, absmax, rms, nan, inf,
                                       bad]
            else:
                ent[1] = torch.maximum(ent[1], absmax)
                ent[2] = rms
                ent[3] = ent[3] + nan
                ent[4] = ent[4] + inf
                ent[5] = torch.minimum(ent[5], bad)
        self._calls += 1

    def _check_now(self, name: str, args, out: torch.Tensor) -> None:
        if bool(torch.isfinite(out).all()):
            return
        inputs = [{"arg": i, **tensor_stats(a)} for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a.is_floating_point()]
        if any(i["nan"] or i["inf"] for i in inputs):
            return      # the poison came from upstream
        st = tensor_stats(out)
        raise NonFiniteError(
            f"numerics check failed: op {name} produced {st['nan']} NaN, "
            f"{st['inf']} Inf from finite inputs", op=name,
            stats={"output": st, "inputs": inputs})

    def publish(self) -> Dict[str, dict]:
        """Read the window's probes on the host (the only read)."""
        table = {}
        for name, (first, absmax, rms, nan, inf, bad) in \
                self._pending.items():
            table[name] = {"first": first, "absmax": float(absmax),
                           "rms": float(rms), "nan": int(nan),
                           "inf": int(inf), "first_bad": int(bad)}
        self.op_stats = table
        return dict(table)


# the armed monitor, or None
ACTIVE: Optional[_Monitor] = None


def _on_check_numerics(value: str) -> None:
    """``FLAGS_check_numerics``: "off" disarms; "stats"/"full" arm, or
    retune the running session in place."""
    global ACTIVE
    if value not in ("off", "stats", "full"):
        raise ValueError(f"check_numerics must be off, stats or full, not "
                         f"{value!r}")
    if value == "off":
        ACTIVE = None
        _op.NUMERICS_HOOK = None
    elif ACTIVE is None:
        ACTIVE = _Monitor(value)
        _op.NUMERICS_HOOK = ACTIVE.on_op
    else:
        ACTIVE.mode = value


on_flag_set("check_numerics", _on_check_numerics)
if get_flags("check_numerics") != "off":
    _on_check_numerics(get_flags("check_numerics"))


def mode() -> str:
    return "off" if ACTIVE is None else ACTIVE.mode


class TensorCheckerConfig:
    """``enable`` and ``debug_mode`` map onto ``FLAGS_check_numerics``
    ("full" for the abort modes, "stats" otherwise); ``output_dir`` sets
    ``FLAGS_numerics_dump_dir``."""

    def __init__(self, enable: bool = True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None, **kwargs) -> None:
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


def check_numerics(tensor: torch.Tensor, op_type: str = "",
                   var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Check one tensor now: (nan count, inf count) as int32 tensors;
    raises :class:`NonFiniteError` under the abort mode."""
    st = tensor_stats(tensor)
    n_nan, n_inf = st["nan"], st["inf"]
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise NonFiniteError(
            f"numerics check failed for op={op_type} var={var_name}: "
            f"{n_nan} NaN, {n_inf} Inf "
            f"(absmax {st['absmax']:.6g}, rms {st['rms']:.6g})",
            op=op_type or "check_numerics", stats=st)
    dev = torch.as_tensor(tensor).device
    return (torch.tensor(n_nan, dtype=torch.int32, device=dev),
            torch.tensor(n_inf, dtype=torch.int32, device=dev))


# did enable_operator_stats_collection arm the monitor itself?  The paired
# disable disarms exactly what enable armed, never a monitor the user armed
_armed_by_collection = False


def enable_operator_stats_collection() -> None:
    global _armed_by_collection
    set_flags({"low_precision_op_list": True})
    if ACTIVE is None:
        set_flags({"check_numerics": "stats"})
        _armed_by_collection = True
    ACTIVE.begin_sample_window()


def disable_operator_stats_collection() -> None:
    global _armed_by_collection
    set_flags({"low_precision_op_list": False})
    if _armed_by_collection:
        set_flags({"check_numerics": "off"})
        _armed_by_collection = False


def operator_stats() -> Dict[str, dict]:
    """The armed monitor's per-op table ({} when disarmed)."""
    return ACTIVE.publish() if ACTIVE is not None else {}


class collect_operator_stats:
    """``with collect_operator_stats() as c: ...``: stats mode for the
    scope; ``c.stats()`` reads the table (after the scope: the table read
    at its exit)."""

    def __init__(self) -> None:
        self._snapshot: Dict[str, dict] = {}
        self._open = False

    def __enter__(self):
        enable_operator_stats_collection()
        self._open = True
        return self

    def stats(self) -> Dict[str, dict]:
        if not self._open:
            return dict(self._snapshot)
        return operator_stats()

    def __exit__(self, *exc):
        self._snapshot = self.stats()
        self._open = False
        disable_operator_stats_collection()
        return False


# the check_numerics mode active when enable_tensor_checker armed:
# disable restores it
_prev_checker_mode: Optional[str] = None


def enable_tensor_checker(checker_config: Optional[TensorCheckerConfig]
                          = None) -> None:
    """Arm the per-op checker: "full" for the abort modes (the first
    offending op raises), "stats" for the collecting ones."""
    global _prev_checker_mode
    cfg = checker_config or TensorCheckerConfig()
    if not cfg.enable:
        disable_tensor_checker()
        return
    if cfg.output_dir:
        set_flags({"numerics_dump_dir": cfg.output_dir})
    full = cfg.debug_mode in (DebugMode.CHECK_NAN_INF_AND_ABORT,
                              DebugMode.CHECK_ALL_FOR_OVERFLOW)
    if _prev_checker_mode is None:
        _prev_checker_mode = mode()
    set_flags({"check_nan_inf": True,
               "check_numerics": "full" if full else "stats"})


def disable_tensor_checker() -> None:
    global _prev_checker_mode
    if _prev_checker_mode is None:
        set_flags({"check_nan_inf": False})
        return
    prev = _prev_checker_mode
    _prev_checker_mode = None
    set_flags({"check_nan_inf": False, "check_numerics": prev})

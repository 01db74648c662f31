"""AMP: auto_cast and GradScaler (counterpart of
``paddle_tpu/amp/__init__.py``).

Autocast casts where the reference's does and nowhere else: at the call
sites of :func:`maybe_autocast_arrays`, the white-list ops ``linear``
(``nn/functional/common.py``) and ``matmul`` (``tensor/linalg.py``); a
float32 input there is cast to the guard's dtype.  ``torch.autocast`` is
not used: it casts another set of ops than the reference's lists.  The
lists, the reference's op-name aliases and the custom lists scoped to
their guard are the reference's.

``decorate(level="O2")`` casts every float32 parameter to the given dtype
in place (the ``Parameter`` objects stay, so an optimizer built before
keeps them).

``GradScaler`` is dynamic loss scaling with no host sync in a step: the
scale, the good and bad counters and ``found_inf`` are 0-dim tensors on
the parameters' device, and every transition is computed there.  The
unscale-and-check pass (an XLA fusion in the reference, not a TPU kernel)
is torch's multi-tensor unscale, one launch a dtype group, in place (the
optimizer's update table holds the grads' addresses): ``g = (float(g) *
(1 / scale))`` rounded to g's dtype, ``found_inf`` = 1 where any element
of any grad was not finite.  ``step`` hands ``found_inf`` to the
optimizer as its ``_skip_mask``: the fused update kernel then leaves the
parameters, the moments and the step counter as they were.  Host values
are read only when asked (``state_dict``, ``get_init_loss_scaling``).
The reference's ``update`` also feeds its numerics telemetry, which the
port does not have yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ..core.dtype import to_torch_dtype
from . import debugging  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "is_float16_supported", "is_bfloat16_supported",
           "white_list", "black_list", "debugging"]

# O1 default lists (the reference's subset of Paddle's amp_lists.py);
# custom additions are scoped to the guard that supplied them, and these
# sets are never changed
white_list = frozenset({
    "matmul", "matmul_v2", "linear", "conv2d", "conv1d", "conv3d",
    "einsum", "bmm", "mm", "attention"})
black_list = frozenset({
    "softmax", "log_softmax", "layer_norm", "batch_norm", "exp",
    "log", "mean", "sum", "softmax_with_cross_entropy",
    "cross_entropy", "rms_norm"})

# Paddle op-type aliases → the names the call sites pass, so that a custom
# list's 'matmul_v2' reaches the 'matmul' call site
_OP_ALIASES = {"matmul_v2": "matmul", "mm": "matmul", "bmm": "matmul",
               "mul": "matmul"}


def _canon_ops(names) -> frozenset:
    return frozenset(_OP_ALIASES.get(n, n) for n in names)


_state = threading.local()


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "custom_white", "custom_black")

    def __init__(self, enabled=False, dtype="float16", level="O1") -> None:
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.custom_white = frozenset()
        self.custom_black = frozenset()


def amp_state() -> _AmpState:
    s = getattr(_state, "amp", None)
    if s is None:
        s = _AmpState()
        _state.amp = s
    return s


class amp_guard:
    """Context manager enabling autocast.  Custom white/black lists hold
    for the guard's extent only; nesting unions them with the outer
    guard's, and ``__exit__`` restores the previous lists exactly."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="float16",
                 use_promote=True) -> None:
        self._enable = enable
        self._level = level
        self._dtype = dtype
        self._cw = _canon_ops(custom_white_list or ())
        self._cb = _canon_ops(custom_black_list or ())
        overlap = self._cw & self._cb
        if overlap:
            raise ValueError(
                f"custom_white_list and custom_black_list overlap: "
                f"{sorted(overlap)}")

    def __enter__(self):
        s = amp_state()
        self._prev = (s.enabled, s.dtype, s.level, s.custom_white,
                      s.custom_black)
        s.enabled = self._enable
        s.dtype = self._dtype
        s.level = self._level
        s.custom_white = (s.custom_white | self._cw) - self._cb
        s.custom_black = (s.custom_black | self._cb) - self._cw
        return self

    def __exit__(self, *exc):
        s = amp_state()
        (s.enabled, s.dtype, s.level, s.custom_white,
         s.custom_black) = self._prev
        return False


auto_cast = amp_guard


def maybe_autocast_arrays(*tensors, op: Optional[str] = None):
    """Called by the white-list ops: float32 inputs cast to the guard's
    dtype.  ``op`` names the caller, so that a custom_black_list entry
    vetoes the cast (and a custom_white_list entry forces it)."""
    s = getattr(_state, "amp", None)
    if s is None or not s.enabled:
        return tensors
    if op is not None:
        if op in s.custom_black or (op in black_list
                                    and op not in s.custom_white):
            return tensors
    dt = to_torch_dtype(s.dtype)
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="float16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: every float32 parameter of ``models`` cast to ``dtype`` in
    place (its ``Parameter`` object kept).  O1 changes nothing here."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = to_torch_dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(dt)
            m._casted_by_pure_fp16 = True
    if optimizers is None:
        return models
    return models, optimizers


amp_decorate = decorate


def is_float16_supported(device=None) -> bool:
    return True


def is_bfloat16_supported(device=None) -> bool:
    return True


def _unscale_and_check(grads, scale: torch.Tensor,
                       found: torch.Tensor) -> None:
    """In place: each grad times 1/scale (f32 products rounded to the
    grad's dtype) and ``found`` = 1 where any element was not finite; one
    launch a dtype group."""
    found.zero_()
    inv = torch.reciprocal(scale)
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, inv)


class GradScaler:
    """Dynamic loss scaling (the reference's ``GradScaler``, Paddle's
    AmpScaler).  The device scalars are made on the device of the first
    loss or grads seen; until then the scale is a host number."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True
                 ) -> None:
        self._enable = enable
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._dynamic = use_dynamic_loss_scaling
        # host values until the device scalars exist
        self._host = {"scale": float(init_loss_scaling), "good": 0,
                      "bad": 0}
        self._scale: Optional[torch.Tensor] = None
        self._good_steps: Optional[torch.Tensor] = None
        self._bad_steps: Optional[torch.Tensor] = None
        self._found_inf_arr: Optional[torch.Tensor] = None
        self._unscaled = False

    def _scalars(self, device) -> torch.Tensor:
        """The device scalars (made on ``device`` on first use); returns
        the scale."""
        if self._scale is None:
            h = self._host
            self._scale = torch.tensor(h["scale"], dtype=torch.float32,
                                       device=device)
            self._good_steps = torch.tensor(h["good"], dtype=torch.int32,
                                            device=device)
            self._bad_steps = torch.tensor(h["bad"], dtype=torch.int32,
                                           device=device)
            self._found_inf_arr = torch.zeros((), dtype=torch.float32,
                                              device=device)
        return self._scale

    @property
    def _found_inf(self) -> bool:
        """Host view of the overflow flag (syncs; for tests)."""
        return self._found_inf_arr is not None and \
            bool(self._found_inf_arr != 0)

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        # in var's dtype, so that a 16-bit loss is not promoted to f32
        return var * self._scalars(var.device).to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            if self._found_inf_arr is not None:
                self._found_inf_arr.zero_()
            return
        scale = self._scalars(grads[0].device)
        _unscale_and_check(grads, scale, self._found_inf_arr)
        self._unscaled = True

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        # the update is discarded on the device where found_inf is set
        optimizer._skip_mask = self._found_inf_arr
        try:
            optimizer.step()
        finally:
            optimizer._skip_mask = None
        self._unscaled = False

    @torch.no_grad()
    def update(self) -> None:
        """The reference's ``_scaler_update`` on the device scalars, in
        place."""
        if not self._enable or not self._dynamic or self._scale is None:
            return
        scale, good, bad = self._scale, self._good_steps, self._bad_steps
        found = self._found_inf_arr != 0
        bad2 = torch.where(found, bad + 1, 0).to(torch.int32)
        good2 = torch.where(found, 0, good + 1).to(torch.int32)
        shrink = bad2 >= self._decr_every_n_nan_or_inf
        grow = good2 >= self._incr_every_n_steps
        scale2 = torch.where(
            found & shrink, torch.clamp_min(scale * self._decr_ratio, 1.0),
            torch.where(~found & grow, scale * self._incr_ratio, scale))
        scale.copy_(scale2)
        good.copy_(torch.where(grow, 0, good2))
        bad.copy_(torch.where(shrink, 0, bad2))

    def minimize(self, optimizer, loss) -> None:
        self.step(optimizer)
        self.update()

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_init_loss_scaling(self) -> float:
        return self._host["scale"] if self._scale is None \
            else float(self._scale)

    @torch.no_grad()
    def set_init_loss_scaling(self, v: float) -> None:
        self._host["scale"] = float(v)
        if self._scale is not None:
            self._scale.fill_(float(v))

    def state_dict(self):
        """Host values (the scaler's only host read)."""
        if self._scale is None:
            scale, good, bad = (self._host["scale"], self._host["good"],
                                self._host["bad"])
        else:
            scale, good, bad = (float(self._scale), int(self._good_steps),
                                int(self._bad_steps))
        return {"scale": scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": good, "bad_steps": bad}

    @torch.no_grad()
    def load_state_dict(self, state):
        h = self._host
        h["scale"] = float(state.get("scale", self.get_init_loss_scaling()))
        h["good"] = int(state.get("good_steps", 0))
        h["bad"] = int(state.get("bad_steps", 0))
        if self._scale is not None:
            self._scale.fill_(h["scale"])
            self._good_steps.fill_(h["good"])
            self._bad_steps.fill_(h["bad"])

    set_state_dict = load_state_dict

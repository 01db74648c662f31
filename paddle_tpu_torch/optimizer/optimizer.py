"""Optimizer base and SGD, Adam, AdamW (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

The reference runs one jitted update over the parameter list and gets new
arrays back; here the update is applied IN PLACE to the parameters and
their moments, by ``ops/cuda/fused_update.py``: one launch of a
hand-written multi-tensor kernel a dtype group for CUDA tensors, its plain
version (a tensor at a time) for CPU tensors.  In-place is where the port
saves the memory that JAX saves by donating buffers: no second copy of the
parameters or the moments exists during a step.  The arithmetic follows
the reference's order (decoupled decay on the parameter before the moment
update, bias correction from the step count) in float32, each output
rounded once.  ``torch.optim`` is not used.

Dynamic loss scaling (``amp.GradScaler``) attaches its overflow flag as
``_skip_mask`` (a 0-dim float32 device tensor) for one ``step()``: the
fused update then leaves every parameter and moment as it was where the
flag is set, and the step count, which Adam's bias correction reads,
becomes a device counter that advances by one only where it is clear, as
the reference's ``jnp.where`` over ``_global_step`` does
(``paddle_tpu/optimizer/optimizer.py:139-148``).  No host sync: the
counter is read on the host only by ``state_dict()``.

Parameter groups (``parameters=[{"params": [...], "learning_rate": 0.1,
"weight_decay": 0.01}, ...]``) take Paddle's per-group options: the
group's ``learning_rate`` multiplies the optimizer's learning rate, and
its ``weight_decay`` replaces the optimizer's (AdamW's decoupled
coefficient, or a regularizer).  The reference accepts groups and applies
neither option (``paddle_tpu/optimizer/optimizer.py:57-62``); without
them a group behaves as the reference's does.  Each group takes its own
launches of the fused update.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..ops.cuda import fused_update as _fu
from ..regularizer import L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]


class Optimizer:
    _STATE_NAMES: List[str] = []  # per-parameter accumulator names

    # dynamic loss scaling's overflow flag (a 0-dim float32 device tensor,
    # nonzero = overflow), set by amp.GradScaler for one step(): that
    # step's update is discarded on the device
    _skip_mask: Optional[torch.Tensor] = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False) -> None:
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters())")
        if isinstance(parameters, dict):
            raise TypeError("parameters cannot be a dict")
        items = list(parameters)
        groups = items if items and isinstance(items[0], dict) else \
            [{"params": items}]
        # torch parameters carry no name: (name, parameter) pairs, as
        # model.named_parameters() gives them, name them for
        # apply_decay_param_fun; a bare parameter's name is ""
        self._param_names: Dict[int, str] = {}
        self._parameter_list = []
        self._param_groups: List[Dict] = []
        self._group_of: Dict[int, int] = {}
        for group in groups:
            if not isinstance(group, dict) or "params" not in group:
                raise TypeError("a parameter group is a dict with a "
                                "'params' list")
            group = dict(group)
            plist = []
            for item in group["params"]:
                if isinstance(item, tuple):
                    pname, item = item
                    self._param_names[id(item)] = pname
                plist.append(item)
                self._group_of[id(item)] = len(self._param_groups)
            group["params"] = plist
            group["learning_rate"] = float(group.get("learning_rate", 1.0))
            self._param_groups.append(group)
            self._parameter_list.extend(plist)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._weight_decay = self._as_regularizer(weight_decay)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        # a host int, or (once a scaler's step has run) the device counter
        # of applied updates, a 0-dim float32 tensor
        self._global_step = 0
        # the fused update's device tables (ops/cuda/fused_update.py), and
        # step()'s learning rate and step number as 0-dim float32 tensors
        # on each device, read by the update from device memory
        self._update_tables: Dict = {}
        self._scalars: Dict[torch.device, tuple] = {}

    @staticmethod
    def _as_regularizer(weight_decay):
        return L2Decay(weight_decay) if isinstance(weight_decay, float) \
            else weight_decay

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

    # -- accumulators -----------------------------------------------------
    def _get_state(self, name: str, p: torch.Tensor) -> torch.Tensor:
        d = self._accumulators[name]
        s = d.get(id(p))
        if s is None:
            s = self._init_state(name, p)
            d[id(p)] = s
        return s

    def _init_state(self, name: str, p: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32 if self._multi_precision else p.dtype
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    # -- the update ---------------------------------------------------------
    def _params_with_grad(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    # the fused kernel's update (fused_update.SGD or .ADAM; set by each
    # optimizer) and its constants; AdamW adds per-tensor decay flags
    _KIND: Optional[int] = None

    def _hyper(self, group: int = 0) -> dict:
        return {}

    def _decay_flags(self, params, group: int = 0) -> List[bool]:
        return [False] * len(params)

    def _update(self, lr, params, grads, states, step, skip=None,
                group: int = 0) -> None:
        """Update ``params`` and ``states`` in place, one fused launch a
        dtype group on the card; ``lr`` and ``step`` as :meth:`_apply`
        passes them, ``skip`` the overflow flag or None, ``group`` the
        parameter group (its decay)."""
        if self._KIND is None:
            raise NotImplementedError(f"{type(self).__name__}._update")
        m1s, m2s = states if states else (None, None)
        _fu.fused_update(self._KIND, params, grads, m1s, m2s,
                         self._decay_flags(params, group), lr, step,
                         cache=self._update_tables, skip=skip,
                         **self._hyper(group))

    def _by_group(self, params, grads=None):
        """(group index, its params, their grads) for each parameter group
        that ``params`` touch, in group order."""
        if len(self._param_groups) == 1:
            return [(0, list(params), grads)]
        index: Dict[int, List[int]] = defaultdict(list)
        for i, p in enumerate(params):
            index[self._group_of.get(id(p), 0)].append(i)
        return [(g, [params[i] for i in idx],
                 None if grads is None else [grads[i] for i in idx])
                for g, idx in sorted(index.items())]

    def _group_lr(self, lr, group: int):
        mult = self._param_groups[group]["learning_rate"]
        return lr if mult == 1.0 else lr * mult

    def _prepare_update(self, params) -> None:
        """Build, before a CUDA-graph capture, the device tables that the
        captured update of ``params`` reads (a capture cannot upload one);
        nothing on the CPU, nor for an optimizer whose own ``_update``
        takes no fused kernel (``_KIND`` None)."""
        if self._KIND is None:
            return
        for group, ps, _ in self._by_group(params):
            states = [[self._get_state(n, p) for p in ps]
                      for n in self._STATE_NAMES]
            m1s, m2s = states if states else (None, None)
            _fu.prepare(self._KIND, ps, m1s, m2s,
                        self._decay_flags(ps, group), self._update_tables)

    def _decoupled_wd(self) -> bool:
        return False

    def _regularizer(self, group: int):
        if "weight_decay" in self._param_groups[group]:
            return self._as_regularizer(
                self._param_groups[group]["weight_decay"])
        return self._weight_decay

    def _prepare_grads(self, params, grads):
        """The clip (over every parameter), then L2/L1 regularization, each
        group's, folded into the grads."""
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        if self._decoupled_wd():
            return grads
        out = {}
        for group, ps, gs in self._by_group(params, grads):
            reg = self._regularizer(group)
            for p, g in zip(ps, gs):
                out[id(p)] = g if reg is None else reg.apply_tensor(p, g)
        return [out[id(p)] for p in params]

    def _apply(self, params, grads, lr, step, skip=None) -> None:
        """Clip, regularize and update ``params`` in place: the body of
        :meth:`step` and of a captured train step.  ``lr`` and ``step`` are
        0-dim float32 tensors on the parameters' device: :meth:`step`
        fills the optimizer's own pair, ``TrainStepCapture`` its pair (a
        Python number would be captured as a constant and every replay
        would reuse it); ``skip`` is the overflow flag (None: apply)."""
        grads = self._prepare_grads(params, grads)
        for group, ps, gs in self._by_group(params, grads):
            states = [[self._get_state(n, p) for p in ps]
                      for n in self._STATE_NAMES]
            self._update(self._group_lr(lr, group), ps, gs, states, step,
                         skip=skip, group=group)

    @torch.no_grad()
    def step(self) -> None:
        params = self._params_with_grad()
        skip = self._skip_mask
        if not params:
            self._global_step += 1
            return
        dev = params[0].device
        pair = self._scalars.get(dev)
        if pair is None:
            pair = tuple(torch.zeros((), dtype=torch.float32, device=dev)
                         for _ in range(2))
            self._scalars[dev] = pair
        lr, step = pair
        lr.fill_(self.get_lr())
        if skip is None and not isinstance(self._global_step, torch.Tensor):
            self._global_step += 1
            step.fill_(self._global_step)
        else:
            # the device counter of applied updates: step += 1 - found_inf
            if step is not self._global_step:
                step.fill_(self._global_step)
                self._global_step = step
            step.add_(1.0 if skip is None else 1.0 - skip)
        self._apply(params, [p.grad for p in params], lr, step, skip)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient.  ``set_to_zero`` is accepted for the API and,
        as in the reference, changes nothing: the next backward writes
        fresh gradients either way."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict ------------------------------------------------------------
    def _state_key_names(self) -> Dict[int, str]:
        """The reference's key stem of each parameter: its name, else
        ``param_<i>`` by its place in the parameter list."""
        return {id(p): (getattr(p, "name", None) or f"param_{i}")
                for i, p in enumerate(self._parameter_list)}

    def state_dict(self) -> Dict:
        """The reference's keys: ``global_step``, ``<param>_<moment>`` for
        each accumulator and ``LR_Scheduler``.  The moments are the live
        tensors; the step is read from the device counter where a scaler
        made one (the only host sync of loss scaling)."""
        out: Dict = {"global_step": int(self._global_step)}
        name_of = self._state_key_names()
        for acc_name, d in self._accumulators.items():
            for pid, t in d.items():
                if pid in name_of:
                    out[f"{name_of[pid]}_{acc_name}"] = t
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state: Dict) -> None:
        """Load a :meth:`state_dict` (tensors or numpy arrays, on any
        device).  A moment that exists is overwritten in place, so the
        update's device tables and a captured step keep their
        addresses."""
        step = state.get("global_step", 0)
        self._global_step = int(step.item() if isinstance(
            step, torch.Tensor) else step)
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        names = self._state_key_names()
        by_name = {names[id(p)]: p for p in self._parameter_list}
        for key, val in state.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            for acc_name in self._STATE_NAMES:
                if not key.endswith(f"_{acc_name}"):
                    continue
                p = by_name.get(key[:-len(acc_name) - 1])
                if p is None:
                    continue
                val = torch.as_tensor(val)
                cur = self._accumulators[acc_name].get(id(p))
                if cur is not None:
                    cur.copy_(val)
                else:
                    self._accumulators[acc_name][id(p)] = val.to(
                        device=p.device,
                        dtype=self._init_state(acc_name, p).dtype,
                        copy=True).contiguous()


class SGD(Optimizer):
    _STATE_NAMES: List[str] = []
    _KIND = _fu.SGD


class Adam(Optimizer):
    _STATE_NAMES = ["moment1", "moment2"]
    _KIND = _fu.ADAM

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None) -> None:
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _hyper(self, group: int = 0) -> dict:
        return dict(beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay: the parameter is multiplied by
    ``1 - lr * coeff`` BEFORE the Adam update (the reference's fused-path
    semantics), where ``apply_decay_param_fun(name)`` says so (every
    parameter without it).  Names come with ``(name, parameter)`` pairs
    (``parameters=model.named_parameters()``); a bare parameter's is "".
    ``lr_ratio`` is accepted and, as in the reference, not applied."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None) -> None:
        Optimizer.__init__(self, learning_rate, parameters, None, grad_clip,
                           name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self) -> bool:
        return True

    def _coeff_of(self, group: int) -> float:
        return float(self._param_groups[group].get("weight_decay",
                                                   self._coeff))

    def _hyper(self, group: int = 0) -> dict:
        return dict(super()._hyper(group), coeff=self._coeff_of(group))

    def _decay_flags(self, params, group: int = 0) -> List[bool]:
        """A flag a parameter, into the fused update's table: decay where
        the group's ``coeff`` is not 0 and ``apply_decay_param_fun(name)``
        says so."""
        fun = self._apply_decay_param_fun
        if self._coeff_of(group) == 0.0:
            return [False] * len(params)
        if fun is None:
            return [True] * len(params)
        names = self._param_names
        return [bool(fun(names.get(id(p), ""))) for p in params]

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

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False) -> None:
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters())")
        if isinstance(parameters, dict):
            raise TypeError("parameters cannot be a dict")
        items = list(parameters)
        if any(isinstance(item, dict) for item in items):
            raise TypeError("parameter groups are not ported yet; pass the "
                            "parameters (or (name, parameter) pairs)")
        # torch parameters carry no name: (name, parameter) pairs, as
        # model.named_parameters() gives them, name them for
        # apply_decay_param_fun; a bare parameter's name is ""
        self._param_names: Dict[int, str] = {}
        self._parameter_list = []
        for item in items:
            if isinstance(item, tuple):
                name, item = item
                self._param_names[id(item)] = name
            self._parameter_list.append(item)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, float):
            self._weight_decay = L2Decay(weight_decay)
        else:
            self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._global_step = 0
        # the fused update's device tables (ops/cuda/fused_update.py), and
        # step()'s learning rate and step number as 0-dim float32 tensors
        # on each device, read by the update from device memory
        self._update_tables: Dict = {}
        self._scalars: Dict[torch.device, tuple] = {}

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

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

    def _hyper(self) -> dict:
        return {}

    def _decay_flags(self, params) -> List[bool]:
        return [False] * len(params)

    def _update(self, lr, params, grads, states, step) -> None:
        """Update ``params`` and ``states`` in place, one fused launch a
        dtype group on the card; ``lr`` and ``step`` as :meth:`_apply`
        passes them."""
        if self._KIND is None:
            raise NotImplementedError(f"{type(self).__name__}._update")
        m1s, m2s = states if states else (None, None)
        _fu.fused_update(self._KIND, params, grads, m1s, m2s,
                         self._decay_flags(params), lr, step,
                         cache=self._update_tables, **self._hyper())

    def _prepare_update(self, params) -> None:
        """Build, before a CUDA-graph capture, the device table that the
        captured update of ``params`` reads (a capture cannot upload one);
        nothing on the CPU, nor for an optimizer whose own ``_update``
        takes no fused kernel (``_KIND`` None)."""
        if self._KIND is None:
            return
        states = [[self._get_state(n, p) for p in params]
                  for n in self._STATE_NAMES]
        m1s, m2s = states if states else (None, None)
        _fu.prepare(self._KIND, params, m1s, m2s, self._decay_flags(params),
                    self._update_tables)

    def _decoupled_wd(self) -> bool:
        return False

    def _prepare_grads(self, params, grads):
        """The clip, then L2/L1 regularization folded into the grads."""
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        if self._weight_decay is not None and not self._decoupled_wd():
            grads = [self._weight_decay.apply_tensor(p, g)
                     for p, g in zip(params, grads)]
        return grads

    def _apply(self, params, grads, lr, step) -> None:
        """Clip, regularize and update ``params`` in place: the body of
        :meth:`step` and of a captured train step.  ``lr`` and ``step`` are
        0-dim float32 tensors on the parameters' device: :meth:`step`
        fills the optimizer's own pair, ``TrainStepCapture`` its pair (a
        Python number would be captured as a constant and every replay
        would reuse it)."""
        grads = self._prepare_grads(params, grads)
        states = [[self._get_state(n, p) for p in params]
                  for n in self._STATE_NAMES]
        self._update(lr, params, grads, states, step)

    @torch.no_grad()
    def step(self) -> None:
        params = self._params_with_grad()
        self._global_step += 1
        if params:
            dev = params[0].device
            pair = self._scalars.get(dev)
            if pair is None:
                pair = tuple(torch.zeros((), dtype=torch.float32,
                                         device=dev) for _ in range(2))
                self._scalars[dev] = pair
            pair[0].fill_(self.get_lr())
            pair[1].fill_(self._global_step)
            self._apply(params, [p.grad for p in params], *pair)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient.  ``set_to_zero`` is accepted for the API and,
        as in the reference, changes nothing: the next backward writes
        fresh gradients either way."""
        for p in self._parameter_list:
            p.grad = None


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

    def _hyper(self) -> dict:
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

    def _hyper(self) -> dict:
        return dict(super()._hyper(), coeff=self._coeff)

    def _decay_flags(self, params) -> List[bool]:
        """A flag a parameter, into the fused update's table: decay where
        ``coeff`` is not 0 and ``apply_decay_param_fun(name)`` says so."""
        fun = self._apply_decay_param_fun
        if self._coeff == 0.0:
            return [False] * len(params)
        if fun is None:
            return [True] * len(params)
        names = self._param_names
        return [bool(fun(names.get(id(p), ""))) for p in params]

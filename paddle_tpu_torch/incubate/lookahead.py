"""LookAhead and ModelAverage optimizer wrappers (counterpart of
``paddle_tpu/incubate/lookahead.py``).

Every tensor they keep is a copy (``clone``), and every write into a
parameter is an in-place copy: the reference rebinds its immutable
arrays, but rebinding a torch parameter's storage would move the address
that the fused update's table and a captured graph hold.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """k steps forward, 1 step back (Zhang et al. 2019; the reference's
    ``LookAhead``, ``paddle_tpu/incubate/lookahead.py:13``).  Wraps any
    inner optimizer: every ``k`` inner steps the slow weights move
    ``alpha`` of the way toward the fast ones and the fast weights are
    reset to them.  The slow copy is taken after the first inner step, as
    the reference's is."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None) -> None:
        if inner_optimizer is None:
            raise ValueError("inner optimizer required")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha {alpha} not in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow: Dict[int, torch.Tensor] = {}
        self._parameter_list = inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self) -> None:
        self.inner_optimizer.step()
        self._step_count += 1
        for p in self._parameter_list:
            if id(p) not in self._slow:
                self._slow[id(p)] = p.detach().clone()
        if self._step_count % self.k == 0:
            for p in self._parameter_list:
                slow = self._slow[id(p)]
                slow.copy_(slow + self.alpha * (p - slow))
                p.copy_(slow)

    def clear_grad(self) -> None:
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_step"] = self._step_count
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        self._step_count = sd.pop("lookahead_step", 0)
        self.inner_optimizer.set_state_dict(sd)

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """Averaged weights for evaluation (the reference's ``ModelAverage``,
    ``paddle_tpu/incubate/lookahead.py:66``): ``step`` adds the parameters
    to a running sum (halved, with the count, past ``max_average_window``
    steps); ``apply`` puts the average into the parameters and keeps a
    copy to put back under ``restore``."""

    def __init__(self, average_window_rate: float = 0.15, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None) -> None:
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._parameter_list = list(parameters or [])
        self._sum: Dict[int, torch.Tensor] = {}
        self._count = 0
        self._backup: Optional[Dict[int, torch.Tensor]] = None

    @torch.no_grad()
    def step(self) -> None:
        self._count += 1
        for p in self._parameter_list:
            acc = self._sum.get(id(p))
            if acc is None:
                self._sum[id(p)] = p.detach().clone()
            else:
                acc.add_(p)
        if self._count > self.max_w:
            # restart the window (the reference's sliding accumulators)
            for p in self._parameter_list:
                self._sum[id(p)].mul_(0.5)
            self._count = self._count // 2

    @torch.no_grad()
    def apply(self, executor=None, need_restore: bool = True):
        self._backup = {id(p): p.detach().clone()
                        for p in self._parameter_list}
        for p in self._parameter_list:
            if id(p) in self._sum and self._count > 0:
                p.copy_(self._sum[id(p)] / self._count)
        return _RestoreCtx(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None) -> None:
        if self._backup is None:
            return
        for p in self._parameter_list:
            if id(p) in self._backup:
                p.copy_(self._backup[id(p)])
        self._backup = None


class _RestoreCtx:
    def __init__(self, ma: ModelAverage) -> None:
        self._ma = ma

    def __enter__(self):
        return self._ma

    def __exit__(self, *exc):
        self._ma.restore()
        return False

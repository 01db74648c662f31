"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

Closure-driven: ``step(closure)`` re-evaluates the loss and the grads, runs
the two-loop recursion over a bounded (s, y) history and, with
``line_search_fn="strong_wolfe"``, a bracketing strong-Wolfe search.  The
vectors are flat torch tensors on the parameters' device (the history
holds ``2 * history_size`` of them); the control flow is on the host and
reads a scalar back where the reference's ``float(...)`` does.  New
iterates are copied into the parameters in place, so their addresses (and
any fused-update table or captured graph that holds them) stay.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class LBFGS(Optimizer):
    """The reference's ``LBFGS`` (``paddle_tpu/optimizer/lbfgs.py:26``)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None) -> None:
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist: List[torch.Tensor] = []
        self._y_hist: List[torch.Tensor] = []
        self._rho: List[float] = []
        self._n_evals = 0

    # ------------------------------------------------------------- helpers
    def _gather(self):
        """The parameters, their flat values and their flat grads (zeros
        where a grad is missing), with the clip and the regularizer folded
        in, as the base step does."""
        params = list(self._parameter_list)
        with torch.no_grad():
            flat_p = _flat([p.detach() for p in params])
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self._grad_clip is not None:
                grads = [g for _, g in self._grad_clip(
                    list(zip(params, grads)))]
            if self._weight_decay is not None:
                grads = [self._weight_decay.apply_tensor(p, g)
                         for p, g in zip(params, grads)]
            return params, flat_p, _flat(grads)

    @torch.no_grad()
    def _assign(self, params, flat_p) -> None:
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat_p[off:off + n].view_as(p))
            off += n

    def _direction(self, flat_grad):
        """Two-loop recursion over the stored history."""
        q = -flat_grad
        alphas = []
        for s, y, rho in zip(reversed(self._s_hist), reversed(self._y_hist),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._y_hist:
            y = self._y_hist[-1]
            s = self._s_hist[-1]
            gamma = torch.dot(s, y) / torch.dot(y, y).clamp_min(1e-20)
            q = q * gamma
        for (s, y, rho), a in zip(zip(self._s_hist, self._y_hist, self._rho),
                                  reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _eval(self, closure, params, flat_p):
        self._assign(params, flat_p)
        self.clear_grad()
        loss = closure()
        self._n_evals += 1
        _, _, flat_grad = self._gather()
        return float(loss.detach()), flat_grad

    # ---------------------------------------------------------------- step
    def step(self, closure: Optional[Callable] = None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        loss = closure()
        self._n_evals = 1
        params, flat_p, flat_grad = self._gather()
        orig_loss = loss
        current = float(loss.detach())

        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return orig_loss

        for _ in range(self.max_iter):
            with torch.no_grad():
                d = self._direction(flat_grad)
                gtd = float(torch.dot(flat_grad, d))
            if gtd > -self.tolerance_change:
                break
            lr = float(self.get_lr())
            t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr \
                if not self._s_hist else lr

            if self.line_search_fn == "strong_wolfe":
                t, new_loss, new_flat_p, new_grad = self._strong_wolfe(
                    closure, params, flat_p, d, t, current, flat_grad, gtd)
            else:
                new_flat_p = flat_p + t * d
                new_loss, new_grad = self._eval(closure, params, new_flat_p)

            with torch.no_grad():
                s = new_flat_p - flat_p
                y = new_grad - flat_grad
                sy = float(torch.dot(s, y))
            if sy > 1e-10:
                if len(self._s_hist) >= self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
                    self._rho.pop(0)
                self._s_hist.append(s)
                self._y_hist.append(y)
                self._rho.append(1.0 / sy)

            delta = abs(new_loss - current)
            flat_p, flat_grad, current = new_flat_p, new_grad, new_loss
            if (float(flat_grad.abs().max()) <= self.tolerance_grad
                    or delta < self.tolerance_change
                    or self._n_evals >= self.max_eval):
                break

        self._assign(params, flat_p)
        return orig_loss

    @torch.no_grad()
    def _dot(self, a, b) -> float:
        return float(torch.dot(a, b))

    def _strong_wolfe(self, closure, params, flat_p, d, t, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_ls=25):
        """Bracketing strong-Wolfe search (the reference's ``_strong_wolfe``,
        ``paddle_tpu/optimizer/lbfgs.py:148``)."""
        f_prev, t_prev = f0, 0.0
        f_new, g_new = self._eval(closure, params, flat_p + t * d)
        for i in range(max_ls):
            if f_new > f0 + c1 * t * gtd0 or (i > 0 and f_new >= f_prev):
                return self._zoom(closure, params, flat_p, d, f0, gtd0,
                                  t_prev, f_prev, t, f_new, c1, c2)
            gtd_new = self._dot(g_new, d)
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, flat_p + t * d, g_new
            if gtd_new >= 0:
                return self._zoom(closure, params, flat_p, d, f0, gtd0,
                                  t, f_new, t_prev, f_prev, c1, c2)
            t_prev, f_prev = t, f_new
            t = t * 2.0
            f_new, g_new = self._eval(closure, params, flat_p + t * d)
        return t, f_new, flat_p + t * d, g_new

    def _zoom(self, closure, params, flat_p, d, f0, gtd0, t_lo, f_lo, t_hi,
              f_hi, c1, c2, max_zoom=25):
        for _ in range(max_zoom):
            t = 0.5 * (t_lo + t_hi)
            f_new, g_new = self._eval(closure, params, flat_p + t * d)
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                t_hi, f_hi = t, f_new
            else:
                gtd_new = self._dot(g_new, d)
                if abs(gtd_new) <= -c2 * gtd0:
                    return t, f_new, flat_p + t * d, g_new
                if gtd_new * (t_hi - t_lo) >= 0:
                    t_hi, f_hi = t_lo, f_lo
                t_lo, f_lo = t, f_new
            if abs(t_hi - t_lo) < 1e-9:
                break
        f_new, g_new = self._eval(closure, params, flat_p + t_lo * d)
        return t_lo, f_new, flat_p + t_lo * d, g_new

"""nn.utils (counterpart of ``paddle_tpu/nn/utils/__init__.py``):
``parameters_to_vector``/``vector_to_parameters``, ``weight_norm``/
``remove_weight_norm``, ``spectral_norm``, ``clip_grad_norm_`` and
``clip_grad_value_``.

``weight_norm`` and ``spectral_norm`` follow the reference's hook design:
the wrapped parameter is replaced by its reparameterisation's inputs
(``<name>_g``/``<name>_v``, or ``<name>_orig`` with the power
iteration's ``<name>_u``/``<name>_v`` buffers) and a forward pre-hook
recomputes the effective weight as a plain attribute, so the optimizer
sees the inputs and autograd carries the effective weight's gradient to
them.  The clips work in place on ``.grad`` without a host sync (unless
``error_if_nonfinite`` asks for the norm's value).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_",
           "clip_grad_value_"]


def parameters_to_vector(parameters, name=None) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None) -> None:
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].view_as(p))
            offset += n


# -- weight norm --------------------------------------------------------------

def _norm_except_dim(v: torch.Tensor, dim: int) -> torch.Tensor:
    if dim == -1:
        return torch.sqrt((v * v).sum())
    axes = [i for i in range(v.dim()) if i != dim]
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    return torch.sqrt((v * v).sum(dim=axes)).reshape(shape)


def _wn_compute(g, v, dim: int) -> torch.Tensor:
    return v * (g / _norm_except_dim(v, dim))


def _set_plain(layer, name, value) -> None:
    object.__setattr__(layer, name, value)


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Reparameterise ``layer.<name>`` as magnitude ``<name>_g`` times
    direction ``<name>_v`` (norms over every axis but ``dim``; None: over
    all)."""
    if dim is None:
        dim = -1
    if hasattr(layer, f"__wn_hook_{name}"):
        raise RuntimeError(f"weight_norm already applied to '{name}'")
    w = getattr(layer, name)
    if not isinstance(w, nn.Parameter):
        raise ValueError(f"'{name}' is not a Parameter of "
                         f"{type(layer).__name__}")
    with torch.no_grad():
        g0 = _norm_except_dim(w, dim).clone()
        v0 = w.detach().clone()
    del layer._parameters[name]
    layer.register_parameter(name + "_g", nn.Parameter(g0))
    layer.register_parameter(name + "_v", nn.Parameter(v0))

    def hook(lyr, inputs):
        _set_plain(lyr, name, _wn_compute(getattr(lyr, name + "_g"),
                                          getattr(lyr, name + "_v"), dim))

    handle = layer.register_forward_pre_hook(hook)
    _set_plain(layer, f"__wn_hook_{name}", (handle, dim))
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    rec = layer.__dict__.get(f"__wn_hook_{name}")
    if rec is None:
        raise ValueError(f"weight_norm was not applied to '{name}'")
    handle, dim = rec
    handle.remove()
    with torch.no_grad():
        eff = _wn_compute(getattr(layer, name + "_g"),
                          getattr(layer, name + "_v"), dim).clone()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    del layer.__dict__[f"__wn_hook_{name}"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, nn.Parameter(eff))
    return layer


# -- spectral norm ------------------------------------------------------------

def _spectral_normalize(weight, dim, power_iters, eps, u=None, v=None,
                        update=True):
    """(weight / sigma_max, u, v): ``update`` runs the power iteration
    (at least once) from ``u``, ``v`` (numpy's generator seeded 0 when
    None); sigma = u . W v carries W's gradient, u and v none."""
    perm = [dim] + [i for i in range(weight.dim()) if i != dim]
    mat = weight.permute(perm).reshape(weight.shape[dim], -1)
    h, w_dim = mat.shape
    rng = np.random.RandomState(0)
    if u is None:
        u = torch.from_numpy(rng.randn(h)).to(mat)
    if v is None:
        v = torch.from_numpy(rng.randn(w_dim)).to(mat)
    u, v = u.to(mat.dtype).detach(), v.to(mat.dtype).detach()
    if update:
        with torch.no_grad():
            m = mat.detach()
            for _ in range(max(int(power_iters), 1)):
                v = m.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = (u * (mat @ v)).sum()
    return weight / sigma, u, v


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim=None):
    """Normalise ``layer.<name>`` by its largest singular value, refreshed
    by power iteration at each training forward (``dim`` None: 1 for a
    Linear's (in, out) weight, 0 otherwise)."""
    if hasattr(layer, f"__sn_hook_{name}"):
        raise RuntimeError(f"spectral_norm already applied to '{name}'")
    w = getattr(layer, name)
    if not isinstance(w, nn.Parameter):
        raise ValueError(f"'{name}' is not a Parameter of "
                         f"{type(layer).__name__}")
    if dim is None:
        dim = 1 if "linear" in type(layer).__name__.lower() else 0
    del layer._parameters[name]
    orig = nn.Parameter(w.detach().clone())
    layer.register_parameter(name + "_orig", orig)
    _, u0, v0 = _spectral_normalize(orig, dim, n_power_iterations, eps)
    layer.register_buffer(name + "_u", u0)
    layer.register_buffer(name + "_v", v0)

    def hook(lyr, inputs):
        out, u2, v2 = _spectral_normalize(
            getattr(lyr, name + "_orig"), dim, n_power_iterations, eps,
            getattr(lyr, name + "_u"), getattr(lyr, name + "_v"),
            update=lyr.training)
        with torch.no_grad():
            getattr(lyr, name + "_u").copy_(u2)
            getattr(lyr, name + "_v").copy_(v2)
        _set_plain(lyr, name, out)

    handle = layer.register_forward_pre_hook(hook)
    _set_plain(layer, f"__sn_hook_{name}", (handle, dim))
    hook(layer, ())
    return layer


# -- gradient clips -------------------------------------------------------------

def _listed(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every gradient in place by min(1, max_norm / (total + 1e-6)),
    ``total`` the ``norm_type``-norm of all of them together; returns
    ``total`` (a 0-dim f32 tensor on the gradients' device)."""
    grads = [p.grad for p in _listed(parameters) if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.detach().abs().max().float()
                             for g in grads]).max()
    else:
        total = torch.stack([(g.detach().float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"clip_grad_norm_: total norm is {float(total)} "
            f"(set error_if_nonfinite=False to clip anyway)")
    coef = torch.clamp(float(max_norm) / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient in place to [-clip_value, clip_value]."""
    cv = float(clip_value)
    for p in _listed(parameters):
        if p.grad is not None:
            p.grad.clamp_(-cv, cv)

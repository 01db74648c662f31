"""Random ops (counterpart of ``paddle_tpu/tensor/random.py``, Paddle's
``python/paddle/tensor/random.py``).

Every random op draws from the generator of the device it writes to
(``core/random_state.py``; ``paddle_tpu_torch.seed`` reseeds them).  The
registered ops take that ``torch.Generator`` where the reference's take a
JAX key: the two packages' random streams differ, and only shapes, dtypes,
determinism under ``seed`` and moments compare."""

from __future__ import annotations

import numpy as np
import torch

from ..core import random_state
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.place import resolve_device
from ..ops.op import apply, register_many, register_op
from ._helpers import tdtype, to_static_int_list

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "standard_gamma", "bernoulli",
    "multinomial", "poisson", "exponential_", "uniform_", "normal_",
    "binomial", "log_normal", "bernoulli_",
]


def _gen(device):
    return random_state.generator(device)


def _uniform(gen, shape, dtype, lo, hi):
    out = torch.empty(shape, dtype=tdtype(dtype), device=gen.device)
    return out.uniform_(lo, hi, generator=gen)


def _normal(gen, mean, std, shape, dtype):
    z = torch.randn(shape, dtype=tdtype(dtype), device=gen.device,
                    generator=gen)
    return mean + std * z


def _randint(gen, low, high, shape, dtype):
    return torch.randint(low, high, shape, dtype=tdtype(dtype),
                         device=gen.device, generator=gen)


register_many("opaque", {"uniform_op": _uniform, "normal_op": _normal,
                         "randint_op": _randint})
register_many("unary", {
    "bernoulli_op": lambda gen, p: torch.bernoulli(p, generator=gen),
    "poisson_op": lambda gen, lam: torch.poisson(lam, generator=gen),
})
register_op("gamma_op", lambda gen, alpha, shape, dtype: torch._standard_gamma(
    torch.broadcast_to(alpha, shape).to(tdtype(dtype)).contiguous(),
    generator=gen), "unary")


def _shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(to_static_int_list(shape) or ())


def rand(shape, dtype=None, name=None, device=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, device=device)


def randn(shape, dtype=None, name=None, device=None):
    return apply("normal_op", _gen(resolve_device(device)), 0.0, 1.0,
                 shape=_shape(shape), dtype=to_torch_dtype(dtype))


standard_normal = randn


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    dev = resolve_device(device)
    gen = _gen(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    lo = min.item() if isinstance(min, torch.Tensor) else float(min)
    hi = max.item() if isinstance(max, torch.Tensor) else float(max)
    return apply("uniform_op", gen, shape=_shape(shape),
                 dtype=to_torch_dtype(dtype), lo=lo, hi=hi)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        t = mean if isinstance(mean, torch.Tensor) else std
        out_shape = torch.broadcast_shapes(
            torch.as_tensor(mean).shape, torch.as_tensor(std).shape) \
            if shape is None else _shape(shape)
        return apply("normal_op", _gen(t.device), mean, std,
                     shape=tuple(out_shape), dtype=get_default_dtype())
    return apply("normal_op", _gen(resolve_device(device)), float(mean),
                 float(std), shape=_shape(shape if shape is not None else []),
                 dtype=get_default_dtype())


def log_normal(mean=1.0, std=2.0, shape=None, name=None, device=None):
    return torch.exp(normal(mean, std, shape, device=device))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device=None):
    if high is None:
        low, high = 0, low
    return apply("randint_op", _gen(resolve_device(device)), int(low),
                 int(high), shape=_shape(shape), dtype=to_torch_dtype(dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    out = apply("randint_op", _gen(x.device), int(low), int(high),
                shape=tuple(x.shape), dtype=torch.int64)
    return out.to(tdtype(dtype) if dtype is not None else x.dtype)


def randperm(n, dtype="int64", name=None, device=None):
    dev = resolve_device(device)
    return torch.randperm(int(n), generator=_gen(dev), device=dev,
                          dtype=to_torch_dtype(dtype))


def bernoulli(x, name=None):
    return apply("bernoulli_op", _gen(x.device), x)


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        x.bernoulli_(p, generator=_gen(x.device))
    return x


def poisson(x, name=None):
    return apply("poisson_op", _gen(x.device), x)


def standard_gamma(x, name=None):
    return apply("gamma_op", _gen(x.device), x, shape=tuple(x.shape),
                 dtype=x.dtype)


def binomial(count, prob, name=None):
    t = count if isinstance(count, torch.Tensor) else prob
    n = torch.as_tensor(count, device=t.device).float()
    p = torch.as_tensor(prob, device=t.device).float()
    return torch.binomial(n, p.expand_as(n), generator=_gen(t.device)).long()


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x.exponential_(lam, generator=_gen(x.device))
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    gen = _gen(x.device)
    if seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    with torch.no_grad():
        x.uniform_(float(min), float(max), generator=gen)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        x.normal_(mean, std, generator=_gen(x.device))
    return x

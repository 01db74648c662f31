"""``summary`` — the layer-by-layer model table (counterpart of
``paddle_tpu/hapi/model_summary.py``; Paddle's
python/paddle/hapi/model_summary.py summary:36).

Forward post-hooks on the leaf sublayers record each one's output shape
and parameters during one forward on zeros (under ``no_grad``, in eval
mode, on the network's device), as the reference does.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.dtype import to_torch_dtype

__all__ = ["summary"]


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _device_of(net) -> torch.device:
    for t in list(net.parameters()) + list(net.buffers()):
        return t.device
    return torch.device("cpu")


def _hook(layer, fn):
    register = getattr(layer, "register_forward_post_hook",
                       layer.register_forward_hook)
    return register(fn)


def zero_inputs(net, input_size, dtypes=None) -> list:
    """Zero tensors of ``input_size`` (one shape or a list of shapes; a
    None or -1 dimension is 1) on the network's device."""
    sizes = input_size if isinstance(input_size, list) and \
        isinstance(input_size[0], (list, tuple)) else [input_size]
    dts = dtypes if isinstance(dtypes, (list, tuple)) \
        else [dtypes] * len(sizes)
    device = _device_of(net)
    return [torch.zeros(tuple(1 if d is None or d == -1 else int(d)
                              for d in sz),
                        dtype=to_torch_dtype(dt or "float32"), device=device)
            for sz, dt in zip(sizes, dts)]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns {'total_params': N,
    'trainable_params': N}.  Paddle's model_summary.py:36."""
    if input is not None:
        inputs = input if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("either input_size or input must be given")
        inputs = zero_inputs(net, input_size, dtypes)

    rows: List[dict] = []
    hooks = []

    def make_hook(name, layer):
        def hook(l, ins, out):
            out0 = out[0] if isinstance(out, (list, tuple)) else out
            oshape = list(out0.shape) if isinstance(out0, torch.Tensor) \
                else "?"
            own = [p for p in l._parameters.values() if p is not None]
            rows.append({"name": f"{type(l).__name__}-{len(rows) + 1}",
                         "output_shape": oshape,
                         "params": sum(_prod(p.shape) for p in own),
                         "trainable": sum(_prod(p.shape) for p in own
                                          if p.requires_grad)})
        return hook

    for name, sub in net.named_modules():
        if sub is not net and not list(sub.children()):  # leaves only
            hooks.append(_hook(sub, make_hook(name, sub)))

    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        net.train(was_training)

    total = sum(_prod(p.shape) for p in net.parameters())
    trainable = sum(_prod(p.shape) for p in net.parameters()
                    if p.requires_grad)

    w = 72
    print("-" * w)
    print(f"{'Layer (type)':<28}{'Output Shape':<26}{'Param #':>16}")
    print("=" * w)
    for r in rows:
        print(f"{r['name']:<28}{str(r['output_shape']):<26}"
              f"{r['params']:>16,}")
    print("=" * w)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * w)
    return {"total_params": total, "trainable_params": trainable}

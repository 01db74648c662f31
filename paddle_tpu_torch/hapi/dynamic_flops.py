"""``flops`` — a model's FLOPs for one forward (counterpart of
``paddle_tpu/hapi/dynamic_flops.py``; Paddle's
python/paddle/hapi/dynamic_flops.py).

The reference reads XLA's cost analysis of the jitted forward.  The port
counts, as Paddle's own ``flops`` does, with forward hooks on the layers
and a rule a layer type, over one forward on the given inputs (under
``no_grad``, in eval mode).  The rules count what XLA counts for these
layers: 2 per multiply-add of a Linear (``Linear``,
``ColumnParallelLinear``, ``RowParallelLinear``; XLA folds the bias add
into the product, so it counts nothing for it), one per output element
of ``ReLU`` (a max), and, for the Llama's attention, the two products
over every (query, key) pair, 4·B·H·Sq·Sk·D, which the reference's
masked attention computes in full.  Other layers count 0 (XLA counts
elementwise arithmetic that these rules omit: a normalization's, a
softmax's, a residual's); ``custom_ops`` maps a layer type to a rule
``fn(layer, inputs, output) -> int`` of its own.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

__all__ = ["flops"]


def _linear(layer, inputs, out) -> int:
    return 2 * int(layer.weight.shape[0]) * out.numel()


def _relu(layer, inputs, out) -> int:
    return out.numel()


def _llama_attention(layer, inputs, out) -> int:
    b, s = inputs[0].shape[0], inputs[0].shape[1]
    return 4 * b * layer.num_heads * s * s * layer.head_dim


def _rules() -> Dict[type, Callable]:
    from ..distributed.fleet.meta_parallel.mp_layers import (
        ColumnParallelLinear, RowParallelLinear)
    from ..models.llama import LlamaAttention
    from ..nn.layer.activation import ReLU
    from ..nn.layer.common import Linear
    return {Linear: _linear, ColumnParallelLinear: _linear,
            RowParallelLinear: _linear, ReLU: _relu,
            LlamaAttention: _llama_attention}


def flops(net, input_size: Sequence[int] = None, inputs=None,
          custom_ops=None, print_detail: bool = False) -> int:
    """Model FLOPs for one forward pass (Paddle's hapi flops).

    Args:
        net: a Layer.
        input_size: shape of a single float32 input (e.g. [1, 3, 224,
            224]), made of zeros on the network's device.
        inputs: alternatively, example input tensor(s).
        custom_ops: {layer type: fn(layer, inputs, output) -> int}.
        print_detail: also print each counted layer's FLOPs.
    """
    from .model_summary import zero_inputs
    if inputs is None:
        if input_size is None:
            raise ValueError("flops() needs input_size or inputs")
        inputs = zero_inputs(net, list(input_size))
    elif isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    rules = {**_rules(), **(custom_ops or {})}
    counted = []
    hooks = []
    for name, sub in net.named_modules():
        rule = next((r for t, r in rules.items() if type(sub) is t), None)
        if rule is None:
            continue

        def hook(layer, ins, out, rule=rule, name=name):
            out0 = out[0] if isinstance(out, (list, tuple)) else out
            counted.append((name or type(layer).__name__,
                            int(rule(layer, ins, out0))))
        hooks.append(sub.register_forward_hook(hook))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        net.train(was_training)
    total = sum(n for _, n in counted)
    n_params = sum(p.numel() for p in net.parameters())
    if print_detail:
        print(f"{'Layer':<48}{'FLOPs':>20}")
        print("-" * 68)
        for name, n in counted:
            print(f"{name:<48}{n:>20,}")
        print("-" * 68)
    print(f"Total Flops: {total:,}     Total Params: {n_params:,}")
    return total

"""The port's Llama with an attention mask, and AdamW's
``apply_decay_param_fun`` in the captured step, against the JAX package.

The reference threads ``attn_mask`` from ``LlamaForCausalLM.forward`` to
``F.scaled_dot_product_attention(..., attn_mask=attn_mask, is_causal=True)``
(``paddle_tpu/models/llama.py:340, 303, 264, 218``); the port does the same,
and a mask takes the plain ``sdpa`` in both packages.

The reference's captured AdamW decays every parameter whatever
``apply_decay_param_fun`` says (its ``_update`` reads a mask that only
``step()`` sets); the port applies the function in both of its steps, as
the reference's eager ``step()`` does.  The last test pins that
difference."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random_state
from paddle_tpu.jit import TrainStepCapture as JaxStep
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStepCapture
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer.common import Linear as TLinear


@pytest.fixture(autouse=True)
def _restore_reference_rng():
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)


def models(seed=3):
    """The reference tiny f32 Llama (2 layers, hidden 64) and the port's
    with its weights."""
    paddle.seed(seed)
    cfg = dict(num_hidden_layers=2, max_position_embeddings=64)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    port = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(port, {
        n: np.asarray(p.numpy()).astype(np.float32)
        for n, p in jmodel.named_parameters()})
    return jmodel, port


def padded_batch(seq=24, seed=4):
    """Two sequences, the second right-padded after 15 tokens: ids, labels
    and the key-padding mask (B, 1, 1, S), True = attend."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, 256, (2, seq))
    labels = r.randint(0, 256, (2, seq))
    mask = np.ones((2, 1, 1, seq), bool)
    mask[1, ..., 15:] = False
    return ids, labels, mask


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_padding_mask_logits_and_grads_match_reference():
    jmodel, port = models()
    ids, labels, mask = padded_batch()
    jlogits = jmodel(paddle.to_tensor(ids), paddle.to_tensor(mask))
    jloss = jmodel.compute_loss(jlogits, paddle.to_tensor(labels))
    jloss.backward()
    TF.reset_route_counts()
    logits = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert TF.ROUTE_COUNTS == {"sdpa_plain:mask": 2}
    loss = port.compute_loss(logits, torch.from_numpy(labels))
    loss.backward()
    want = np.asarray(jlogits.numpy())
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    # the mask changed the padded sequence's logits, not the full one's
    unmasked = port(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(unmasked[0], want[0], atol=1e-5, rtol=1e-5)
    assert np.abs(unmasked[1, 15:] - want[1, 15:]).max() > 1e-3
    assert abs(loss.item() - float(jloss.numpy())) <= 1e-5 * abs(loss.item())
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jmodel.named_parameters()}
    for n, p in port.named_parameters():
        assert rel_l2(p.grad.numpy(), jgrads[n]) <= 1e-5, n


def test_no_mask_keeps_the_flash_route():
    _, port = models()
    ids, _, _ = padded_batch()
    TF.reset_route_counts()
    with torch.no_grad():
        port(torch.from_numpy(ids))
        port(torch.from_numpy(ids), None)
    assert TF.ROUTE_COUNTS == {"sdpa_flash": 4}


def test_captured_step_with_a_mask_matches_the_eager_loop():
    _, port = models()
    _, twin = models()
    ids, labels, mask = (torch.from_numpy(a) for a in padded_batch())

    def loss_fn(model, ids, labels, mask):
        return model.compute_loss(model(ids, mask), labels)

    opt = topt.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                     weight_decay=0.01)
    eager = topt.AdamW(learning_rate=1e-3, parameters=twin.parameters(),
                       weight_decay=0.01)
    step = TrainStepCapture(port, opt, loss_fn)
    TF.reset_route_counts()
    for _ in range(3):
        got = step(ids, labels, mask).item()
        loss = loss_fn(twin, ids, labels, mask)
        loss.backward()
        eager.step()
        eager.clear_grad()
        assert abs(got - loss.item()) <= 1e-5 * abs(loss.item())
    assert set(TF.ROUTE_COUNTS) == {"sdpa_plain:mask"}
    twin_params = dict(twin.named_parameters())
    for n, p in port.named_parameters():
        want = twin_params[n].detach().numpy()
        assert rel_l2(p.detach().numpy(), want) <= 1e-5, n


def test_captured_adamw_keeps_apply_decay_param_fun():
    """AdamW(lr 0.1, weight_decay 0.5, apply_decay_param_fun -> False),
    one step on zero gradients, so only the decay can move a weight.  The
    reference's captured step scales the weights by 1 - 0.1 * 0.5 = 0.95
    (it decays every parameter); its eager ``step()`` leaves them (1.0).
    The port's captured and eager steps both equal the reference's eager
    step."""
    w0 = np.random.RandomState(0).standard_normal((4, 3)).astype(np.float32)
    x = np.ones((2, 4), np.float32)
    kw = dict(learning_rate=0.1, weight_decay=0.5,
              apply_decay_param_fun=lambda name: False)

    def zero_loss(model, x):
        return (model(x) * 0.0).sum()

    def ref_linear():
        lin = paddle.nn.Linear(4, 3, bias_attr=False)
        lin.weight.set_value(paddle.to_tensor(w0))
        return lin

    jcap = ref_linear()
    JaxStep(jcap, jopt.AdamW(parameters=jcap.parameters(), **kw),
            zero_loss)(paddle.to_tensor(x))
    jeag = ref_linear()
    jo = jopt.AdamW(parameters=jeag.parameters(), **kw)
    zero_loss(jeag, paddle.to_tensor(x)).backward()
    jo.step()
    ref_captured = np.asarray(jcap.weight.numpy()) / w0
    ref_eager = np.asarray(jeag.weight.numpy()) / w0
    np.testing.assert_allclose(ref_captured, 0.95, rtol=1e-6)
    np.testing.assert_allclose(ref_eager, 1.0, rtol=1e-6)

    def port_linear():
        lin = TLinear(4, 3, bias=False, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
        return lin

    tcap = port_linear()
    TrainStepCapture(tcap, topt.AdamW(parameters=tcap.named_parameters(),
                                      **kw), zero_loss)(torch.from_numpy(x))
    teag = port_linear()
    to = topt.AdamW(parameters=teag.named_parameters(), **kw)
    zero_loss(teag, torch.from_numpy(x)).backward()
    to.step()
    for lin in (tcap, teag):
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      np.asarray(jeag.weight.numpy()))

"""Llama (counterpart of ``paddle_tpu/models/llama.py``).

Built as the reference builds it: every class a ``Layer``, the q/k/v/
gate/up projections ``ColumnParallelLinear``, o/down
``RowParallelLinear``, the embedding ``VocabParallelEmbedding`` (one
device: ``distributed/fleet/meta_parallel/mp_layers.py``, XavierNormal),
with Paddle's ``(in, out)`` weights, so ``state_dict()`` has the
reference's keys in the reference's order and ``load_reference_arrays``
(a ``set_state_dict``) carries weights across.  Two attention paths: the
serving path (RoPE at explicit absolute positions, K/V written into the
paged pool, attention through the block tables) and the full-sequence
causal path of training and whole-sequence forwards, through
``F.scaled_dot_product_attention`` and so the flash kernels.  Training is
eager: ``loss = model.compute_loss(model(ids), labels)``,
``loss.backward()``, then the optimizer (``optimizer/``).  Gradients
through ``rope_at`` come from autograd (the reference writes
``_rope_vjp`` by hand; the tests hold the two to each other).  The
reference's registry ops ``rope`` and ``rope_at`` are registered here.

RoPE rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])``, exactly as
the reference's ``_rope_fwd``/``_rope_at_fwd`` do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..core.place import resolve_device
from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from ..nn import functional as F
from ..nn.layer import LayerList, RMSNorm
from ..nn.layer.layers import Layer
from ..ops.op import register_op

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP",
           "llama_7b_config", "llama_tiny_config", "rope_at",
           "load_reference_arrays"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_7b_config(**overrides) -> LlamaConfig:
    return LlamaConfig(**{**dict(dtype="bfloat16"), **overrides})


def llama_tiny_config(**overrides) -> LlamaConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
    return LlamaConfig(**{**base, **overrides})


def _rope_tables(head_dim: int, max_len: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # (L, D/2)
    return torch.cos(freqs), torch.sin(freqs)


def _rotate(x, c, s):
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(xf.shape).to(x.dtype)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """RoPE at positions 0..S-1, in f32, cast back.  x: (B, S, H, D);
    cos/sin: (S, D/2)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def rope_at(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """RoPE at explicit absolute positions, in f32, cast back.
    x: (B, S, H, D); positions: (B, S) integer."""
    return _rotate(x, cos[positions][:, :, None, :],       # (B, S, 1, D/2)
                   sin[positions][:, :, None, :])


register_op("rope", rope, "norm_layer")
register_op("rope_at", rope_at, "norm_layer")


def _kw(config: LlamaConfig, device, generator) -> dict:
    return dict(dtype=config.dtype, device=device, generator=generator)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device, generator) -> None:
        super().__init__(dtype=config.dtype)
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        col = dict(has_bias=False, gather_output=False,
                   **_kw(config, device, generator))
        self.q_proj = ColumnParallelLinear(h, h, **col)
        self.k_proj = ColumnParallelLinear(h, kv_out, **col)
        self.v_proj = ColumnParallelLinear(h, kv_out, **col)
        self.o_proj = RowParallelLinear(h, h, has_bias=False,
                                        input_is_parallel=True,
                                        **_kw(config, device, generator))
        cos, sin = _rope_tables(self.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta, device)
        self.register_buffer("_cos", cos, persistable=False)
        self.register_buffer("_sin", sin, persistable=False)

    def forward(self, hidden, attn_mask=None, cache=None, positions=None):
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).view(b, s, self.num_kv_heads, self.head_dim)
        if positions is None:
            positions = torch.arange(s, device=hidden.device).expand(b, s)
        q = rope_at(q, self._cos, self._sin, positions)
        k = rope_at(k, self._cos, self._sin, positions)
        if cache is not None:
            # serving: new K/V into the paged pool, attention through the
            # block tables (the cache picks the decode kernel or the
            # gather path)
            cache.update(k, v)
            out = cache.attend(q)
        else:
            # full sequence (training and whole-sequence forwards): the
            # flash kernels, forward and backward; a mask takes the plain
            # sdpa, as in the reference
            out = F.scaled_dot_product_attention(q, k, v,
                                                 attn_mask=attn_mask,
                                                 is_causal=True,
                                                 training=self.training)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, device, generator) -> None:
        super().__init__(dtype=config.dtype)
        h, inter = config.hidden_size, config.intermediate_size
        col = dict(has_bias=False, gather_output=False,
                   **_kw(config, device, generator))
        self.gate_proj = ColumnParallelLinear(h, inter, **col)
        self.up_proj = ColumnParallelLinear(h, inter, **col)
        self.down_proj = RowParallelLinear(inter, h, has_bias=False,
                                           input_is_parallel=True,
                                           **_kw(config, device, generator))

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device, generator) -> None:
        super().__init__(dtype=config.dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps,
                                       dtype=config.dtype, device=device)
        self.self_attn = LlamaAttention(config, device, generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps,
                                                dtype=config.dtype,
                                                device=device)
        self.mlp = LlamaMLP(config, device, generator)

    def forward(self, hidden, attn_mask=None, cache=None, positions=None):
        residual = hidden
        hidden = self.input_layernorm(hidden)
        hidden = self.self_attn(hidden, attn_mask, cache=cache,
                                positions=positions)
        hidden = residual + hidden
        residual = hidden
        hidden = self.post_attention_layernorm(hidden)
        return residual + self.mlp(hidden)


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device, generator) -> None:
        super().__init__(dtype=config.dtype)
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            **_kw(config, device, generator))
        self.layers = LayerList(
            [LlamaDecoderLayer(config, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            dtype=config.dtype, device=device)

    def forward(self, input_ids, attn_mask=None, caches=None,
                positions=None):
        hidden = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            hidden = layer(hidden, attn_mask, cache=None if caches is None
                           else caches[i], positions=positions)
        return self.norm(hidden)


class LlamaForCausalLM(Layer):
    """``device=None`` builds on the card (raising when there is none);
    pass ``device="cpu"`` for the CPU.  Weights are drawn on the target
    device from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0
                 ) -> None:
        super().__init__(dtype=config.dtype)
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.config = config
        self.llama = LlamaModel(config, device, gen)
        self.lm_head = None if config.tie_word_embeddings else \
            ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                 has_bias=False, gather_output=True,
                                 **_kw(config, device, gen))
        self._serving_engine = None

    def forward(self, input_ids: torch.Tensor, attn_mask=None
                ) -> torch.Tensor:
        """Full-sequence causal forward: (B, S) ids → (B, S, vocab).
        ``attn_mask`` (bool, True = attend, or additive float), broadcast
        to (B, H, S, S), is applied on top of the causal mask."""
        hidden = self.llama(input_ids, attn_mask)
        if self.lm_head is None:
            return F.linear(hidden, self.llama.embed_tokens.weight.t())
        return self.lm_head(hidden)

    def compute_loss(self, logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
        """Causal LM loss (shift inside the caller): f32 softmax cross
        entropy over the flattened logits, mean over labels that are not
        -100."""
        return F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def generate(self, prompts, max_new_tokens: int = 16, eos_id=None,
                 engine=None, **engine_kwargs):
        """Greedy generation through the serving engine (paged KV cache +
        continuous batching).  ``prompts``: one token-id list or a list of
        them; returns the generated ids (a list per prompt, or one list for
        a single prompt).  The engine is built on the first call from
        ``engine_kwargs`` (block_size, num_blocks, max_batch, ...,
        ``device`` — None means the card) and cached on the model."""
        from ..serving.engine import ServingEngine
        single = bool(prompts) and isinstance(prompts[0], int)
        batch = [list(prompts)] if single else [list(p) for p in prompts]
        if engine is not None:
            if engine_kwargs:
                raise ValueError(
                    f"engine= was passed, so engine_kwargs "
                    f"{sorted(engine_kwargs)} would be ignored — size the "
                    f"engine where it is built instead")
            self._serving_engine = engine
        elif self._serving_engine is None:
            self._serving_engine = ServingEngine(self, **engine_kwargs)
        elif engine_kwargs:
            raise ValueError(
                f"serving engine already built for this model; "
                f"engine_kwargs {sorted(engine_kwargs)} would be ignored — "
                f"size the engine on the first generate() call, pass "
                f"engine=, or clear model._serving_engine first")
        outs = self._serving_engine.generate(batch, max_new_tokens,
                                             eos_id=eos_id)
        return outs[0] if single else outs


def load_reference_arrays(model: LlamaForCausalLM,
                          arrays: Dict[str, np.ndarray]) -> None:
    """Load the reference model's parameters, as numpy arrays keyed by the
    reference's names (``llama.layers.0.self_attn.q_proj.weight``, ...,
    ``lm_head.weight``), into ``model`` (``set_state_dict``, cast to each
    parameter's dtype).  Raises on a missing name, an unexpected name or a
    shape mismatch; loads nothing unless every array fits."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"reference arrays do not match the model: missing "
                       f"{missing}, unexpected {unexpected}")
    model.set_state_dict(arrays)

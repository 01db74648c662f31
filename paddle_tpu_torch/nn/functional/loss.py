"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``), with the
reference's registry ops ``softmax_ce``, ``bce_logits``, ``ctc_loss_op``
and ``rnnt_loss_op``.

Autograd differentiates the plain formulas; where the reference writes
a VJP by hand (``softmax_ce``: softmax - one_hot; ``bce_logits``:
sigmoid - label, none for the label) the port's gradient is the same.
The reference computes some terms on raw arrays, off its tape: the port
differentiates the ``use_softmax=False`` log, ``cosine_similarity`` and
``gaussian_nll_loss``'s clipped variance (Paddle's own losses do), and
keeps ``kl_div``'s log of the clipped label and the triplet losses'
swapped distance constants, as the reference does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.op import apply, register_op

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "l1_loss", "smooth_l1_loss", "huber_loss", "hsigmoid_loss",
    "multi_margin_loss", "margin_cross_entropy", "rnnt_loss",
    "sparse_attention", "kl_div", "margin_ranking_loss",
    "square_error_cost", "sigmoid_focal_loss", "log_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "ctc_loss", "poisson_nll_loss", "gaussian_nll_loss",
    "dice_loss", "npair_loss",
]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# -- softmax cross entropy ----------------------------------------------------

def _squeeze_label(label: torch.Tensor, ndim: int, axis: int):
    if label.dim() == ndim and label.shape[axis] == 1:
        return label.squeeze(axis)
    return label


def _softmax_ce(logits, label, axis: int, soft_label: bool,
                ignore_index: int, label_smoothing: float):
    """Per-position loss with ``axis`` kept (size 1), as the reference's
    ``_sce_fwd``."""
    axis = axis % logits.dim()
    logp = logits - torch.logsumexp(logits, dim=axis, keepdim=True)
    if soft_label:
        tgt = label.to(logp.dtype)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + \
                label_smoothing / logits.shape[axis]
        return -(tgt * logp).sum(dim=axis, keepdim=True)
    lab = _squeeze_label(label, logits.dim(), axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = torch.take_along_dim(logp, safe.unsqueeze(axis), dim=axis)
    if label_smoothing > 0:
        smooth = logp.mean(dim=axis, keepdim=True)
        loss = -((1 - label_smoothing) * picked + label_smoothing * smooth)
    else:
        loss = -picked
    return torch.where(valid.unsqueeze(axis), loss, torch.zeros_like(loss))


register_op("softmax_ce", _softmax_ce, "opaque")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = apply("softmax_ce", logits, label, axis=int(axis),
                 soft_label=bool(soft_label), ignore_index=int(ignore_index),
                 label_smoothing=0.0)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    """Softmax cross entropy over ``axis`` with Paddle's semantics: the
    hard-label ``mean`` averages over the positions whose label is not
    ``ignore_index``; with ``weight`` (hard labels) each position counts
    its label's weight and ``mean`` divides by the sum of those weights
    (+ 1e-12).  ``use_softmax=False`` takes ``input`` as probabilities:
    ``nll_loss`` of ``log(clip(input, 1e-30))`` (classes on axis 1)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    if not use_softmax:
        logp = torch.log(torch.clamp(input, min=1e-30))
        if soft_label:
            return _reduce(-(label * logp).sum(dim=axis), reduction)
        return nll_loss(logp, label, weight=weight,
                        ignore_index=ignore_index, reduction=reduction)
    axis = axis % input.dim()
    loss = apply("softmax_ce", input, label, axis=axis,
                 soft_label=bool(soft_label), ignore_index=int(ignore_index),
                 label_smoothing=float(label_smoothing)).squeeze(axis)
    if soft_label:
        return _reduce(loss, reduction)
    lab = _squeeze_label(label, input.dim(), axis)
    valid = lab != ignore_index
    if weight is not None:
        w = weight[torch.where(valid, lab, torch.zeros_like(lab)).long()] \
            * valid.to(weight.dtype)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / (w.sum() + 1e-12)
    elif reduction == "mean":
        denom = valid.to(loss.dtype).sum()
        return loss.sum() / torch.clamp(denom, min=1.0)
    return loss.sum() if reduction == "sum" else loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``input``: log-probabilities (N, C, ...); ``label``: (N, ...).  The
    ``mean`` divides by the valid positions' weights (or their count)."""
    lab = label.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    logp = input
    if input.dim() > 2:
        logp = torch.movedim(input, 1, -1).reshape(-1, input.shape[1])
    vf = valid.to(input.dtype)
    loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1) * vf
    if weight is not None:
        wsel = weight[safe]
        loss = loss * wsel * vf
        denom = (wsel * vf).sum()
    else:
        denom = vf.sum()
    if reduction == "mean":
        return loss.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(label.shape)


# -- binary cross entropy -----------------------------------------------------

class _BCELogits(torch.autograd.Function):
    """max(x, 0) - x y + log1p(exp(-|x|)); the reference's VJP: the logit
    gets g (sigmoid(x) - y), the label nothing."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.clamp(x, min=0) - x * y + torch.log1p(
            torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (torch.sigmoid(x) - y), None


register_op("bce_logits", _BCELogits.apply, "binary_broadcast")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    x = torch.clamp(input, eps, 1.0 - eps)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log(1.0 - x + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    if pos_weight is not None:
        lw = 1 + (pos_weight - 1) * label
        loss = (1 - label) * logit + lw * (-torch.nn.functional.logsigmoid(
            logit))
    else:
        loss = apply("bce_logits", logit, label)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


# -- regression and margin losses --------------------------------------------

def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) * (input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    """Quadratic inside ``delta``, linear outside, delta-scaled (where
    ``smooth_l1_loss`` divides by delta)."""
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)), reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        # the log of the clipped label is a constant to the gradient, as
        # the reference computes it off its tape
        loss = label * (torch.log(torch.clamp(label, min=1e-12)).detach()
                        - input)
    if reduction == "batchmean":
        return loss.sum() / loss.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.relu(-label * (input - other) + margin), reduction)


def square_error_cost(input, label):
    d = input - label
    return d * d


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = apply("bce_logits", logit, label)
    p_t = p * label + (1.0 - p) * (1.0 - label)
    alpha_t = alpha * label + (1 - alpha) * (1.0 - label)
    loss = alpha_t * ce * (1.0 - p_t) ** gamma
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon) +
             (1.0 - label) * torch.log(1.0 - input + epsilon))


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1.0, input,
                               torch.relu(margin - input)), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    from .common import cosine_similarity
    cos = cosine_similarity(input1, input2, axis=1)
    return _reduce(torch.where(label == 1, 1.0 - cos,
                               torch.relu(cos - margin)), reduction)


def _pnorm(x, p):
    return torch.linalg.vector_norm(x, ord=p, dim=-1)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    d_pos = _pnorm(input - positive + epsilon, p)
    d_neg = _pnorm(input - negative + epsilon, p)
    if swap:
        # the swapped distance is a constant to the gradient, as the
        # reference takes the minimum off its tape
        d_neg = torch.minimum(d_neg, _pnorm(positive - negative + epsilon,
                                            p)).detach()
    return _reduce(torch.relu(d_pos - d_neg + margin), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        distance_function = lambda a, b: _pnorm(a - b, 2)  # noqa: E731
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive,
                                                       negative)).detach()
    return _reduce(torch.relu(d_pos - d_neg + margin), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    ls = torch.nn.functional.logsigmoid
    loss = -(label * ls(input) + (1 - label) * ls(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log(1 + torch.exp(-label * input)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """``full`` (Stirling's term) is accepted and not added, as in the
    reference."""
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) * (input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    from .common import one_hot
    lab = label.squeeze(-1) if label.shape[-1] == 1 else label
    lab = one_hot(lab, input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * lab).sum(dim=dims)
    union = input.sum(dim=dims) + lab.sum(dim=dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.t()
    lab = labels.reshape(-1, 1)
    tgt = (lab == lab.t()).to(sim.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    ce = cross_entropy(sim, tgt, soft_label=True)
    reg = (anchor * anchor).sum() + (positive * positive).sum()
    return ce + l2_reg * reg * 0.25


# -- sequence losses ----------------------------------------------------------

def _ctc_op(log_probs, labels, input_lengths, label_lengths, blank):
    """Per-sequence CTC loss of log_probs (T, B, C) against labels (B, L),
    as the reference's lattice (optax's ``ctc_loss``, which takes its
    input through log_softmax first); f64 stays f64, lower precisions run
    in f32."""
    acc = torch.promote_types(log_probs.dtype, torch.float32)
    logp = torch.log_softmax(log_probs.to(acc), dim=-1)
    return torch.nn.functional.ctc_loss(
        logp, labels.long(), input_lengths.long(), label_lengths.long(),
        blank=int(blank), reduction="none")


register_op("ctc_loss_op", _ctc_op, "opaque")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    if norm_by_times and reduction != "mean":
        raise NotImplementedError(
            "ctc_loss(norm_by_times=True) with reduction != 'mean' is not "
            "supported; use reduction='mean' (where it is a no-op per the "
            "reference docs) or normalize the per-sequence losses by "
            "input_lengths explicitly")
    per_seq = apply("ctc_loss_op", log_probs, labels, input_lengths,
                    label_lengths, blank=int(blank))
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    denom = torch.clamp(label_lengths.to(torch.float32), min=1.0)
    return (per_seq / denom).mean()


def _rnnt_op(logits, labels, in_lens, lab_lens, blank, fastemit_lambda):
    """Negative log-likelihood of each sequence under the RNN-Transducer
    lattice (Graves 2012): logits (B, T, U+1, V), the alpha recursion in
    log space.  FastEmit scales the label emissions' gradient by
    (1 + lambda) and leaves the value alone, as the reference does."""
    b, t_len, u1, _ = logits.shape
    logp = torch.log_softmax(logits, dim=-1)
    lp_blank = logp[..., blank]                                # (B, T, U+1)
    lab_idx = torch.cat([labels.long(), torch.zeros(
        b, 1, dtype=torch.long, device=labels.device)], 1)     # (B, U+1)
    lp_lab = torch.gather(logp, 3, lab_idx[:, None, :, None].expand(
        b, t_len, u1, 1))[..., 0]
    if fastemit_lambda:
        lp_lab = lp_lab + fastemit_lambda * (lp_lab - lp_lab.detach())
    neg = torch.full((b,), -1e30, dtype=logp.dtype, device=logp.device)
    u_idx = torch.arange(u1, device=logp.device)
    past = u_idx[None, :] > lab_lens.long()[:, None]
    alphas = []
    alpha = None
    for t in range(t_len):
        if t == 0:
            from_blank = torch.where(u_idx[None, :] == 0, 0.0, -1e30).to(
                logp.dtype).expand(b, u1)
        else:
            from_blank = alpha + lp_blank[:, t - 1, :]
        cols = [from_blank[:, 0]]
        for u in range(1, u1):
            cols.append(torch.logaddexp(from_blank[:, u],
                                        cols[-1] + lp_lab[:, t, u - 1]))
        alpha = torch.where(past, neg[:, None], torch.stack(cols, 1))
        alphas.append(alpha)
    alphas = torch.stack(alphas, 1)                            # (B, T, U+1)
    bi = torch.arange(b, device=logp.device)
    tl, ul = in_lens.long() - 1, lab_lens.long()
    return -(alphas[bi, tl, ul] + lp_blank[bi, tl, ul])


register_op("rnnt_loss_op", _rnnt_op, "opaque")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    out = apply("rnnt_loss_op", input, label, input_lengths, label_lengths,
                blank=int(blank), fastemit_lambda=float(fastemit_lambda))
    return _reduce(out, reduction)


# -- tree, margin and sparse losses ------------------------------------------

def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over a complete binary tree: class l's leaf is
    heap id ``l + num_classes``, internal nodes 1..num_classes-1 own the
    rows of ``weight``; the loss is the BCE-with-logits summed along the
    path, (N, 1)."""
    lab = label.reshape(-1).long()
    c = int(num_classes)
    if path_table is not None or path_code is not None:
        pt = path_table.long()
        pc = path_code.to(input.dtype)
        valid = (pt >= 0).to(input.dtype)
        nodes = torch.clamp(pt, min=0)
    else:
        depth = int(np.ceil(np.log2(max(c, 2)))) + 1
        leaf = lab + c
        ks = torch.arange(1, depth + 1, device=input.device)
        heap = leaf[:, None] >> ks[None, :]
        valid = (heap >= 1).to(input.dtype)
        pc = ((leaf[:, None] >> (ks[None, :] - 1)) & 1).to(input.dtype)
        nodes = torch.clamp(heap - 1, min=0)
    wn = weight[nodes]                                        # (N, D, F)
    z = (input.unsqueeze(1) * wn).sum(dim=-1)
    if bias is not None:
        z = z + bias.reshape(-1)[nodes]
    per_node = torch.nn.functional.softplus(z, beta=1, threshold=20) \
        - z * pc
    return (per_node * valid).sum(dim=1).reshape(-1, 1)


def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,
                      weight=None, reduction: str = "mean", name=None):
    """mean over j of max(0, margin - x_y + x_j) ** p, j != y."""
    lab = label.reshape(-1).long()
    n, c = input.shape
    xy = input.gather(1, lab[:, None])
    diff = torch.clamp(margin - xy + input, min=0.0)
    if p == 2:
        diff = diff * diff
    mask = 1.0 - torch.eye(c, dtype=input.dtype, device=input.device)[lab]
    per = diff * mask
    if weight is not None:
        per = per * weight[lab][:, None]
    return _reduce(per.sum(dim=1) / c, reduction)


def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, group=None,
                         return_softmax: bool = False,
                         reduction: str = "mean", name=None):
    """ArcFace-family margin softmax at one device: the target logit
    becomes cos(m1 * theta + m2) - m3, then scaled softmax cross
    entropy."""
    lab = label.reshape(-1).long()
    n, c = logits.shape
    onehot = torch.eye(c, dtype=logits.dtype, device=logits.device)[lab]
    cos = torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7)
    target_cos = torch.cos(torch.acos(cos) * margin1 + margin2) - margin3
    z = (logits * (1.0 - onehot) + target_cos * onehot) * scale
    nll = -(torch.log_softmax(z, dim=-1) * onehot).sum(dim=-1)
    out = _reduce(nll, reduction)
    if return_softmax:
        return out, torch.softmax(z, dim=-1)
    return out


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the positions a (batch, head)'s CSR pattern lists:
    dense attention masked to them."""
    b, h, m, d = query.shape
    n = key.shape[2]
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    nnz = cols.shape[-1]
    rows = torch.searchsorted(off, torch.arange(nnz, device=off.device)
                              .expand(b, h, nnz).contiguous(),
                              right=True) - 1
    mask = torch.zeros(b, h, m, n, dtype=torch.bool, device=query.device)
    bi = torch.arange(b, device=off.device)[:, None, None].expand(b, h, nnz)
    hi = torch.arange(h, device=off.device)[None, :, None].expand(b, h, nnz)
    mask[bi, hi, rows, cols] = True
    scores = torch.einsum("bhmd,bhnd->bhmn", query, key) / math.sqrt(d)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :] > 0, scores,
                             torch.full_like(scores, -1e30))
    if attn_mask is not None:
        scores = scores + attn_mask
    probs = torch.exp(scores - scores.amax(-1, keepdim=True)) * mask
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)
    return torch.einsum("bhmn,bhnd->bhmd", probs, value)

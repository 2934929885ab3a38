"""Loss functionals: the hard-label cross-entropy.

Ports ``cross_entropy`` of paddle_tpu/nn/functional/loss.py, the path
``GPTPretrainLoss`` takes: integer labels over the class axis, logits
upcast to fp32, ``logsumexp - logit[label]`` per row without materialising
a log-softmax or a one-hot, rows whose label is ``ignore_index`` counted
as zero, ``mean`` taken over the valid rows only. The result comes back in
the logits' dtype, as the reference returns it (so bf16 logits give a
bf16 loss). Soft labels, ``weight``, ``label_smoothing`` and
``use_softmax=False`` are not ported yet and raise NotImplementedError.
"""
import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """input: logits [..., classes, ...] (classes on `axis`); label:
    integer ids of the logits' shape without `axis` (or with it of size
    1). reduction: ``mean`` (over rows whose label is not ignore_index),
    ``sum`` or ``none``."""
    if soft_label or tuple(label.shape) == tuple(input.shape):
        raise NotImplementedError("soft-label cross_entropy is not ported "
                                  "yet")
    if weight is not None:
        raise NotImplementedError("cross_entropy(weight=) is not ported yet")
    if label_smoothing > 0:
        raise NotImplementedError("cross_entropy(label_smoothing=) is not "
                                  "ported yet")
    if not use_softmax:
        raise NotImplementedError("cross_entropy(use_softmax=False) is not "
                                  "ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    ids = label
    if ids.dim() == input.dim() and ids.shape[axis] == 1:
        ids = ids.squeeze(axis)
    ids = ids.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    lf = input.float()
    picked = lf.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.logsumexp(lf, dim=axis) - picked
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        loss = loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    elif reduction == "sum":
        loss = loss.sum()
    return loss.to(input.dtype)

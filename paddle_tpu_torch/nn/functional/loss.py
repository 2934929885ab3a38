"""Loss functionals: ``cross_entropy`` and ``softmax_with_cross_entropy``.

Ports ``cross_entropy`` and ``softmax_with_cross_entropy`` of
paddle_tpu/nn/functional/loss.py (softmax_with_cross_entropy_op.cc
parity), every option of the reference:

- hard labels (integer ids of the logits' shape without `axis`, or with
  it of size 1), the path ``GPTPretrainLoss`` takes: logits upcast to
  fp32, ``logsumexp - logit[label]`` per row without materialising a
  log-softmax or a one-hot; with ``use_softmax=False`` the logits are
  probabilities and the row's loss is ``-log(clip(p[label], 1e-30))``;
  rows whose label is ``ignore_index`` count as zero; ``label_smoothing``
  by the reference's closed forms (``lse - mean(logits)`` as the uniform
  part, or ``-mean(log p)``); ``weight`` scales each row by
  ``weight[label]``, and its ``mean`` divides by the sum of the valid
  rows' weights. The result comes back in the logits' dtype (bf16 logits
  give a bf16 loss).
- soft labels (``soft_label=True``, or labels of the logits' shape):
  ``-sum(label * log_softmax(logits))`` over `axis`, the log-softmax in
  the logits' dtype (or ``log(clip(x, 1e-30))`` without softmax), the
  labels smoothed toward uniform first; ``weight`` and ``ignore_index``
  are not read, ``mean`` is over every row, and the result is not cast
  back (it is in the promoted dtype of labels and logits), as in the
  reference.
"""
import torch


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _soft(input, label, axis, use_softmax, label_smoothing, reduction):
    n_classes = input.shape[axis]
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    soft = label
    if label_smoothing > 0:
        soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
    return _reduce(-torch.sum(soft * logp, dim=axis), reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """input: logits [..., classes, ...] (classes on `axis`), or
    probabilities with ``use_softmax=False``; label: integer ids of the
    input's shape without `axis` (or with it of size 1), or soft labels of
    the input's shape. reduction: ``mean``, ``sum`` or ``none``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    if soft_label or tuple(label.shape) == tuple(input.shape):
        return _soft(input, label, axis, use_softmax, label_smoothing,
                     reduction)
    ids = label.detach()
    if ids.dim() == input.dim() and ids.shape[axis] == 1:
        ids = ids.squeeze(axis)
    ids = ids.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    lf = input.float()
    if use_softmax:
        picked = lf.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        lse = torch.logsumexp(lf, dim=axis)
        loss = lse - picked
        if label_smoothing > 0:
            # -sum(logp) / n = lse - mean(logits)
            loss = (1 - label_smoothing) * loss \
                + label_smoothing * (lse - lf.mean(dim=axis))
    else:
        loglf = torch.log(torch.clamp(lf, min=1e-30))
        loss = -loglf.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss \
                - label_smoothing * loglf.mean(dim=axis)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w = weight.detach().to(loss.device)
        wt = w[safe] * valid
        loss = loss * wt
        if reduction == "mean":
            return (loss.sum() / torch.clamp(wt.sum(), min=1e-12)).to(
                input.dtype)
    if reduction == "mean":
        loss = loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    elif reduction == "sum":
        loss = loss.sum()
    return loss.to(input.dtype)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-row loss of ``cross_entropy(reduction="none")`` with `axis`
    kept (size 1), and the softmax when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss

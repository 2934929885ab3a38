"""Normalization functionals: ``batch_norm`` and ``layer_norm``.

Ports ``batch_norm`` of paddle_tpu/nn/functional/norm.py (:19) by the
reference's formula ``(x - mean) / sqrt(var + eps) * weight + bias`` over
the channel axis. A bf16 x with fp32 statistics gives fp32, as jnp's
promotion does.

- Inference (``training=False``, or ``use_global_stats``): the running
  statistics (:60-69).
- Training: the batch's mean and *biased* variance over every axis but the
  channel's (the reference's ``jnp.var``), which the gradient flows
  through; and the running statistics updated IN PLACE, as
  ``running = momentum * running + (1 - momentum) * batch`` with the
  biased variance (operators/batch_norm_op.cc's convention, momentum 0.9
  by default). Both differ from ``torch.nn.functional.batch_norm``, which
  updates with the unbiased variance and the opposite momentum.
"""
import torch


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    ch_axis = x.ndim - 1 if data_format.endswith("C") \
        and data_format != "NC" else 1
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    if training and not use_global_stats:
        axes = tuple(i for i in range(x.ndim) if i != ch_axis)
        mean = x.mean(axes)
        var = x.var(axes, correction=0)
        with torch.no_grad():
            for run, batch in ((running_mean, mean), (running_var, var)):
                run.copy_(momentum * run
                          + (1 - momentum) * batch.detach().to(run.dtype))
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                 + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True).to(x.dtype)
    var = xf.var(axes, correction=0, keepdim=True).to(x.dtype)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out

"""Normalization functionals: the inference branch of ``batch_norm``.

Ports ``batch_norm`` of paddle_tpu/nn/functional/norm.py (:19) with the
running statistics (the eval branch, :60-69), by the reference's formula
``(x - mean) / sqrt(var + eps) * weight + bias`` over the channel axis.
A bf16 x with fp32 statistics gives fp32, as jnp's promotion does.
Training with batch statistics (and the running-statistics update) is
not ported yet and raises.
"""
import torch


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    if training and not use_global_stats:
        raise NotImplementedError(
            "batch_norm with batch statistics (training=True) is not ported "
            "yet: call model.eval(), or pass use_global_stats=True")
    ch_axis = x.ndim - 1 if data_format.endswith("C") \
        and data_format != "NC" else 1
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    out = (x - running_mean.reshape(shape)) \
        / torch.sqrt(running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out

"""Numeric debugging: FLAGS_check_nan_inf.

Ports paddle_tpu/amp/debugging.py (framework/details/nan_inf_utils_detail.cc
parity): ``NaNInfError``, ``check_numerics`` (raise if a floating tensor
holds a NaN or an inf; one host read) and ``enable_check_nan_inf``, a
context that sets ``FLAGS_check_nan_inf`` (which the trainer's guard
reads) and clears it on exit. Where the reference also enters
``jax.debug_nans`` (which raises at the first jitted op that makes a NaN),
the port enters ``torch.autograd.set_detect_anomaly(True,
check_nan=True)``, which raises at the first backward function that
returns a NaN and names the forward op that made it; a NaN made in a
forward is caught by the trainer's guard instead.
"""
import contextlib

import torch

from .. import flags


class NaNInfError(FloatingPointError):
    pass


def check_numerics(tensor, op_name="op"):
    if torch.is_floating_point(tensor) \
            and not bool(torch.isfinite(tensor).all().item()):
        raise NaNInfError(f"NaN/Inf found in output of {op_name}")
    return tensor


@contextlib.contextmanager
def enable_check_nan_inf():
    flags.set_flags({"check_nan_inf": True})
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            yield
    finally:
        flags.set_flags({"check_nan_inf": False})

"""Automatic mixed precision (ports paddle_tpu/amp/)."""
from .auto_cast import amp_dtype, amp_guard, amp_state, auto_cast

__all__ = ["amp_dtype", "amp_guard", "amp_state", "auto_cast"]

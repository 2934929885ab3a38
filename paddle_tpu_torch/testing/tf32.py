"""The fp32 flash kernels' TF32 tensor-core arithmetic in plain torch, for
the CPU tests that hold it against the plain versions (no counterpart in
paddle_tpu/): csrc/flash_tf32.cuh forms every product of the fp32 forward
and backward kernels in three TF32 passes."""
import torch


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: to the nearest value
    with 10 mantissa bits, ties away from zero (add half of the dropped
    13 bits' unit to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3(a, b):
    """a @ b as the kernels form it: each operand split into big =
    tf32(x) and small = tf32(x - big), and small(a) big(b) + big(a)
    small(b) + big(a) big(b) summed in fp32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def tf32x1(a, b):
    """a @ b from one TF32 pass: both operands rounded to TF32."""
    return tf32(a) @ tf32(b)

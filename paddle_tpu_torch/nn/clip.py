"""Gradient clipping.

Ports paddle_tpu/nn/clip.py (python/paddle/fluid/clip.py parity):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``, each
a callable from a list of ``(param, grad)`` pairs to a new list (the
grads it is given are not changed), the ``GradientClip*`` aliases and
``clip_grad_norm_``, which scales ``p.grad`` in place. As in the
reference:

- norms accumulate in fp32 and a scaled grad goes back to its own dtype
  (a bf16 grad is multiplied by the fp32 scale in fp32, then rounded);
- a parameter whose ``need_clip`` attribute is False is left out of the
  global norm and its grad passes unscaled (the attribute defaults to
  True);
- the global-norm scale ``clip_norm / max(norm, clip_norm)`` stays a
  device tensor: nothing is read back to the host.

``global_norm`` is the fp32 norm over a list of grads: one
``torch._foreach_norm`` over the list rather than one reduction a tensor.
The optimizers' ``functional_apply`` (the trainer's update) applies only
``ClipGradByGlobalNorm``, as the reference's does.
"""
import torch


def _scaled(g, scale):
    """g * scale in their promoted dtype, rounded back to g's dtype (a 0-d
    fp32 scale widens a bf16 grad, as a JAX array does)."""
    wide = torch.promote_types(g.dtype, scale.dtype)
    return (g.to(wide) * scale).to(g.dtype)


def global_norm(grads):
    """sqrt(sum of every grad's squares), accumulated in fp32, as a 0-d
    fp32 tensor on the grads' device."""
    norms = torch._foreach_norm(list(grads), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def scale_grads_(grads, scale):
    """Multiply every grad by the 0-d fp32 `scale` in place: one foreach
    call for the fp32 grads, the promoted product for the others."""
    wide = [g for g in grads if g.dtype == torch.float32]
    if wide:
        torch._foreach_mul_(wide, scale)
    for g in grads:
        if g.dtype != torch.float32:
            g.copy_(_scaled(g, scale))


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g.float() ** 2))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def scale(self, norm):
        """clip_norm / max(norm, clip_norm), a 0-d fp32 tensor."""
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    def __call__(self, params_grads):
        clipped = [g for p, g in params_grads
                   if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return list(params_grads)
        scale = self.scale(global_norm(clipped))
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else _scaled(g, scale)) for p, g in params_grads]


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place so their joint `norm_type` norm is
    at most `max_norm`; return the norm before scaling (fp32, or the
    grads' dtype for the inf norm, as the reference returns it).
    ``error_if_nonfinite`` is accepted and not read, as in the
    reference."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = torch.sum(torch.stack([
            torch.sum(torch.abs(g.float()) ** norm_type) for g in grads])) \
            ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = _scaled(p.grad, scale)
    return total

"""Loss scaling.

Ports paddle_tpu/amp/grad_scaler.py: ``AmpScaler`` and ``GradScaler``
(python/paddle/fluid/dygraph/amp/loss_scaler.py AmpScaler:27 and
paddle/amp/grad_scaler.py): ``scale``, ``minimize``, ``step``,
``unscale_``, ``update`` (dynamic scaling by the incr / decr ratios and
their step counters), ``state_dict`` and ``load_state_dict``.

``unscale_`` multiplies every grad by 1 / scale in place (the scalar
rounded to each grad's dtype, as the reference's python float meets a
JAX array) and takes one device verdict over all of them, read back with
one ``.item()``, where the reference reads one per parameter: the same
``found_inf``. A step with a non-finite grad calls no optimizer step, so
the parameters and the optimizer state stay bit-identical.
"""
import torch

from ..optimizer.optimizer import _weak


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * _weak(self._scale, var)

    def minimize(self, optimizer, scaled_loss, *args, **kwargs):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameters if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            torch._foreach_mul_(group, _weak(inv, group[0]))
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self._found_inf = not bool(finite.item())

    def update(self):
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


class GradScaler(AmpScaler):
    pass

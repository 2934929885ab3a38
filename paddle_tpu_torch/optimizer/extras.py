"""Averaging and wrapping optimizers: ExponentialMovingAverage,
ModelAverage and LookAhead.

Ports paddle_tpu/optimizer/extras.py (python/paddle/fluid/optimizer.py
ModelAverage:3157 and ExponentialMovingAverage:3466, and the incubate
LookAhead optimizer). Each keeps shadow tensors beside the live
parameters; where the reference rebinds a parameter's array, the port
copies into the parameter in place (in its own dtype), and ``apply``
swaps the averaged values in and ``restore`` puts back clones of the
originals.
"""
import contextlib

import torch

from .optimizer import Optimizer, _weak


class _Swap:
    """apply / restore over ``self._parameters``, with ``_averaged(p)``
    giving the values to swap in."""

    @contextlib.contextmanager
    @torch.no_grad()
    def apply(self, need_restore=True):
        self._backup = {id(p): p.detach().clone() for p in self._parameters}
        for p in self._parameters:
            p.copy_(self._averaged(p))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self):
        if self._backup is None:
            return
        for p in self._parameters:
            p.copy_(self._backup[id(p)])
        self._backup = None


class ExponentialMovingAverage(_Swap):
    """shadow = decay * shadow + (1 - decay) * param, bias-corrected by
    1 - decay^t in ``apply`` (fluid/optimizer.py:3466, thres_steps-free
    form; the shadow starts at 0)."""

    def __init__(self, parameters, decay=0.999, name=None):
        self._decay = float(decay)
        self._parameters = list(parameters)
        self._shadow = {id(p): torch.zeros_like(p.detach())
                        for p in self._parameters}
        self._step = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        for p in self._parameters:
            s = self._shadow[id(p)]
            self._shadow[id(p)] = _weak(d, s) * s + _weak(1.0 - d, p) * p

    def _averaged(self, p):
        corr = 1.0 - self._decay ** max(self._step, 1)
        s = self._shadow[id(p)]
        return (s / _weak(corr, s)).to(p.dtype)


class ModelAverage(_Swap):
    """Running average of the parameters over a sliding window
    (fluid/optimizer.py:3157): ``update()`` each step, ``apply()`` swaps
    the averages in for evaluation."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._parameters = list(parameters or [])
        self._sum = {id(p): torch.zeros_like(p.detach())
                     for p in self._parameters}
        self._num = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        # the window restarts once it outgrows max(min_window,
        # rate * steps), as the reference's does
        window = max(self._min_w, min(self._max_w,
                                      int(self._rate * (self._num + 1))
                                      or 1))
        if self._num >= window:
            self._num = 0
            for p in self._parameters:
                self._sum[id(p)] = torch.zeros_like(p.detach())
        self._num += 1
        for p in self._parameters:
            self._sum[id(p)] = self._sum[id(p)] + p

    def _averaged(self, p):
        s = self._sum[id(p)]
        return (s / _weak(max(self._num, 1), s)).to(p.dtype)


class LookAhead(Optimizer):
    """k-step lookahead around an inner optimizer: every k inner steps the
    slow weights move alpha of the way toward the fast ones and the fast
    weights take the slow values (incubate LookaheadOptimizer parity)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self._alpha = float(alpha)
        self._k = int(k)
        self._parameters = inner_optimizer._parameters
        self._slow = {id(p): p.detach().clone() for p in self._parameters}
        self._count = 0

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, value):
        self.inner_optimizer.set_lr(value)

    def set_lr_scheduler(self, scheduler):
        self.inner_optimizer.set_lr_scheduler(scheduler)

    @property
    def _learning_rate(self):
        return self.inner_optimizer._learning_rate

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._count += 1
        if self._count % self._k == 0:
            for p in self._parameters:
                s = self._slow[id(p)]
                slow = s + _weak(self._alpha, s) * (p - s)
                self._slow[id(p)] = slow
                p.copy_(slow.to(p.dtype))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameters]

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def set_state_dict(self, state):
        self.inner_optimizer.set_state_dict(state)

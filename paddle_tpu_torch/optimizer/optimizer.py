"""Optimizer base, SGD, Momentum, Adam and AdamW.

Ports paddle_tpu/optimizer/optimizer.py: ``Optimizer`` (``step``,
``clear_grad``, ``state_dict``, ``set_state_dict``, ``functional_init``,
``functional_apply``), ``SGD`` (:181, ``p - lr * g``), ``Momentum``
(:188, ``v = momentum * v + g``, then ``p - lr * v``, or with Nesterov
``p - lr * (g + momentum * v)``: operators/optimizers/momentum_op.cc),
``Adam`` and ``AdamW`` with the reference's update rules
(operators/optimizers/adam_op.cc, adamw.py). Adam's and AdamW's differ
from ``torch.optim.AdamW``:

- bias correction goes into the step size, lr_t = lr * sqrt(1 - beta2^t) /
  (1 - beta1^t), and epsilon is added to the *uncorrected* sqrt(v);
- AdamW decays first, p <- p * (1 - lr * wd), then takes the Adam step;
- the decay applies to every parameter, biases and LayerNorm weights too
  (the reference stores ``apply_decay_param_fun`` and never reads it).

The rules are plain torch ops in the reference's dtypes and rounding order:
the moments start in the parameter's dtype, the beta powers and the step
size lr_t are fp32, and lr_t is rounded to the parameter's dtype before it
scales the step; the rules' python scalars (betas, epsilon) meet an array
as its dtype holds them, as JAX's weak types do, and the fp32 weight-decay
array widens what it meets (Adam's L2 term turns a bf16 grad, and with it
the moments, fp32; AdamW's decoupled decay keeps them bf16). Unlike
the reference, whose rules are
pure functions returning new arrays, the port updates parameters and
optimizer state IN PLACE: ``step`` and ``functional_apply`` mutate the
tensors they are given and return them.

A float learning rate and a float weight decay only: ``LRScheduler``
learning rates, regularizer objects (``L2Decay`` / ``L1Decay``) and
``grad_clip`` are not ported yet and raise NotImplementedError.
"""
import torch


def _scalar(value, device):
    return torch.tensor(float(value), dtype=torch.float32, device=device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) \
                or not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate={learning_rate!r}: only a float learning "
                "rate is ported (LRScheduler is not ported yet)")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if weight_decay is not None and (
                isinstance(weight_decay, bool)
                or not isinstance(weight_decay, (int, float))):
            raise NotImplementedError(
                f"weight_decay={weight_decay!r}: only a float weight decay "
                "is ported (regularizer objects are not ported yet)")
        self._lr = float(learning_rate)
        self._parameters = list(parameters) if parameters is not None \
            else []
        self._wd = float(weight_decay or 0.0)
        self._state = {}        # id(param) -> state dict (step())
        self._step_count = 0

    # -- learning rate ---------------------------------------------------
    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    # -- state -----------------------------------------------------------
    def _get_state(self, p):
        k = id(p)
        if k not in self._state:
            self._state[k] = self._init_state(p)
        return self._state[k]

    def _init_state(self, p):
        return {}

    # -- update rule (in place; overridden per optimizer) ----------------
    def _rule(self, p, g, state, lr):
        raise NotImplementedError

    def _rule_with_decay(self, p, g, state, lr, wd):
        # L2 regularization folded into the grad (paddle regularizer
        # semantics), with the reference's promotion: its wd is an fp32
        # array, so a bf16 grad comes out fp32; decoupled decay (AdamW)
        # overrides this
        wide = torch.promote_types(g.dtype, wd.dtype)
        self._rule(p, g.to(wide) + wd * p.to(wide), state, lr)

    # -- public API ------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a grad, in place."""
        self._step_count += 1
        scalars = {}
        for p in self._parameters:
            if p.grad is None or not p.requires_grad:
                continue
            if p.device not in scalars:
                scalars[p.device] = (_scalar(self.get_lr(), p.device),
                                     _scalar(self._wd, p.device))
            lr, wd = scalars[p.device]
            self._rule_with_decay(p, p.grad.to(p.dtype), self._get_state(p),
                                  lr, wd)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    def _key(self, i, p):
        return f"{getattr(p, 'name', None) or i}"

    def state_dict(self):
        """{"LR_Scheduler": {}, "<param>_<slot>": tensor, ..., "step": n}
        with the reference's keys (a parameter without a ``name`` is keyed
        by its index). The tensors are copies."""
        out = {"LR_Scheduler": {}}
        for i, p in enumerate(self._parameters):
            for k, v in self._state.get(id(p), {}).items():
                out[f"{self._key(i, p)}_{k}"] = v.detach().clone()
        out["step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        self._step_count = state.get("step", 0)
        for i, p in enumerate(self._parameters):
            st = self._init_state(p)
            loaded = False
            for k in st:
                key = f"{self._key(i, p)}_{k}"
                if key in state:
                    # the saved slot's dtype (Adam's moments may have
                    # widened past the parameter's)
                    st[k] = torch.as_tensor(state[key]).to(
                        st[k].device, copy=True)
                    loaded = True
            if loaded:
                self._state[id(p)] = st

    # -- functional view (the trainer's step) ----------------------------
    def functional_init(self, params):
        """params: dict name -> tensor. Returns the state dict {name: slot
        dict, "__step__": int32 0}."""
        states = {n: self._init_state(p) for n, p in params.items()}
        device = next(iter(params.values())).device if params else "cpu"
        states["__step__"] = torch.zeros((), dtype=torch.int32,
                                         device=device)
        return states

    @torch.no_grad()
    def functional_apply(self, params, grads, states, lr=None):
        """Update every parameter from its grad, IN PLACE (parameters and
        states are mutated), and advance ``__step__``. Returns (params,
        states), the same dicts."""
        lr = self.get_lr() if lr is None else lr
        scalars = {}
        for n, p in params.items():
            if p.device not in scalars:
                scalars[p.device] = (_scalar(lr, p.device),
                                     _scalar(self._wd, p.device))
            g = grads[n]
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            self._rule_with_decay(p, g, states[n], *scalars[p.device])
        states["__step__"] += 1
        return params, states


class SGD(Optimizer):
    """operators/optimizers/sgd_op.cc parity."""

    def _rule(self, p, g, state, lr):
        p.sub_((lr.to(p.dtype) * g).to(p.dtype))


class Momentum(Optimizer):
    """operators/optimizers/momentum_op.cc parity (incl. nesterov): the
    velocity starts in the parameter's dtype and widens with a wider grad,
    as the reference's sum does."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        self._momentum = momentum
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _rule(self, p, g, state, lr):
        mu = self._momentum
        v = state["velocity"]
        if v.dtype != torch.promote_types(v.dtype, g.dtype):
            v = state["velocity"] = (v * mu).to(g.dtype) + g
        else:
            v.mul_(mu).add_(g)
        step = g + mu * v if self._nesterov else v
        p.sub_((lr.to(p.dtype) * step).to(p.dtype))


class Adam(Optimizer):
    """operators/optimizers/adam_op.cc parity (bias-corrected via beta-pow
    state)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._rounded = {}       # dtype -> the rule's scalars in that dtype
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device),
                "beta2_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _scalars(self, dtype):
        """(beta1, 1 - beta1, beta2, 1 - beta2, epsilon) rounded to `dtype`:
        the reference's python scalars meet arrays of that dtype as weak
        types, so a bf16 moment is scaled by bf16(0.9), not by 0.9."""
        if dtype not in self._rounded:
            b1, b2 = self._beta1, self._beta2
            self._rounded[dtype] = tuple(
                torch.tensor([b1, 1 - b1, b2, 1 - b2, self._eps],
                             dtype=torch.float64).to(dtype).tolist())
        return self._rounded[dtype]

    def _rule(self, p, g, state, lr):
        state["beta1_pow"].mul_(self._beta1)
        state["beta2_pow"].mul_(self._beta2)
        m, v = state["moment1"], state["moment2"]
        b1, _, b2, _, _ = self._scalars(m.dtype)
        wide = torch.promote_types(m.dtype, g.dtype)
        if m.dtype != wide:
            # a grad wider than the moments (Adam's L2 term widens it)
            # widens them, as the reference's sum of the two does
            m, v = (m * b1).to(wide), (v * b2).to(wide)
            state["moment1"], state["moment2"] = m, v
        else:
            m.mul_(b1)
            v.mul_(b2)
        _, c1, _, c2, _ = self._scalars(g.dtype)
        m.add_(c1 * g)
        v.add_(c2 * (g * g))
        lr_t = lr * torch.sqrt(1 - state["beta2_pow"]) \
            / (1 - state["beta1_pow"])
        eps = self._scalars(v.dtype)[4]
        p.sub_((lr_t.to(p.dtype) * m / (torch.sqrt(v) + eps)).to(p.dtype))


class AdamW(Adam):
    """python/paddle/optimizer/adamw.py parity: decoupled weight decay on
    every parameter, applied before the Adam step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW(lr_ratio=) is not ported yet")
        # apply_decay_param_fun is accepted and never read: the reference
        # stores it and decays every parameter all the same
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _rule_with_decay(self, p, g, state, lr, wd):
        # decoupled: p -= lr*wd*p before the Adam update
        p.mul_(1.0 - lr.to(p.dtype) * wd.to(p.dtype))
        self._rule(p, g, state, lr)

"""The optimizer base and the optimizer family.

Ports paddle_tpu/optimizer/optimizer.py: ``Optimizer`` (``step``,
``minimize``, ``clear_grad``, ``state_dict``, ``set_state_dict``,
``functional_init``, ``functional_apply``), ``SGD`` (:181, ``p - lr * g``), ``Momentum``
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

The learning rate is a number or an ``optimizer.lr.LRScheduler``, read
as ``scheduler()`` (its cached ``last_lr``; ``get_lr()`` would step a
``LinearWarmup``'s inner schedule). The weight decay is a number or an
``L2Decay`` / ``L1Decay`` object (L1 adds ``wd * sign(p)`` to the grad;
AdamW's decoupled decay reads the same coefficient). ``grad_clip`` is any
clip object of ``nn.clip``: eager ``step`` applies it to the
``(param, grad)`` pairs, while ``functional_apply`` (the trainer's
update) applies only ``ClipGradByGlobalNorm`` and lets any other clip
pass unapplied, as the reference's does.

The other optimizers (``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSProp``,
``Lamb``, ``Lars`` / ``LarsMomentum``, ``Ftrl``, ``Dpsgd``) follow the
reference's rules out of place in its dtypes (a 0-d fp32 array widens a
bf16 one, a python scalar takes the array's dtype), then write the new
parameter into the old one in place, in the parameter's own dtype, and
keep the new state tensors (which may be wider than the parameter, as
the reference's are). ``Dpsgd`` draws its noise from the port's
generator of the parameter's device (``core.generator``), so its bits
cannot match the reference's JAX key.
"""
import torch

from ..core import generator as _generator
from ..nn.clip import ClipGradByGlobalNorm, global_norm, scale_grads_
from .lr import LRScheduler


def _scalar(value, device):
    return torch.tensor(float(value), dtype=torch.float32, device=device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"learning_rate={learning_rate!r}: a number or a "
                "paddle_tpu_torch.optimizer.lr.LRScheduler")
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError(f"grad_clip={grad_clip!r}: a clip object of "
                            "paddle_tpu_torch.nn.clip")
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._parameters = list(parameters) if parameters is not None \
            else []
        self._grad_clip = grad_clip
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._wd = float(weight_decay or 0.0)
            self._wd_is_l2 = True
        else:                   # an L2Decay / L1Decay object
            self._wd = float(getattr(weight_decay, "_coeff",
                                     getattr(weight_decay, "coeff", 0.0)))
            self._wd_is_l2 = type(weight_decay).__name__ != "L1Decay"
        self._state = {}        # id(param) -> state dict (step())
        self._step_count = 0
        # the global grad norm the last functional_apply clipped by (a 0-d
        # device tensor, never read back here)
        self._global_norm = None

    # -- learning rate ---------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

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
        # L2 (wd * p) or L1 (wd * sign(p)) regularization folded into the
        # grad (paddle regularizer semantics), with the reference's
        # promotion: its wd is an fp32 array, so a bf16 grad comes out
        # fp32; decoupled decay (AdamW) overrides this
        wide = torch.promote_types(g.dtype, wd.dtype)
        term = p if self._wd_is_l2 else torch.sign(p)
        self._rule(p, g.to(wide) + wd * term.to(wide), state, lr)

    # -- public API ------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a grad, in place, after
        ``grad_clip`` (any clip object) has seen the (param, grad) pairs."""
        self._step_count += 1
        params_grads = [(p, p.grad) for p in self._parameters
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        scalars = {}
        for p, g in params_grads:
            if g is None:
                continue
            if p.device not in scalars:
                scalars[p.device] = (_scalar(self.get_lr(), p.device),
                                     _scalar(self._wd, p.device))
            lr, wd = scalars[p.device]
            self._rule_with_decay(p, g.to(p.dtype), self._get_state(p),
                                  lr, wd)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``; returns (None, [(param,
        grad), ...]). The reference's static-program branch is not
        ported."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameters]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def _key(self, i, p):
        return f"{getattr(p, 'name', None) or i}"

    def state_dict(self):
        """{"LR_Scheduler": the scheduler's state_dict or {},
        "<param>_<slot>": tensor, ..., "step": n} with the reference's keys
        (a parameter without a ``name`` is keyed by its index). The
        tensors are copies."""
        out = {"LR_Scheduler": self._lr.state_dict()
               if isinstance(self._lr, LRScheduler) else {}}
        for i, p in enumerate(self._parameters):
            for k, v in self._state.get(id(p), {}).items():
                out[f"{self._key(i, p)}_{k}"] = v.detach().clone()
        out["step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        if isinstance(self._lr, LRScheduler) and state.get("LR_Scheduler"):
            self._lr.set_state_dict(state["LR_Scheduler"])
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
        """Update every parameter from its grad, IN PLACE (parameters,
        grads and states are mutated), and advance ``__step__``. A
        ``ClipGradByGlobalNorm`` first scales every grad by
        clip_norm / max(global norm, clip_norm); any other clip is not
        applied (the reference's trainer path). Returns (params, states),
        the same dicts."""
        lr = self.get_lr() if lr is None else lr
        if isinstance(self._grad_clip, ClipGradByGlobalNorm):
            present = [g for g in grads.values() if g is not None]
            if present:
                self._global_norm = global_norm(present)
                scale_grads_(present, self._grad_clip.scale(self._global_norm))
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
        # lr_ratio and apply_decay_param_fun are accepted and never read:
        # the reference drops the one, stores the other and decays every
        # parameter with the same rate all the same
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _rule_with_decay(self, p, g, state, lr, wd):
        # decoupled: p -= lr*wd*p before the Adam update
        p.mul_(1.0 - lr.to(p.dtype) * wd.to(p.dtype))
        self._rule(p, g, state, lr)


# -- the other optimizers: the reference's rules out of place ---------------

def _weak(x, t):
    """The python scalar `x` as an array of `t`'s dtype meets it: rounded
    to that dtype (JAX's weak typing)."""
    return torch.tensor(float(x), dtype=torch.float64).to(t.dtype).item()


def _strong(s, t):
    """A 0-d tensor `s` and an array `t` in their promoted dtype: a 0-d
    JAX array takes part in promotion, a 0-d torch tensor would not."""
    wide = torch.promote_types(s.dtype, t.dtype)
    return s.to(wide), t.to(wide)


def _fp32_norm(t):
    return torch.sqrt(torch.sum(t.float() ** 2))


class _OutOfPlace(Optimizer):
    """Base of the ported rules written as the reference writes them:
    ``_new(p, g, state, lr) -> (new_p, new_state)``; ``_rule`` writes
    new_p into p and keeps the new state tensors."""

    def _rule(self, p, g, state, lr):
        new_p, new_state = self._new(p, g, state, lr)
        p.copy_(new_p)
        state.update(new_state)


class Adagrad(_OutOfPlace):
    """operators/optimizers/adagrad_op.cc parity."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _new(self, p, g, state, lr):
        mom = state["moment"] + g * g
        lr_p, g_ = _strong(lr.to(p.dtype), g)
        step = lr_p * g_ / (torch.sqrt(mom) + _weak(self._eps, mom))
        return p - step, {"moment": mom}


class Adadelta(_OutOfPlace):
    """operators/optimizers/adadelta_op.cc parity."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._eps = epsilon
        self._rho = rho
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _new(self, p, g, state, lr):
        rho, eps = self._rho, self._eps
        asg0, asu0 = state["avg_squared_grad"], state["avg_squared_update"]
        asg = _weak(rho, asg0) * asg0 + _weak(1 - rho, g) * g * g
        update = -torch.sqrt(asu0 + _weak(eps, asu0)) \
            / torch.sqrt(asg + _weak(eps, asg)) * g
        asu = _weak(rho, asu0) * asu0 \
            + _weak(1 - rho, update) * update * update
        lr_p, u = _strong(lr.to(p.dtype), update)
        return p + lr_p * u, {"avg_squared_grad": asg,
                              "avg_squared_update": asu}


class Adamax(_OutOfPlace):
    """operators/optimizers/adamax_op.cc parity."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _new(self, p, g, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = state["beta1_pow"] * b1
        m0, inf0 = state["moment"], state["inf_norm"]
        m = _weak(b1, m0) * m0 + _weak(1 - b1, g) * g
        inf = torch.maximum(_weak(b2, inf0) * inf0,
                            torch.abs(g) + _weak(eps, g))
        step_p, m_ = _strong((lr / (1 - b1p)).to(p.dtype), m)
        return p - step_p * m_ / inf, {"moment": m, "inf_norm": inf,
                                       "beta1_pow": b1p}


class RMSProp(_OutOfPlace):
    """operators/optimizers/rmsprop_op.cc parity (centered option)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p),
              "moment": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def _new(self, p, g, state, lr):
        rho, eps = self._rho, self._eps
        ms0, mom0 = state["mean_square"], state["moment"]
        ms = _weak(rho, ms0) * ms0 + _weak(1 - rho, g) * g * g
        new_state = {"mean_square": ms}
        if self._centered:
            mg0 = state["mean_grad"]
            mg = _weak(rho, mg0) * mg0 + _weak(1 - rho, g) * g
            d = ms - mg * mg
            denom = torch.sqrt(d + _weak(eps, d))
            new_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + _weak(eps, ms))
        lr_p, g_ = _strong(lr.to(p.dtype), g)
        mom = _weak(self._momentum, mom0) * mom0 + lr_p * g_ / denom
        new_state["moment"] = mom
        return p - mom, new_state


class Lamb(_OutOfPlace):
    """operators/optimizers/lamb_op.cc parity (trust-ratio layerwise
    adaptation; the norms are fp32)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        # stored and never read, as in the reference
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device),
                "beta2_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _new(self, p, g, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m0, v0 = state["moment1"], state["moment2"]
        m = _weak(b1, m0) * m0 + _weak(1 - b1, g) * g
        v = _weak(b2, v0) * v0 + _weak(1 - b2, g) * g * g
        c1, m_ = _strong(1 - b1p, m)
        c2, v_ = _strong(1 - b2p, v)
        m_hat, v_hat = m_ / c1, v_ / c2
        r = m_hat / (torch.sqrt(v_hat) + _weak(eps, v_hat)) \
            + _weak(self._lamb_wd, p) * p
        w_norm, r_norm = _fp32_norm(p), _fp32_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        step_p, r_ = _strong((lr * ratio).to(p.dtype), r)
        return p - step_p * r_, {"moment1": m, "moment2": v,
                                 "beta1_pow": b1p, "beta2_pow": b2p}


class Lars(Momentum):
    """operators/optimizers/lars_momentum_op.cc parity (the norms are
    fp32)."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip)

    def _rule(self, p, g, state, lr):
        p_norm, g_norm = _fp32_norm(p), _fp32_norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm
            / (g_norm + self._lars_wd * p_norm + self._lars_eps),
            torch.ones_like(p_norm))
        v0 = state["velocity"]
        step_p, d = _strong((lr * local_lr).to(p.dtype),
                            g + _weak(self._lars_wd, p) * p)
        v = _weak(self._momentum, v0) * v0 + step_p * d
        p.copy_(p - v)
        state["velocity"] = v


LarsMomentum = Lars


class Ftrl(_OutOfPlace):
    """operators/optimizers/ftrl_op.cc parity."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._l1, self._l2, self._lr_power = l1, l2, lr_power
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _init_state(self, p):
        return {"squared": torch.zeros_like(p), "linear": torch.zeros_like(p)}

    def _new(self, p, g, state, lr):
        l1, l2, lrp = self._l1, self._l2, self._lr_power
        sq0, lin0 = state["squared"], state["linear"]
        new_sq = sq0 + g * g
        pw_new = new_sq ** _weak(-lrp, new_sq)
        num, lr_p = _strong(pw_new - sq0 ** _weak(-lrp, sq0),
                            lr.to(p.dtype))
        sigma = num / lr_p
        lin = lin0 + g - sigma * p
        den_a, lr_p = _strong(pw_new, lr.to(p.dtype))
        den = den_a / lr_p + _weak(2 * l2, den_a)
        pre = torch.where(torch.abs(lin) > _weak(l1, lin),
                          (torch.sign(lin) * _weak(l1, lin) - lin) / den,
                          torch.zeros_like(p))
        return pre, {"squared": new_sq, "linear": lin}


class Dpsgd(SGD):
    """operators/optimizers/dpsgd_op.cc (differentially-private SGD): the
    grad clipped to norm `clip`, plus Gaussian noise of std
    sigma * clip / batch_size drawn from the port's generator of the
    parameter's device."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16,
                 sigma=1.0, parameters=None, name=None):
        self._clip_v = clip
        self._sigma = sigma
        self._batch = batch_size
        super().__init__(learning_rate, parameters)

    def _rule(self, p, g, state, lr):
        gnorm = _fp32_norm(g)
        den, g_ = _strong(torch.clamp(gnorm / self._clip_v, min=1.0), g)
        g = g_ / den
        noise = torch.randn(g.shape, dtype=g.dtype, device=g.device,
                            generator=_generator.default_generator(
                                g.device)) \
            * _weak(self._sigma * self._clip_v / self._batch, g)
        lr_p, d = _strong(lr.to(p.dtype), g + noise)
        p.copy_(p - lr_p * d)

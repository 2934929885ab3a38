"""The high-level ``Model``: batch-level training, evaluation and
prediction.

Ports ``Model`` of paddle_tpu/hapi/model.py (:182: ``__init__``,
``prepare`` :199, ``train_batch`` / ``eval_batch`` / ``predict_batch``
:219-226, ``parameters`` :346) over its eager adapter,
``DynamicGraphAdapter`` (:30-88):

- ``train_batch`` runs the network in training mode, the loss over its
  outputs and the labels (or the outputs' sum without a loss), then
  ``loss.backward()``, ``optimizer.step()`` and ``clear_grad()``, and
  returns ``[float(loss)]``;
- ``eval_batch`` runs the network in eval mode without grads and returns
  ``[float(loss)]`` (``[]`` without a loss); ``predict_batch`` returns the
  outputs as numpy arrays;
- inputs and labels (numpy arrays or tensors, one or a list) move to the
  network's device, and int32 / int16 / uint8 ones become int64, as
  ``distributed.SpmdTrainer`` moves a batch.

``save`` / ``load`` (:322-345) go through framework/io: the network's
``state_dict()`` to ``<path>.pdparams`` and the optimizer's to
``<path>.pdopt``; ``load`` takes the path with or without ``.pdparams``,
puts the tensors on the network's device, and restores the optimizer
unless ``reset_optimizer`` (or there is no ``.pdopt``).

Not ported yet (NotImplementedError, naming what is missing):
``use_jit=True`` (the compiled adapter), ``prepare(metrics=...)``
(``metric/``), ``prepare(amp_configs=...)``, ``save(training=False)``
(``jit/``), and ``fit``, ``evaluate``, ``predict``, ``summary`` and
``flops`` (they need ``io.DataLoader``, ``callbacks`` and the model
summary).
"""
import os

import numpy as np
import torch

from ..amp.auto_cast import disabled as _autocast_off
from ..framework import io as _io


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _not_ported(what, needs):
    raise NotImplementedError(f"Model.{what} is not ported yet (it needs "
                              f"{needs})")


class DynamicGraphAdapter:
    """The eager adapter: forward, backward and the optimizer's step."""

    def __init__(self, model):
        self.model = model

    def _device(self):
        p = next(self.model.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _batch(self, xs):
        dev = self._device()
        out = []
        for x in _to_list(xs):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            if t.dtype in (torch.int32, torch.int16, torch.uint8):
                t = t.long()
            out.append(t.to(dev))
        return out

    def _loss(self, outputs, labels):
        losses = self.model._loss(*(_to_list(outputs) + labels))
        return losses if isinstance(losses, torch.Tensor) else sum(losses)

    def train_batch(self, inputs, labels=None):
        net, opt = self.model.network, self.model._optimizer
        net.train()
        inputs, labels = self._batch(inputs), self._batch(labels)
        outputs = net(*inputs)
        loss = self._loss(outputs, labels) if self.model._loss \
            else sum(_to_list(outputs))
        with _autocast_off():
            loss.backward()
        opt.step()
        opt.clear_grad()
        return [float(loss.detach())]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        net = self.model.network
        net.eval()
        inputs, labels = self._batch(inputs), self._batch(labels)
        outputs = net(*inputs)
        if not self.model._loss:
            return []
        return [float(self._loss(outputs, labels))]

    @torch.no_grad()
    def predict_batch(self, inputs):
        net = self.model.network
        net.eval()
        outputs = net(*self._batch(inputs))
        return [o.detach().cpu().numpy() for o in _to_list(outputs)]


class Model:
    def __init__(self, network, inputs=None, labels=None, use_jit=False):
        if use_jit:
            raise NotImplementedError(
                "Model(use_jit=True) is not ported yet (it needs the "
                "compiled adapter over SpmdTrainer; the eager adapter is)")
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self.stop_training = False
        self._adapter = DynamicGraphAdapter(self)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise NotImplementedError("Model.prepare(metrics=...) is not "
                                      "ported yet (it needs metric/)")
        if amp_configs is not None:
            raise NotImplementedError("Model.prepare(amp_configs=...) is not "
                                      "ported yet")
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a Layer or function)")
        self._optimizer = optimizer
        self._loss = loss
        return self

    def train_batch(self, inputs, labels=None):
        return self._adapter.train_batch(inputs, labels)

    def eval_batch(self, inputs, labels=None):
        return self._adapter.eval_batch(inputs, labels)

    def predict_batch(self, inputs):
        return self._adapter.predict_batch(inputs)

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def fit(self, *args, **kwargs):
        _not_ported("fit", "io.DataLoader and hapi.callbacks")

    def evaluate(self, *args, **kwargs):
        _not_ported("evaluate", "io.DataLoader and hapi.callbacks")

    def predict(self, *args, **kwargs):
        _not_ported("predict", "io.DataLoader and hapi.callbacks")

    def save(self, path, training=True):
        """hapi/model.py:1043 parity: the training state (parameters and
        buffers, and the optimizer's) under `path`; ``training=False``
        (an inference program) needs ``jit/``."""
        if not training:
            _not_ported("save(training=False)", "jit/ (jit.save)")
        _io.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load a :meth:`save` (`path` with or without ``.pdparams``)
        onto the network's device; ``skip_mismatch`` loads the keys that
        match and ignores the rest."""
        base = path[:-len(".pdparams")] if path.endswith(".pdparams") \
            else path
        dev = self._adapter._device()
        state = _io.load(base + ".pdparams", device=dev)
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt_path = base + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_io.load(opt_path, device=dev))
        return self

    def summary(self, *args, **kwargs):
        _not_ported("summary", "hapi/model_summary.py")


def flops(*args, **kwargs):
    """hapi/model.py's ``flops``: not ported yet."""
    raise NotImplementedError("flops is not ported yet (it needs "
                              "hapi/model_summary.py's layer walk)")

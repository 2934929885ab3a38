"""Regularizers.

Ports paddle_tpu/regularizer.py (python/paddle/fluid/regularizer.py
parity): ``L2Decay`` and ``L1Decay`` hold a coefficient that an optimizer
given one as ``weight_decay`` reads; L2 adds ``coeff * p`` to the grad, L1
``coeff * sign(p)`` (optimizer/optimizer.py ``_rule_with_decay``).
"""


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay

__all__ = ["L1Decay", "L1DecayRegularizer", "L2Decay", "L2DecayRegularizer"]

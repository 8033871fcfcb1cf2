"""Regularizers: the port's copy of ``paddle_tpu/regularizer.py`` (reference:
python/paddle/fluid/regularizer.py, L1Decay and L2Decay). An optimizer reads
the coefficient as its ``weight_decay`` (``Optimizer._parse_wd``)."""
from __future__ import annotations


class WeightDecayRegularizer:
    pass


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff

"""``ParamAttr``: a parameter's attribute bundle (``paddle_tpu/nn/param_attr.py``)."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or isinstance(attr, (ParamAttr, bool)):
            return attr
        from . import initializer as I

        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")

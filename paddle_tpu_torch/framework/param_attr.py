"""ParamAttr — per-parameter creation attributes (counterpart:
paddle_tpu/framework/param_attr.py).

Read by `nn.Layer.create_parameter`: ``initializer`` draws the value,
``learning_rate`` multiplies the optimizer's rate for the parameter,
``regularizer`` replaces the optimizer's weight decay for it (eager
``step`` only, as in the JAX package), ``trainable=False`` makes it a
parameter that requires no grad.  The three are kept on the parameter
as ``optimize_attr``, ``regularizer`` and ``requires_grad``.
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = float(learning_rate)
        self.regularizer = regularizer
        self.trainable = bool(trainable)
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """None, a name, False, an initializer or a ParamAttr as a
        ParamAttr (False stays False: "no parameter")."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if arg is False:
            return False
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)

"""``Layer``: Paddle's layer base class over ``torch.nn.Module`` (port of
the part of ``paddle_tpu/nn/layer/base.py`` that the eager Llama and its
users touch).

Parameters are ``torch.nn.Parameter``s made on the current device
(``paddle_tpu_torch.device``) in the layer's dtype (float32 unless
given). Paddle's names sit beside torch's: ``create_parameter``,
``add_parameter``, ``add_sublayer``, ``parameters()`` as a list,
``named_parameters``, ``sublayers``, ``state_dict`` / ``set_state_dict``
over structured names (``layers.0.q_proj.weight``), ``to(device=,
dtype=)`` with Paddle dtype names, ``astype``, ``float``, ``bfloat16``,
``clear_gradients``; ``train`` and ``eval`` are torch's. A
parameter's Paddle name (an ``attr``'s ``name``, what
``apply_decay_param_fun`` receives) is its ``param_name`` attribute,
since torch reserves ``Tensor.name``.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ...core import enforce as E
from ...core.tensor import convert_dtype, from_numpy
from ...device import to_torch_device
from .. import initializer as init_mod

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    """Base class of the port's Paddle-surface layers."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype) if dtype else torch.float32

    # -- construction ---------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of ``shape`` on the current device. ``attr`` is
        ``False`` (no parameter: ``None``), an initializer, or a
        ``ParamAttr``-like object (``initializer``, ``trainable``,
        ``name``); its initializer comes before the global one
        (``initializer.set_global_initializer``), then
        ``default_initializer``, then zeros for a bias and
        ``XavierUniform`` for a weight."""
        if attr is False:
            return None
        dtype = convert_dtype(dtype) if dtype else self._dtype
        initializer, trainable, name = None, True, None
        if isinstance(attr, init_mod.Initializer):
            initializer = attr
        elif attr is not None:
            initializer = getattr(attr, "initializer", None)
            trainable = getattr(attr, "trainable", True)
            name = getattr(attr, "name", None)
        if initializer is None:
            initializer = init_mod.global_initializer(is_bias)
        if initializer is None:
            initializer = default_initializer
        if initializer is None:
            initializer = (init_mod.Constant(0.0) if is_bias
                           else init_mod.XavierUniform())
        p = torch.nn.Parameter(initializer(tuple(int(s) for s in shape),
                                           dtype),
                               requires_grad=trainable)
        p.param_name = name
        return p

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    # -- traversal ------------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, **kw):
        """``(structured name, parameter)`` pairs, each parameter once."""
        kw.setdefault("recurse", include_sublayers)
        return super().named_parameters(prefix=prefix, **kw)

    def parameters(self, include_sublayers: bool = True, **kw):
        """The parameters as a list (Paddle's), not a generator."""
        kw.setdefault("recurse", include_sublayers)
        return list(super().parameters(**kw))

    def sublayers(self, include_self: bool = False):
        return [m for m in self.modules() if include_self or m is not self]

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = ""):
        """Structured name -> parameter (and persistent buffer), the live
        tensors, as the reference's handles."""
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            dest[name] = p
        for prefix, layer in self.named_modules(
                prefix=structured_name_prefix):
            if layer is not self and not include_sublayers:
                continue
            for name, b in layer._buffers.items():
                if b is not None and \
                        name not in layer._non_persistent_buffers_set:
                    dest[f"{prefix}.{name}" if prefix else name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy values (tensors, numpy arrays, bfloat16 numpy arrays too)
        into the existing parameters, each cast to its parameter's dtype.
        Returns ``(missing, unexpected)`` names; a shape mismatch
        raises."""
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    continue
                target = own[name]
                src = value.detach() if torch.is_tensor(value) \
                    else from_numpy(value)
                if tuple(src.shape) != tuple(target.shape):
                    raise E.InvalidArgumentError(
                        f"shape mismatch for {name}: {tuple(src.shape)} vs "
                        f"{tuple(target.shape)}")
                target.copy_(src.to(device=target.device))
        return missing, unexpected

    # -- dtype / device -------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move to ``device`` (a Paddle device string) and / or cast the
        floating parameters and buffers to ``dtype`` (a Paddle name or
        ``torch.dtype``)."""
        kw = {}
        if device is not None:
            kw["device"] = to_torch_device(device)
        if dtype is not None:
            kw["dtype"] = convert_dtype(dtype)
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = kw["dtype"]
        return super().to(**kw) if kw else self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

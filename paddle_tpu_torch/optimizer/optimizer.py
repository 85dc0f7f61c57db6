"""Eager optimizers (port of ``Optimizer``, ``Adam`` and ``AdamW`` of
``paddle_tpu/optimizer/optimizer.py:80-215,423-548``).

``step()`` updates every parameter that requires grad and holds a
gradient, in place, with the reference's math and order of operations:
moments are float32 whatever the parameter's type; ``multi_precision``
keeps a float32 master copy of a low-precision parameter and updates
that; AdamW's decoupled decay comes after the Adam update, from the
weight before it (``new - lr * wd * old``, on the master when there is
one); ``apply_decay_param_fun`` receives the parameter's Paddle name
(``param_name``, ``""`` when it has none). A Python scalar meets a
tensor in the tensor's type, as JAX's weak types do. The rule itself,
``adam_update_``, is shared with the functional train step.

Not ported yet, and raising: ``grad_clip``, an ``LRScheduler`` as the
learning rate, a regularizer object as ``weight_decay`` (a float is
Paddle's L2 decay), ``amsgrad`` and row-sparse gradients (ROADMAP.md
queue A item 1).
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "Adam", "AdamW", "adam_update_"]


def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a Python scalar
    that meets a tensor in JAX is weakly typed and rounds to the tensor's
    type first, where PyTorch would keep it in float32 for a bfloat16
    tensor."""
    return torch.tensor(value, dtype=dtype).item()


@torch.no_grad()
def adam_update_(w, g, m1, m2, *, lr, b1, b2, eps, bc1, bc2, wd=0.0,
                 decay_from=None, coupled=False):
    """One Adam step of one tensor, the rule of both ``Adam`` / ``AdamW``
    and the functional train step (``models.llama._adamw_update``).

    Updates the moments ``m1`` and ``m2`` in place (their math in float32
    whatever type they are stored in) and returns the new weight in
    float32, with ``u = (m1 / bc1) / (sqrt(m2 / bc2) + eps)`` and the
    decay ``wd`` taken from the weight before the step, in one of two
    orders that are equal in exact arithmetic but round differently:

    - ``coupled=False`` (eager ``Adam`` / ``AdamW``): ``w - lr * u``, then
      ``- lr * wd * decay_from`` (``w`` in float32 by default; in
      ``decay_from``'s own type otherwise, ``lr * wd`` rounded to it);
    - ``coupled=True`` (the functional step): ``w - lr * (u + wd * w)``
      with ``w`` in float32 (``decay_from`` is not taken).

    Each caller passes its own bias corrections ``bc1``, ``bc2``, rounded
    as its reference rounds them."""
    gf = g.float()
    m1f, m2f = m1.float(), m2.float()       # m1 and m2 when float32
    m1f.mul_(b1).add_(gf * (1 - b1))
    m2f.mul_(b2).add_((gf * gf).mul_(1 - b2))
    if m1f is not m1:
        m1.copy_(m1f)
        m2.copy_(m2f)
    u = (m1f / bc1).div_((m2f / bc2).sqrt_().add_(eps))
    if coupled:
        wf = w.float()
        if wd:
            u.add_(wf * wd)
        return wf - u.mul_(lr)
    new = w - u.mul_(lr)                    # float32 by promotion
    if wd:
        src = w.float() if decay_from is None else decay_from
        new.sub_(src * _round_to(lr * wd, src.dtype))
    return new


class Optimizer:
    """Base optimizer: the learning rate, the parameter list, per-parameter
    state and the step loop; ``_update`` is the rule."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "Optimizer: an LRScheduler learning rate is not ported yet "
                "(ROADMAP.md queue A item 1); pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "Optimizer: grad_clip is not ported yet (ROADMAP.md queue A "
                "item 1)")
        if not isinstance(weight_decay, (int, float, type(None))):
            raise NotImplementedError(
                "Optimizer: a regularizer object as weight_decay is not "
                "ported yet (ROADMAP.md queue A item 1); pass a float")
        self._lr = float(learning_rate)
        parameters = list(parameters) if parameters is not None else None
        if parameters and isinstance(parameters[0], dict):
            parameters = [p for group in parameters for p in group["params"]]
        self._parameter_list = parameters
        self._weight_decay = float(weight_decay or 0.0)
        self._accumulators = {}
        self._global_step = 0

    # -- lr -------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float):
        self._lr = float(value)

    # -- state ----------------------------------------------------------------
    def _ensure_state(self, p) -> dict:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._init_state(p)
            self._accumulators[id(p)] = st
        return st

    def _init_state(self, p) -> dict:
        return {}

    def _update(self, param, grad, state: dict, lr, step, wd):
        """The rule: updates ``param`` and ``state`` in place, with the
        decoupled decay ``wd`` (0 for none)."""
        raise NotImplementedError

    def _use_decay_for(self, p) -> bool:
        return True

    def _decoupled_wd(self) -> bool:
        return False

    # -- step -----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        self._global_step += 1
        if not params:
            return
        if any(p.grad.is_sparse for p in params):
            raise NotImplementedError(
                "Optimizer.step: row-sparse gradients are not ported yet "
                "(ROADMAP.md queue A item 1)")
        lr, step = self.get_lr(), self._global_step
        for p in params:
            g = p.grad
            st = self._ensure_state(p)
            use_wd = self._weight_decay if self._use_decay_for(p) else 0.0
            if use_wd and not self._decoupled_wd():
                # coupled L2 regularizer: the gradient gains coeff * w
                reg = p.to(g.dtype)
                g = g + reg * _round_to(use_wd, reg.dtype)
                use_wd = 0.0
            self._update(p, g, st, lr, step, use_wd)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError(
                "Adam: amsgrad is not ported yet (ROADMAP.md queue A item 1)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _init_state(self, p):
        st = {"moment1": torch.zeros_like(p, dtype=torch.float32),
              "moment2": torch.zeros_like(p, dtype=torch.float32)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().float()
        return st

    def _update(self, param, grad, state, lr, step, wd):
        """``adam_update_`` of the float32 master when there is one, else
        of the parameter; the decoupled decay shrinks that stored weight,
        from its value before the step and in its own type."""
        b1, b2 = self._beta1, self._beta2
        master = state.get("master_weight")
        w = master if master is not None else param
        new = adam_update_(w, grad, state["moment1"], state["moment2"],
                           lr=lr, b1=b1, b2=b2, eps=self._epsilon,
                           bc1=1 - b1 ** step, bc2=1 - b2 ** step, wd=wd,
                           decay_from=w)
        if master is not None:
            state["master_weight"] = new
        param.copy_(new)


class AdamW(Adam):
    """Adam with decoupled weight decay (reference:
    ``optimizer/adamw.py``); ``weight_decay`` defaults to 0.01."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW: lr_ratio is not ported yet (ROADMAP.md queue A "
                "item 1)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, amsgrad=amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _use_decay_for(self, p):
        if self._apply_decay_param_fun is not None:
            return self._apply_decay_param_fun(
                getattr(p, "param_name", None) or "")
        return True

"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``).

Float16 needs it; bfloat16 has float32's exponent range, so the scaler
only multiplies and divides while gradients stay finite. A step makes
one host read: the found-inf flag of all of an optimizer's gradients,
gathered on the device first.
"""
from __future__ import annotations

import torch

from ..core import enforce as E

__all__ = ["GradScaler", "AmpScaler", "OptimizerState"]


class OptimizerState:
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False          # any optimizer's (for update)
        self._opt_states = {}            # id(opt) -> (state, found_inf)

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float):
        self._scale = float(v)

    def scale(self, loss):
        if not self._enable:
            return loss
        from .. import ops
        return ops.scale(loss, scale=self._scale)

    def _grads_of(self, optimizer):
        return [p for p in (optimizer._parameter_list or [])
                if p.grad is not None and p.requires_grad]

    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale in place and
        note whether any is not finite: one flag for all of them, read
        once. Raises after ``step`` until ``update``."""
        if not self._enable:
            return
        st, _ = self._opt_states.get(id(optimizer),
                                     (OptimizerState.INIT, False))
        if st == OptimizerState.UNSCALED:
            return
        if st == OptimizerState.STEPPED:
            raise E.PreconditionNotMetError(
                "unscale_() is being called after step() for this "
                "optimizer; call update() first")
        inv = 1.0 / self._scale
        bad = None
        with torch.no_grad():
            for p in self._grads_of(optimizer):
                g = p.grad.coalesce() if p.grad.is_sparse else p.grad
                g = g * inv
                vals = g.values() if g.is_sparse else g
                b = (~torch.isfinite(vals)).any()
                bad = b if bad is None else bad | b
                p.grad = g
        found = bool(bad) if bad is not None else False
        # per optimizer: another optimizer's clean gradients must not
        # clear this one's inf, nor the other way round
        self._found_inf = self._found_inf or found
        self._opt_states[id(optimizer)] = (OptimizerState.UNSCALED, found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        st, _ = self._opt_states.get(id(optimizer),
                                     (OptimizerState.INIT, False))
        if st == OptimizerState.STEPPED:
            raise E.PreconditionNotMetError(
                "step() has already been called for this optimizer since "
                "the last update()")
        if st != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        _, found = self._opt_states[id(optimizer)]
        if not found:
            optimizer.step()
        self._opt_states[id(optimizer)] = (OptimizerState.STEPPED, found)

    def update(self):
        if not self._enable or not self._dynamic:
            self._opt_states.clear()
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._opt_states.clear()

    def minimize(self, optimizer, loss):
        # the loss was scaled and its backward run already
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._dynamic = state.get("use_dynamic_loss_scaling", self._dynamic)


AmpScaler = GradScaler

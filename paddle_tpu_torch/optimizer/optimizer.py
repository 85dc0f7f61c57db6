"""Eager optimizers (port of ``Optimizer``, ``Adam``, ``AdamW``, the
regularizers and the gradient clips of
``paddle_tpu/optimizer/optimizer.py:26-314,423-538``).

``step()`` updates every parameter that requires grad and holds a
gradient, in place, with the reference's math and order of operations:
the clip first (``grad_clip``: by value, by each tensor's norm, or by the
global norm, whose sums of squares run in each gradient's own type and
are added in parameter order, the scale staying a device tensor), then
the regularizer (``L1Decay`` adds ``coeff * sign(w)``, ``L2Decay`` or a
float ``coeff * w`` to the gradient; AdamW's decay is decoupled
instead), then the rule. Moments are float32 whatever the parameter's
type; ``multi_precision`` keeps a float32 master copy of a low-precision
parameter and updates that; ``amsgrad`` keeps the running maximum of the
second moment (``moment2_max``) and divides by it; AdamW's decoupled
decay comes after the Adam update, from the weight before it (``new - lr
* wd * old``, on the master when there is one); ``apply_decay_param_fun``
receives the parameter's Paddle name (``param_name``, ``""`` when it has
none). The learning rate is a float or an ``LRScheduler``
(``optimizer/lr.py``), read at each step. A Python scalar meets a tensor
in the tensor's type, as JAX's weak types do. The rule itself,
``adam_update_``, is shared with the functional train step.

Row-sparse gradients (a ``torch.sparse_coo`` gradient, what
``nn.Embedding(sparse=True)`` gives) are coalesced and stay sparse
through the clip (on their values; a ``ClipGradByValue`` range that
excludes 0 densifies them, since it clamps the implicit zeros too) and
the update: ``Adam`` with ``lazy_mode`` moves the moments and the
weight of the gradient's rows only, and without it decays the moments
everywhere, which equals the dense update of the scattered gradient.

``state_dict`` / ``set_state_dict`` use the reference's keys:
``"{name}.{moment1|moment2|moment2_max|master_weight}"`` (``name`` the
parameter's ``param_name``, else ``param_{i}`` by its place in the
list), ``"global_step"`` and ``"LR_Scheduler"``.
"""
from __future__ import annotations

import torch

from ..core import enforce as E
from ..core.tensor import from_numpy
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "adam_update_", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "L1Decay", "L2Decay"]


def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a Python scalar
    that meets a tensor in JAX is weakly typed and rounds to the tensor's
    type first, where PyTorch would keep it in float32 for a bfloat16
    tensor."""
    return torch.tensor(value, dtype=dtype).item()


@torch.no_grad()
def adam_update_(w, g, m1, m2, *, lr, b1, b2, eps, bc1, bc2, wd=0.0,
                 decay_from=None, coupled=False, m2max=None):
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
    as its reference rounds them. ``m2max`` (amsgrad, float32) takes the
    running maximum of ``m2`` in place, and ``u`` divides by it."""
    gf = g.float()
    m1f, m2f = m1.float(), m2.float()       # m1 and m2 when float32
    m1f.mul_(b1).add_(gf * (1 - b1))
    m2f.mul_(b2).add_((gf * gf).mul_(1 - b2))
    if m1f is not m1:
        m1.copy_(m1f)
        m2.copy_(m2f)
    v = m2f
    if m2max is not None:
        v = torch.maximum(m2max, m2f, out=m2max)
    u = (m1f / bc1).div_((v / bc2).sqrt_().add_(eps))
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


class L1Decay:
    """L1 decay of ``coeff``: the gradient gains ``coeff * sign(w)``
    (AdamW takes ``coeff`` as its decoupled decay instead)."""

    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L2Decay:
    """L2 decay of ``coeff`` (what a float ``weight_decay`` means): the
    gradient gains ``coeff * w`` (AdamW: decoupled, as for L1Decay)."""

    def __init__(self, coeff=0.0):
        self.coeff = coeff


class ClipGradByValue:
    """Clamp every gradient into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm:
    """Scale each gradient to at most ``clip_norm`` in its own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            n = torch.sqrt(torch.sum(torch.square(g)))
            tiny = _round_to(1e-12, n.dtype)
            scale = torch.clamp(_round_to(self.clip_norm, n.dtype)
                                / torch.clamp(n, min=tiny), max=1.0)
            out.append(g * scale)
        return out


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm over all of them. Each gradient's sum of squares is
    taken in its own type and the sums are added in parameter order with
    Python's ``sum``, as in the reference; the scale is a device tensor
    (nothing is read back to the host)."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = clip_norm

    def _scale(self, grads):
        """``clip_norm / max(global_norm, clip_norm)``, a 0-d tensor."""
        sq = [torch.sum(torch.square(g)) for g in grads if g is not None]
        global_norm = torch.sqrt(sum(sq))
        c = _round_to(self.clip_norm, global_norm.dtype)
        return c / torch.clamp(global_norm, min=c)

    def _clip(self, grads):
        if all(g is None for g in grads):
            return grads
        scale = self._scale(grads)
        return [None if g is None else g * scale for g in grads]


def _sparse_like(g, values):
    """A coalesced sparse gradient ``g`` with new ``values``."""
    return torch.sparse_coo_tensor(g.indices(), values, g.shape,
                                   check_invariants=False, is_coalesced=True)


class Optimizer:
    """Base optimizer: the learning rate (a float or an ``LRScheduler``),
    the parameter list, the regularizer and the clip, per-parameter state
    and the step loop; ``_update`` is the rule, ``_update_sparse`` its
    row-sparse form."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        parameters = list(parameters) if parameters is not None else None
        if parameters and isinstance(parameters[0], dict):
            parameters = [p for group in parameters for p in group["params"]]
        self._parameter_list = parameters
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}
        self._global_step = 0

    # -- lr -------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise E.PreconditionNotMetError(
                "set_lr is not allowed when the lr is an LRScheduler")
        self._lr = value

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._lr = scheduler

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

    def _update_sparse(self, param, rows, vals, state, lr, step):
        """The rule on a coalesced row-sparse gradient (unique ``rows``,
        ``vals``): updates ``state`` in place and returns the new weight
        (the whole tensor), or None for an optimizer without one (the
        gradient is then densified)."""
        return None

    def _sparse_lazy(self) -> bool:
        """True: a sparse step (its decoupled decay too) touches only the
        gradient's rows. False: it equals the dense step of the scattered
        gradient."""
        return False

    def _decay_coeff(self) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (L1Decay, L2Decay)):
            return wd.coeff
        return float(wd)

    def _use_decay_for(self, p) -> bool:
        return True

    def _decoupled_wd(self) -> bool:
        return False

    # -- step -----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in (self._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        if not params:
            self._global_step += 1
            return
        grads = [p.grad.coalesce() if p.grad.is_sparse else p.grad
                 for p in params]
        clip = self._grad_clip
        if isinstance(clip, ClipGradByValue) and (clip.min > 0
                                                  or clip.max < 0):
            # a range without 0 clamps the implicit zero rows too: only
            # the dense gradient can say that
            grads = [g.to_dense() if g.is_sparse else g for g in grads]
        if clip is not None:
            arrs = clip._clip([g.values() if g.is_sparse else g
                               for g in grads])
            grads = [_sparse_like(g, a) if g.is_sparse else a
                     for g, a in zip(grads, arrs)]
        lr = self.get_lr()
        self._global_step += 1
        step = self._global_step
        wd = self._decay_coeff()
        is_l1 = isinstance(self._weight_decay, L1Decay)
        for p, g in zip(params, grads):
            st = self._ensure_state(p)
            use_wd = wd if self._use_decay_for(p) else 0.0
            if g.is_sparse:
                if self._step_sparse(p, g, st, lr, step, use_wd, is_l1):
                    continue
                g = g.to_dense()
            if use_wd and not self._decoupled_wd():
                # coupled regularizer: the gradient gains coeff * w (L2)
                # or coeff * sign(w) (L1)
                reg = (torch.sign(p) if is_l1 else p).to(g.dtype)
                g = g + reg * _round_to(use_wd, reg.dtype)
                use_wd = 0.0
            self._update(p, g, st, lr, step, use_wd)

    def _step_sparse(self, p, g, st, lr, step, use_wd, is_l1) -> bool:
        """One coalesced sparse gradient: the coupled regularizer on its
        rows, ``_update_sparse``, then the decoupled decay over all rows,
        or the gradient's rows only when lazy. False when the optimizer
        has no sparse rule."""
        if type(self)._update_sparse is Optimizer._update_sparse:
            return False
        rows, vals = g.indices()[0], g.values()
        if use_wd and not self._decoupled_wd():
            pr = p[rows]
            reg = (torch.sign(pr) if is_l1 else pr).to(vals.dtype)
            vals = vals + reg * _round_to(use_wd, vals.dtype)
        master = st.get("master_weight")
        lazy = self._sparse_lazy()
        src = None
        if use_wd and self._decoupled_wd():
            # the decay's source, the stored weight before the update:
            # the gradient's rows when lazy, else all of it
            base = master if master is not None else p
            src = base[rows] if lazy else base.clone()
        new_p = self._update_sparse(p, rows, vals, st, lr, step)
        if src is not None:
            if master is not None:
                m = st["master_weight"]
                if lazy:
                    m[rows] = m[rows] - src * (lr * use_wd)
                else:
                    m = m - src * (lr * use_wd)
                st["master_weight"] = m
                new_p = m.to(new_p.dtype)
            elif lazy:
                new_p = new_p.index_add(
                    0, rows, -(src * (lr * use_wd)).to(new_p.dtype))
            else:
                new_p = new_p - (src * (lr * use_wd)).to(new_p.dtype)
        p.copy_(new_p)
        return True

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every gradient, or zero a dense one in place with
        ``set_to_zero`` (a row-sparse gradient is dropped: the next
        backward rebuilds it)."""
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None and not p.grad.is_sparse:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- serialization ----------------------------------------------------------
    def _names(self):
        return [(getattr(p, "param_name", None) or f"param_{i}", p)
                for i, p in enumerate(self._parameter_list or [])]

    def state_dict(self) -> dict:
        """Copies of the state (the moments change in place at each
        step), under the reference's keys."""
        out = {"global_step": self._global_step}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for name, p in self._names():
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                out[f"{name}.{k}"] = v.detach().clone()
        return out

    def set_state_dict(self, state):
        """Load a ``state_dict`` (tensors or numpy arrays, e.g. the JAX
        package's as numpy): each parameter's state is made, then every
        key present is copied onto the parameter's device."""
        self._global_step = state.get("global_step", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for name, p in self._names():
            st = self._ensure_state(p)
            for k in list(st):
                v = state.get(f"{name}.{k}")
                if v is not None:
                    v = v.detach() if torch.is_tensor(v) else from_numpy(v)
                    st[k] = v.to(device=p.device, copy=True)

    set_dict = set_state_dict


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._multi_precision = multi_precision
        self._lazy = lazy_mode

    def _sparse_lazy(self):
        return self._lazy

    def _init_state(self, p):
        st = {"moment1": torch.zeros_like(p, dtype=torch.float32),
              "moment2": torch.zeros_like(p, dtype=torch.float32)}
        if self._amsgrad:
            st["moment2_max"] = torch.zeros_like(p, dtype=torch.float32)
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
                           decay_from=w, m2max=state.get("moment2_max"))
        if master is not None:
            state["master_weight"] = new
        param.copy_(new)

    def _update_sparse(self, param, rows, vals, state, lr, step):
        """The reference's sparse Adam, in its order of operations. Lazy:
        moments and weight move on ``rows`` only. Otherwise the moments
        decay everywhere and take the gradient at ``rows`` (the dense
        update of the scattered gradient, without a dense gradient)."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        g = vals.float()
        m1, m2 = state["moment1"], state["moment2"]
        amax = state.get("moment2_max")
        master = state.get("master_weight")
        w = master if master is not None else param
        if self._lazy:
            m1r = b1 * m1[rows] + (1 - b1) * g
            m2r = b2 * m2[rows] + (1 - b2) * torch.square(g)
            m1[rows], m2[rows] = m1r, m2r
            vr = m2r
            if amax is not None:
                vr = torch.maximum(amax[rows], m2r)
                amax[rows] = vr
            upd = lr * (m1r / bc1) / (torch.sqrt(vr / bc2) + eps)
            new_rows = w[rows].float() - upd
            if master is not None:
                master[rows] = new_rows
            return param.index_copy(0, rows, new_rows.to(param.dtype))
        m1.mul_(b1).index_add_(0, rows, (1 - b1) * g)
        m2.mul_(b2).index_add_(0, rows, (1 - b2) * torch.square(g))
        v = m2
        if amax is not None:
            v = torch.maximum(amax, m2, out=amax)
        new_w = w - lr * (m1 / bc1) / (torch.sqrt(v / bc2) + eps)
        if master is not None:
            state["master_weight"] = new_w
            return new_w.to(param.dtype)
        return new_w


class AdamW(Adam):
    """Adam with decoupled weight decay (reference:
    ``optimizer/adamw.py``); ``weight_decay`` defaults to 0.01.
    ``lr_ratio`` is taken and not used, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
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

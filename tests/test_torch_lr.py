"""Port parity: ``optimizer/lr.py``, every scheduler of the JAX
package's ``__all__`` and its eight fluid-style functions, stepped 100
times beside the JAX package's: the learning rates must be equal as
Python floats (the module is plain Python in both). Then the state-dict
round trip: a scheduler restored from another's ``state_dict`` (the
port's, and the JAX package's) gives the same rates from there on.
"""
import pytest

import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer.lr as tlr

STEPS = 100


def _lam(e):
    return 0.97 ** e


# name -> (constructor over a module, per-step metric for ReduceOnPlateau)
_CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 40], [0.1, 0.05,
                                                            0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 30, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(0.1, 30,
                                                         cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 10, 0.0, 0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=90), 10, 0.0, 3e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.95),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [20, 50, 70]),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=15),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, _lam),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, patience=3,
                                                   cooldown=2),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=40),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1, _lam),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=STEPS),
    "OneCycleLR_three_phase_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=STEPS, anneal_strategy="linear",
        three_phase=True),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=7),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, step_size_down=9, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.99),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=50),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=10, T_mult=2),
    "noam_decay": lambda m: m.noam_decay(64, 10),
    "exponential_decay": lambda m: m.exponential_decay(0.1, 10, 0.5, True),
    "natural_exp_decay": lambda m: m.natural_exp_decay(0.1, 10, 0.5),
    "inverse_time_decay": lambda m: m.inverse_time_decay(0.1, 10, 0.5,
                                                         True),
    "polynomial_decay": lambda m: m.polynomial_decay(0.1, 30),
    "piecewise_decay": lambda m: m.piecewise_decay([10, 40], [0.1, 0.05,
                                                              0.01]),
    "cosine_decay": lambda m: m.cosine_decay(0.1, 10, 5),
    "linear_lr_warmup": lambda m: m.linear_lr_warmup(0.1, 10, 0.0, 0.1),
}


def _metric(t):
    """A loss that falls, then stalls (ReduceOnPlateau's input)."""
    return 1.0 / (1 + t) if t < 30 else 0.03 + 0.001 * (t % 3)


def _rates(sched, start=0, steps=STEPS):
    out = []
    for t in range(start, start + steps):
        out.append(sched())
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(_metric(t))
        else:
            sched.step()
    return out


def test_every_scheduler_and_function_is_covered():
    classes = {n.split("_")[0] for n in _CASES if n[0].isupper()}
    assert classes == set(jlr.__all__) - {"LRScheduler"} == set(
        tlr.__all__) - {"LRScheduler"}
    assert len([n for n in _CASES if n[0].islower()]) == 8


@pytest.mark.parametrize("name", sorted(_CASES))
def test_rates_equal_jax_for_100_steps(name):
    want = _rates(_CASES[name](jlr))
    got = _rates(_CASES[name](tlr))
    assert all(isinstance(x, float) for x in got)
    assert got == want


@pytest.mark.parametrize("name", ["LinearWarmup_cosine", "ReduceOnPlateau",
                                  "CyclicLR", "OneCycleLR"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_state_dict_round_trip(name, source):
    """30 steps, then a fresh scheduler takes the state dict (the port's,
    or the JAX package's) and both step 30 more."""
    ref = _CASES[name](tlr)
    other = _CASES[name](jlr if source == "jax" else tlr)
    _rates(ref, steps=30)
    _rates(other, steps=30)
    fresh = _CASES[name](tlr)
    fresh.set_state_dict(other.state_dict())
    assert _rates(fresh, start=30, steps=30) == _rates(ref, start=30,
                                                       steps=30)

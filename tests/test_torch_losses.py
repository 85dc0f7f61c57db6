"""Port parity: the loss layers (``paddle_tpu_torch/nn/layer/loss.py``,
all sixteen) and the loss functionals (``nn/functional/loss.py``)
against ``paddle_tpu``'s, on the same float32 inputs from a seeded
numpy generator, every reduction. Tolerance: rtol 1e-6, atol 1e-6 (the
same float32 math; only the order of a sum may differ).

``CrossEntropyLoss`` over ``[B, S, V]`` logits is ``F.cross_entropy``
itself (one call, nothing else materialised), and its loss and logits
gradient equal, bit for bit, those of ``F.cross_entropy`` over the
logits reshaped to ``[B * S, V]``, the hand-written eager step's form.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

RTOL = ATOL = 1e-6
N, C = 6, 5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    prob = 1 / (1 + np.exp(-f(N, C)))
    return {
        "x": f(N, C), "y": f(N, C), "z": f(N, C),
        "logp": np.log(np.exp(f(N, C)) / np.exp(f(N, C)).sum(
            1, keepdims=True)).astype(np.float32),
        "prob": prob.astype(np.float32),
        "bin": rng.integers(0, 2, (N, C)).astype(np.float32),
        "cls": rng.integers(0, C, (N,)).astype(np.int64),
        "cls_ign": np.where(rng.random(N) < 0.3, -100,
                            rng.integers(0, C, N)).astype(np.int64),
        "sign": np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32),
        "signNC": np.where(rng.random((N, C)) < 0.5, -1.0,
                           1.0).astype(np.float32),
        "w": (0.5 + rng.random(C)).astype(np.float32),
        "var": (0.1 + rng.random((N, C))).astype(np.float32),
        "count": rng.poisson(2.0, (N, C)).astype(np.float32),
        "soft": (np.exp(f(N, C)) / np.exp(f(N, C)).sum(
            1, keepdims=True)).astype(np.float32),
        "vec1": f(N, 8), "vec2": f(N, 8), "vec3": f(N, 8),
    }


# (layer name, constructor kwargs, forward input names)
LAYERS = [
    ("CrossEntropyLoss", {}, ("x", "cls")),
    ("CrossEntropyLoss", {"ignore_index": -100, "weight": "w",
                          "label_smoothing": 0.1}, ("x", "cls_ign")),
    ("CrossEntropyLoss", {"soft_label": True}, ("x", "soft")),
    ("MSELoss", {}, ("x", "y")),
    ("L1Loss", {}, ("x", "y")),
    ("NLLLoss", {"weight": "w"}, ("logp", "cls_ign")),
    ("BCELoss", {"weight": "w"}, ("prob", "bin")),
    ("BCEWithLogitsLoss", {"pos_weight": "w"}, ("x", "bin")),
    ("KLDivLoss", {}, ("logp", "soft")),
    ("KLDivLoss", {"log_target": True}, ("logp", "logp")),
    ("SmoothL1Loss", {"delta": 0.7}, ("x", "y")),
    ("MarginRankingLoss", {"margin": 0.2}, ("x", "y", "signNC")),
    ("HingeEmbeddingLoss", {"margin": 0.5}, ("x", "signNC")),
    ("CosineEmbeddingLoss", {"margin": 0.1}, ("vec1", "vec2", "sign")),
    ("TripletMarginLoss", {"swap": True}, ("vec1", "vec2", "vec3")),
    ("MultiLabelSoftMarginLoss", {}, ("x", "bin")),
    ("SoftMarginLoss", {}, ("x", "signNC")),
    ("PoissonNLLLoss", {"full": True}, ("x", "count")),
    ("GaussianNLLLoss", {"full": True}, ("x", "y", "var")),
]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("i", range(len(LAYERS)),
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_loss_layers_match_the_reference(i, reduction):
    name, kw, args = LAYERS[i]
    d = _inputs(i)
    jkw = {k: jpaddle.to_tensor(d[v]) if isinstance(v, str) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(d[v]) if isinstance(v, str) else v
           for k, v in kw.items()}
    jl = getattr(jnn, name)(reduction=reduction, **jkw)
    tl = getattr(tnn, name)(reduction=reduction, **tkw)
    want = np.asarray(jl(*[jpaddle.to_tensor(d[a]) for a in args]).numpy())
    got = tl(*[torch.from_numpy(d[a]) for a in args]).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# functionals without a layer: (name, kwargs, inputs)
FUNCTIONALS = [
    ("softmax_with_cross_entropy", {}, ("x", "cls")),
    ("softmax_with_cross_entropy", {"soft_label": True}, ("x", "soft")),
    ("softmax_with_cross_entropy", {"ignore_index": -100,
                                    "return_softmax": True},
     ("x", "cls_ign")),
    ("square_error_cost", {}, ("x", "y")),
    ("log_loss", {"epsilon": 1e-3}, ("prob", "bin")),
    ("sigmoid_focal_loss", {}, ("x", "bin")),
    ("sigmoid_focal_loss", {"reduction": "mean", "gamma": 1.5},
     ("x", "bin")),
    ("dice_loss", {}, ("prob", "cls1")),
    ("npair_loss", {"l2_reg": 0.01}, ("vec1", "vec2", "cls")),
    ("kl_div", {"reduction": "batchmean"}, ("logp", "soft")),
    ("nll_loss", {"reduction": "none"}, ("logp", "cls")),
]


@pytest.mark.parametrize("i", range(len(FUNCTIONALS)),
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(FUNCTIONALS)])
def test_loss_functionals_match_the_reference(i):
    name, kw, args = FUNCTIONALS[i]
    d = _inputs(100 + i)
    d["cls1"] = d["cls"][:, None]
    want = getattr(JF, name)(*[jpaddle.to_tensor(d[a]) for a in args], **kw)
    got = getattr(TF, name)(*[torch.from_numpy(d[a]) for a in args], **kw)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.numpy())
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_cross_entropy_loss_over_sequences_is_the_eager_steps(monkeypatch):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 9, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 9))
    calls = []
    real = TF.cross_entropy
    import paddle_tpu_torch.nn.layer.loss as TLOSS
    monkeypatch.setattr(TLOSS.F, "cross_entropy",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    grads = []
    for fn in (lambda x: tnn.CrossEntropyLoss()(x, torch.from_numpy(labels)),
               lambda x: real(x.reshape([-1, 33]),
                              torch.from_numpy(labels).reshape([-1]))):
        x = torch.from_numpy(logits.copy()).to(torch.bfloat16)
        x.requires_grad_()
        loss = fn(x)
        loss.backward()
        grads.append((loss.detach(), x.grad))
    assert calls == [torch.Size([2, 9, 33])]
    assert grads[0][0].dtype == torch.float32
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])

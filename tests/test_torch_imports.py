"""The port stands alone and runs on the card unless told otherwise.

- No module under ``paddle_tpu_torch/`` imports ``jax`` or ``paddle_tpu``
  (checked on the source with ``ast``, so a lazy import inside a
  function is caught too).
- Entry points called without ``device=`` raise on a box without a CUDA
  device instead of running on the CPU; so do the eager surface's
  (``LlamaForCausalLM``, ``to_tensor``, ``seed``) until
  ``set_device("cpu")`` asks for the CPU.
"""
import ast
import pathlib

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device as TD
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import llama as TL

_ROOT = pathlib.Path(paddle_tpu_torch.__file__).parent
_FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(_ROOT.rglob("*.py"))
    assert len(files) >= 10
    scanned = {str(f.relative_to(_ROOT)) for f in files}
    assert {"optimizer/lr.py", "nn/initializer.py",
            "incubate/nn/functional.py", "models/dit.py",
            "core/flags.py", "training/guards.py"} <= scanned
    bad = [(str(f.relative_to(_ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from paddle_tpu.models import llama\n"
                 "    import jax.numpy as jnp\n")
    assert {m.split(".")[0] for m in _imported_modules(f)} == {
        "paddle_tpu", "jax"}


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points run on it")


def test_entry_points_refuse_to_drop_to_cpu(no_cuda):
    cfg = TL.llama_tiny()
    with pytest.raises(TE.UnavailableError):
        TL.init_params(cfg)
    with pytest.raises(TE.UnavailableError):
        TL.params_from_numpy({"embed": torch.zeros(2, 2).numpy()})
    params = TL.init_params(cfg, device="cpu")
    with pytest.raises(TE.UnavailableError):
        ServingEngine(TL, params, cfg)
    assert ServingEngine(TL, params, cfg, device="cpu").device.type == "cpu"


def test_generation_and_moe_entry_points_refuse_to_drop_to_cpu(no_cuda):
    from paddle_tpu_torch.models import moe as TM
    cfg = TM.moe_tiny()
    with pytest.raises(TE.UnavailableError):
        TM.init_params(cfg)
    with pytest.raises(TE.UnavailableError):
        TL.init_cache(TL.llama_tiny(), 1, 8)
    with pytest.raises(TE.UnavailableError):
        TM.init_cache(cfg, 1, 8)
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(TE.UnavailableError):
        ServingEngine(TM, params, cfg)
    # generation follows its parameters' device
    assert TM.generate(params, [[1, 2]], cfg,
                       max_new_tokens=2).device.type == "cpu"


def test_dit_entry_points_refuse_to_drop_to_cpu(no_cuda):
    from paddle_tpu_torch.models import dit as TDIT
    cfg = TDIT.dit_tiny()
    with pytest.raises(TE.UnavailableError):
        TDIT.init_params(cfg)
    with pytest.raises(TE.UnavailableError):
        TDIT.params_from_numpy({"pos": torch.zeros(2, 2).numpy()})
    params = TDIT.init_params(cfg, device="cpu")
    # sampling and training follow their parameters' device
    out = TDIT.ddim_sample(params, [1, 2], cfg, steps=2)
    assert out.device.type == "cpu" and out.shape == (2, 4, 8, 8)
    x = torch.zeros(2, 4, 8, 8)
    batch = (x, torch.tensor([3, 4]), torch.tensor([1, 2]), x)
    step = TDIT.make_train_step(cfg)
    _, _, loss = step(params, TDIT.adamw_init(params), batch)
    assert loss.device.type == "cpu"


def test_eager_surface_refuses_to_drop_to_cpu(no_cuda):
    cfg = TL.llama_tiny(num_hidden_layers=1)
    prev = TD._current_device
    TD._current_device = None
    try:
        with pytest.raises(TE.UnavailableError):
            TL.LlamaForCausalLM(cfg)
        with pytest.raises(TE.UnavailableError):
            paddle_tpu_torch.to_tensor([1, 2, 3])
        with pytest.raises(TE.UnavailableError):
            paddle_tpu_torch.seed(0)
        with pytest.raises(TE.UnavailableError):
            paddle_tpu_torch.get_device()
        assert paddle_tpu_torch.set_device("cpu") == "cpu"
        assert paddle_tpu_torch.to_tensor([1.5]).dtype == torch.float32
        assert TL.LlamaForCausalLM(cfg).lm_head.weight.device.type == "cpu"
    finally:
        TD._current_device = prev

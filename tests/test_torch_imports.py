"""The port stands alone and runs on the card unless told otherwise.

- No module under ``paddle_tpu_torch/``, and not ``chip_smoke.py``,
  imports ``jax``, ``paddle_tpu`` or ``ml_dtypes`` (the card's machine
  has no ``ml_dtypes``; checked on the source with ``ast``, so a lazy
  import inside a function is caught too).
- Entry points called without ``device=`` raise on a box without a CUDA
  device instead of running on the CPU; so do the eager surface's
  (``LlamaForCausalLM``, ``to_tensor``, ``seed``, the ``DataLoader``'s
  batches, ``load``, ``Model``'s inputs, the op library's creation and
  random ops) until ``set_device("cpu")`` (or the loader's
  ``places="cpu"``) asks for the CPU.
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
_FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


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
            "core/flags.py", "training/guards.py", "loadgen/__init__.py",
            "loadgen/traces.py", "monitor/slo.py", "testing/faults.py",
            "distributed/heartbeat.py", "inference/failover.py",
            "monitor/__init__.py", "monitor/registry.py",
            "monitor/exposition.py", "monitor/trace.py",
            "monitor/forensics.py", "monitor/programs.py",
            "monitor/exectime.py", "monitor/numerics.py",
            "monitor/server.py", "loadgen/replay.py",
            "loadgen/scorecard.py", "monitor/memory.py",
            "monitor/profile_capture.py", "monitor/federation.py",
            "device/memory.py", "distributed/fleet/__init__.py",
            "distributed/fleet/elastic.py", "distributed/spmd.py",
            "distributed/introspect.py", "monitor/fleet.py",
            "kernels/ring_attention.py", "distributed/checkpoint/__init__.py",
            "distributed/checkpoint/manager.py", "training/sentinel.py",
            "monitor/steptimer.py", "monitor/timeseries.py",
            "distributed/env.py", "distributed/launch/main.py",
            "distributed/launch/__main__.py",
            "training/elastic_worker.py", "framework/io.py",
            "io/dataset.py", "io/sampler.py", "io/dataloader.py",
            "io/native_feed.py", "nn/layer/loss.py", "metric.py",
            "hapi/model.py", "hapi/callbacks.py", "callbacks.py",
            "monitor/mfu.py", "monitor/comms.py",
            "monitor/roofline.py", "profiler/__init__.py",
            "profiler/statistics.py", "kernels/autotune.py",
            "incubate/autotune.py", "autograd/__init__.py",
            "autograd/py_layer.py", "core/state.py", "core/dtype.py",
            "core/tensor.py", "core/selected_rows.py", "ops/__init__.py",
            "ops/_op.py", "ops/creation.py", "ops/math.py",
            "ops/reduction.py", "ops/manipulation.py", "ops/logic.py",
            "ops/linalg.py", "ops/random.py", "ops/composite.py",
            "tensor/__init__.py", "testing/op_cases.py",
            "ops/math_ext.py", "ops/manipulation_ext.py",
            "ops/linalg_ext.py", "ops/misc_ext.py", "ops/fft_ops.py",
            "fft.py", "linalg.py", "signal.py", "amp/__init__.py",
            "amp/amp_lists.py", "amp/auto_cast.py", "amp/grad_scaler.py",
            "amp/debugging.py"} <= scanned
    files.append(_ROOT.parent / "chip_smoke.py")
    bad = [(str(f.relative_to(_ROOT.parent)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from paddle_tpu.models import llama\n"
                 "    import jax.numpy as jnp\n    import ml_dtypes\n")
    assert {m.split(".")[0] for m in _imported_modules(f)} == {
        "paddle_tpu", "jax", "ml_dtypes"}


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


def test_make_mesh_refuses_to_drop_to_cpu(no_cuda):
    """A mesh runs on the card by default (a one-rank NCCL group there);
    without one it raises before any process group starts."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import spmd
    for device in (None, "cuda"):
        with pytest.raises(TE.UnavailableError):
            spmd.make_mesh((1, 1, 1), ("dp", "fsdp", "tp"), device=device)
    with pytest.raises(TE.UnavailableError):
        spmd.init_group("nccl")
    assert not dist.is_initialized()


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


def test_data_and_hapi_entry_points_refuse_to_drop_to_cpu(no_cuda,
                                                          tmp_path):
    import numpy as np
    from paddle_tpu_torch import io as tio
    prev = TD._current_device
    TD._current_device = None
    try:
        ds = tio.TensorDataset([np.arange(8)])
        for mode in ("thread", "native"):
            with pytest.raises(TE.UnavailableError):
                next(iter(tio.DataLoader(ds, batch_size=2,
                                         worker_mode=mode)))
        (b,) = next(iter(tio.DataLoader(ds, batch_size=2, places="cpu")))
        assert b.device.type == "cpu"
        paddle_tpu_torch.save({"w": torch.ones(2)}, str(tmp_path / "w"))
        with pytest.raises(TE.UnavailableError):
            paddle_tpu_torch.load(str(tmp_path / "w"))
        model = paddle_tpu_torch.Model(torch.nn.Identity())
        with pytest.raises(TE.UnavailableError):
            model.predict_batch([np.ones(2)])
        paddle_tpu_torch.set_device("cpu")
        assert paddle_tpu_torch.load(
            str(tmp_path / "w"))["w"].device.type == "cpu"
    finally:
        TD._current_device = prev


def test_op_library_creation_refuses_to_drop_to_cpu(no_cuda):
    prev = TD._current_device
    TD._current_device = None
    try:
        for make in (lambda: paddle_tpu_torch.zeros([2, 3]),
                     lambda: paddle_tpu_torch.randn([2, 3]),
                     lambda: paddle_tpu_torch.to_tensor([1.0, 2.0]),
                     lambda: paddle_tpu_torch.arange(4),
                     lambda: paddle_tpu_torch.full([2], 1.0)):
            with pytest.raises(TE.UnavailableError):
                make()
        assert paddle_tpu_torch.zeros([2], device="cpu").device.type == "cpu"
        paddle_tpu_torch.set_device("cpu")
        assert paddle_tpu_torch.zeros([2, 3]).device.type == "cpu"
        assert paddle_tpu_torch.randn([2, 3]).device.type == "cpu"
        assert paddle_tpu_torch.to_tensor([1.0]).device.type == "cpu"
    finally:
        TD._current_device = prev

#!/usr/bin/env python3
"""Per-leaf gradients of the mesh path on a mesh of one against the
unmeshed path, and of each path against itself, on the card.

For each of ``chip_smoke.py``'s four mesh phases' configurations
(``train_setup`` with the materialising cross entropy, the packed rung,
the MoE rung with dense dispatch, DiT-XL/2 at 32 latents), takes
``llama.loss_and_grads`` twice unmeshed and twice meshed (parameters
placed by ``shard_params`` on a (1, 1, 1) or (1, 1, 1, 1) mesh over a
one-rank NCCL group) from the same random weights, and prints, a leaf a
line, ``(relative L2 error, the reference's norm, share of entries that
differ)`` for meshed against unmeshed, unmeshed twice and meshed twice:

    python3 scripts/torch_mesh_grads.py

Prints the card's name and power limit first; exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _named(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{pre}{k}.")
    else:
        yield pre[:-1], tree


def _rel(a, b):
    out = {}
    for k in a:
        d, n = float((a[k] - b[k]).norm()), float(a[k].norm())
        out[k] = (round(d / n, 6) if n else d, f"{n:.3e}",
                  round(float(((a[k] - b[k]).abs() > 0).float().mean()), 5))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_mesh_grads: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import dit as DIT
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)

    def grads(fam, cfg, params, batch, mesh):
        loss = fam.loss_fn
        if mesh is not None:
            params = fam.shard_params(C._tree_copy(params), cfg, mesh)

            def loss(p, b, c):
                return fam.loss_fn(p, b, c, mesh=mesh)
        v, g = L.loss_and_grads(params, batch, cfg, loss=loss)
        return float(C._full_value(v)), {
            k: C._full_value(t).float() for k, t in _named(g)}

    def run(name, fam, cfg, params, batch, shape, names):
        mesh = spmd.make_mesh(shape, names)
        ls, gs = grads(fam, cfg, params, batch, None)
        ls2, gs2 = grads(fam, cfg, params, batch, None)
        lm, gm = grads(fam, cfg, params, batch, mesh)
        lm2, gm2 = grads(fam, cfg, params, batch, mesh)
        print(f"== {name} loss single {ls} {ls2} mesh {lm} {lm2}")
        r1, r2, r3 = _rel(gs, gm), _rel(gs, gs2), _rel(gm, gm2)
        for k in gs:
            print(f"{name} {k} mesh_vs_single={r1[k]} "
                  f"single_twice={r2[k]} mesh_twice={r3[k]}", flush=True)
        torch.cuda.empty_cache()

    _, params, _, _, batch = C.train_setup(torch, dev)
    cfg = L.llama_3_8b(num_hidden_layers=C.TRAIN_LAYERS, fused_ce=False)
    run("llama", L, cfg, params, batch, (1, 1, 1), ("dp", "fsdp", "tp"))
    del params
    torch.cuda.empty_cache()
    cfg, params, _, _, batch, _, _ = C.packed_train_setup(torch, dev)
    run("packed", L, cfg, params, batch, (1, 1, 1), ("dp", "fsdp", "tp"))
    del params
    torch.cuda.empty_cache()
    cfg, params, _, _, batch = C.moe_train_setup(torch, dev)
    cfg = dataclasses.replace(cfg, dispatch_mode="dense")
    run("moe", M, cfg, params, batch, (1, 1, 1, 1),
        ("dp", "fsdp", "ep", "tp"))
    del params
    torch.cuda.empty_cache()
    cfg, params, _, _, batch = C.dit_train_setup(torch, dev)
    run("dit", DIT, cfg, params, batch, (1, 1, 1), ("dp", "fsdp", "tp"))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

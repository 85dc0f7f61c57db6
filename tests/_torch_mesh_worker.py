"""One rank of the port's multi-rank CPU tests (not collected; launched by
``tests/_torch_mesh_common.launch``).

    python tests/_torch_mesh_worker.py DIR RANK WORLD CASE [CASE ...]

Joins a gloo group of WORLD ranks through ``file://DIR/pg``, then runs
each CASE (a ``case_<name>`` function below) in order. A case reads its
inputs from ``DIR/in_<name>.npz`` and writes ``DIR/out_<name>.npz``
(rank 0) or ``DIR/out_<name>_r<rank>.json`` (every rank). The port
only: nothing of JAX is imported here.
"""
from __future__ import annotations

import json
import os
import sys
import time

T0 = float(os.environ.get("MESH_LAUNCH_T0", time.time()))

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_mesh_common import load_tree  # noqa: E402

from paddle_tpu_torch.distributed import spmd  # noqa: E402
from paddle_tpu_torch.models import dit as TD  # noqa: E402
from paddle_tpu_torch.models import llama as TL  # noqa: E402
from paddle_tpu_torch.models import moe as TM  # noqa: E402

DIR, RANK, WORLD = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])


def _in(name):
    return load_tree(os.path.join(DIR, f"in_{name}.npz"))


def _out(name, tree):
    """Rank 0 writes the case's results; every rank takes part in the
    collectives that gather them."""
    host = {k: spmd.full(v).detach().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in flat_tensors(tree).items()}
    if RANK == 0:
        np.savez(os.path.join(DIR, f"out_{name}.npz"), **host)


def flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _params(tree):
    return TL.params_from_numpy(tree, device="cpu")


def _llama_cfg():
    return TL.llama_tiny(fused_ce=False)


def case_llama_step():
    """(2, 2, 2) mesh, sp: the unguarded and the guarded step at lr 1e-2,
    and the placements of ``param_specs``."""
    d = _in("llama_step")
    cfg = _llama_cfg()
    mesh = spmd.make_mesh((2, 2, 2), ("dp", "fsdp", "tp"), device="cpu")
    ids = torch.as_tensor(d["ids"])
    sp_ = TL.shard_params(_params(d["params"]), cfg, mesh)
    specs = {"wq": str(spmd.spec_of(sp_["layers"]["wq"])),
             "embed": str(spmd.spec_of(sp_["embed"])),
             "batch": str(spmd.spec_of(TL.shard_batch(ids, mesh)))}
    step = TL.make_train_step(cfg, mesh, lr=1e-2, sp=True)
    p, _, loss = step(sp_, TL.adamw_init(sp_), ids)
    gp = TL.shard_params(_params(d["params"]), cfg, mesh)
    gstep = TL.make_train_step(cfg, mesh, lr=1e-2, sp=True, guard=True,
                               numerics=True)
    gp, _, gloss, health = gstep(gp, TL.adamw_init(gp), ids, float("inf"))
    _out("llama_step", {"loss": loss, "params": p, "gloss": gloss,
                        "gparams": gp, "finite": health["finite"],
                        "grad_norm": health["grad_norm"],
                        "wq_absmax": health["numerics"]["layers"]["wq"][
                            "absmax"]})
    if RANK in (0, WORLD - 1):
        with open(os.path.join(DIR, f"out_specs_r{RANK}.json"), "w") as f:
            json.dump({**specs, "grad_norm": float(health["grad_norm"]),
                       "finite": bool(health["finite"])}, f)


def case_llama_packed():
    """(2, 2, 2) mesh, sp: one step on a sequence-packed batch."""
    d = _in("llama_packed")
    cfg = _llama_cfg()
    mesh = spmd.make_mesh((2, 2, 2), ("dp", "fsdp", "tp"), device="cpu")
    p = TL.shard_params(_params(d["params"]), cfg, mesh)
    batch = tuple(torch.as_tensor(d[k]) for k in ("inp", "labels", "seg",
                                                  "pos"))
    p, _, loss = TL.make_train_step(cfg, mesh, lr=1e-2, sp=True)(
        p, TL.adamw_init(p), batch)
    _out("llama_packed", {"loss": loss, "params": p})


def case_forward_gqa():
    """(1, 2, 4) mesh (2 kv heads over tp 4): ``make_forward`` logits and
    4 greedy tokens, each a full forward of the grown sequence."""
    d = _in("forward_gqa")
    cfg = TL.llama_tiny()
    mesh = spmd.make_mesh((1, 2, 4), ("dp", "fsdp", "tp"), device="cpu")
    p = TL.shard_params(_params(d["params"]), cfg, mesh)
    fwd = TL.make_forward(cfg, mesh)
    ids = torch.as_tensor(d["ids"]).long()
    logits = fwd(p, ids)
    spec = str(spmd.spec_of(logits))
    seq = ids
    with torch.no_grad():
        for _ in range(4):
            nxt = spmd.full(fwd(p, seq))[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    _out("forward_gqa", {"logits": logits, "tokens": seq[:, ids.shape[1]:]})
    if RANK == 0:
        with open(os.path.join(DIR, "out_forward_gqa_r0.json"), "w") as f:
            json.dump({"spec": spec}, f)


def case_moe():
    """(2, 2, 2, 1) dp / fsdp / ep / tp mesh: the loss (dense dispatch)."""
    d = _in("moe")
    cfg = TM.moe_tiny()
    mesh = spmd.make_mesh((2, 2, 2, 1), ("dp", "fsdp", "ep", "tp"),
                          device="cpu")
    p = TM.shard_params(_params(d["params"]), cfg, mesh)
    with torch.no_grad():
        loss = TM.loss_fn(p, torch.as_tensor(d["ids"]), cfg, mesh=mesh)
    _out("moe", {"loss": loss})


# capacity dispatch on a mesh (ROADMAP A9b): each mesh's shape
MOE_CAPACITY_MESHES = {"moe_cap_dp2": (2, 1, 1, 1),
                       "moe_cap_dp2_ep2": (2, 1, 2, 1)}


def _moe_capacity(name):
    """The forward (logits, aux), the loss and every gradient of
    ``moe_tiny(dispatch_mode="capacity")`` on the named mesh, then one
    ``make_train_step`` step's loss."""
    import functools
    d = _in("moe_cap")
    cfg = TM.moe_tiny(dispatch_mode="capacity",
                      capacity_factor=float(d["capacity_factor"]))
    mesh = spmd.make_mesh(MOE_CAPACITY_MESHES[name],
                          ("dp", "fsdp", "ep", "tp"), device="cpu")
    ids = torch.as_tensor(d["ids"])
    p = TM.shard_params(_params(d["params"]), cfg, mesh)
    with torch.no_grad():
        logits, aux = TM.forward(p, ids, cfg, mesh=mesh)
    loss, grads = TL.loss_and_grads(
        p, ids, cfg, loss=functools.partial(TM.loss_fn, mesh=mesh))
    _, _, step_loss = TM.make_train_step(cfg, mesh, lr=1e-2)(
        p, TM.adamw_init(p), ids)
    _out(name, {"logits": logits, "aux": aux, "loss": loss,
                "grads": grads, "step_loss": step_loss})


def case_moe_cap_dp2():
    _moe_capacity("moe_cap_dp2")


def case_moe_cap_dp2_ep2():
    _moe_capacity("moe_cap_dp2_ep2")


def case_dit():
    """(2, 2, 2) mesh: the DiT loss."""
    d = _in("dit")
    cfg = TD.dit_tiny()
    mesh = spmd.make_mesh((2, 2, 2), ("dp", "fsdp", "tp"), device="cpu")
    p = TD.shard_params(_params(d["params"]), cfg, mesh)
    batch = tuple(torch.as_tensor(d[k]) for k in ("x0", "t", "y", "noise"))
    with torch.no_grad():
        loss = TD.loss_fn(p, batch, cfg, mesh=mesh)
    _out("dit", {"loss": loss})


def case_ring():
    """4 "sp" ranks: ``ring_attention`` at the reference's three cases and
    the gradients of ``(ring(q, q, q) ** 2).sum()`` and of a GQA case."""
    from paddle_tpu_torch.kernels import ring_attention
    d = _in("ring")
    mesh = spmd.make_mesh((WORLD,), ("sp",), device="cpu")
    seq = spmd.P(None, "sp")
    out = {}
    for i in range(3):
        q, k, v = (spmd.shard(torch.as_tensor(d[f"c{i}"][n]), mesh, seq)
                   for n in ("q", "k", "v"))
        out[f"out{i}"] = ring_attention(q, k, v, mesh,
                                        causal=bool(d[f"c{i}"]["causal"]))
    q = spmd.shard(torch.as_tensor(d["grad"]["q"]), mesh,
                   seq).requires_grad_()
    (ring_attention(q, q, q, mesh, causal=True) ** 2).sum().backward()
    out["dq"] = q.grad
    qkv = [spmd.shard(torch.as_tensor(d["gqa"][n]), mesh,
                      seq).requires_grad_() for n in ("q", "k", "v")]
    (ring_attention(*qkv, mesh, causal=True) ** 2).sum().backward()
    out.update({f"gqa_d{n}": t.grad for n, t in zip("qkv", qkv)})
    _out("ring", out)


def case_introspect():
    """``describe_tree`` of llama and MoE trees placed on their meshes,
    on every rank (the byte table covers the whole mesh on each)."""
    from paddle_tpu_torch.distributed import introspect
    d = _in("introspect")
    mesh = spmd.make_mesh((2, 2, 2), ("dp", "fsdp", "tp"), device="cpu")
    llama = TL.shard_params(_params(d["llama"]), TL.llama_tiny(), mesh)
    mesh4 = spmd.make_mesh((2, 2, 2, 1), ("dp", "fsdp", "ep", "tp"),
                           device="cpu")
    moe = TM.shard_params(_params(d["moe"]), TM.moe_tiny(), mesh4)
    with open(os.path.join(DIR, f"out_introspect_r{RANK}.json"), "w") as f:
        json.dump({"llama": introspect.describe_tree(llama),
                   "moe": introspect.describe_tree(moe),
                   "leaf": introspect.describe_leaf(
                       llama["layers"]["wq"], "wq")}, f)


def case_fleet():
    """2 ranks: ``aggregated_snapshot`` with a gauge that differs by rank;
    rank 0 publishes a named beat and a telemetry frame on the default
    group's store, rank 1 reads both without a ``client``."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import heartbeat
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.monitor import fleet
    from paddle_tpu_torch.monitor import federation
    flags.set_flags({"FLAGS_enable_monitor": True})
    monitor.reset()
    monitor.set_gauge("test.rank", float(RANK))
    monitor.inc("test.steps", 5)
    payload = fleet.aggregated_snapshot()
    got = {"payload": {k: v for k, v in payload.items()
                       if k not in ("unix_time", "hosts")},
           "last_is_payload": fleet.last_aggregate() is payload,
           "client": type(heartbeat._kv_client()).__name__}
    if RANK == 0:
        heartbeat.publish_named("replica0", {"beat": 7})
        cfg = TL.llama_tiny()
        eng = ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                            num_slots=2, max_len=32, page_size=4,
                            device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=2))
        while eng.step():
            pass
        pub = federation.FramePublisher("replica1")
        got["published"] = pub.maybe_publish(eng, force=True) is not None
    dist.barrier()
    if RANK == 1:
        got["beat"] = heartbeat.read_named("replica0")
        view = federation.FleetSLOView()
        got["ingested"] = view.poll(["replica1"])
        got["frame_names"] = sorted(view.fresh_frames(["replica1"]))
    dist.barrier()
    with open(os.path.join(DIR, f"out_fleet_r{RANK}.json"), "w") as f:
        json.dump(got, f, default=str)


def _specs_on(specs, mesh):
    """``param_specs`` with the axes ``mesh`` lacks dropped (a (4,) fsdp
    mesh takes the reference's tp entries as unsharded)."""
    names = set(mesh.mesh_dim_names)
    if isinstance(specs, dict):
        return {k: _specs_on(v, mesh) for k, v in specs.items()}
    return spmd.P(*[e if e is None or e in names else None for e in specs])


def case_ckpt_mesh():
    """Checkpoints across meshes (4 ranks): the port's (2, 2) fsdp x tp
    save of float32 and bf16 params loaded onto a (4,) fsdp mesh; the
    JAX save over 8 fake devices (``DIR/jax8``) loaded onto the (2, 2)
    mesh; an async ``CheckpointManager`` save restored onto the (4,)
    mesh through ``restore_latest``'s agreement."""
    from paddle_tpu_torch.distributed import checkpoint as C
    d = _in("ckpt_mesh")
    cfg = _llama_cfg()
    specs = TL.param_specs(cfg)
    m22 = spmd.make_mesh((2, 2), ("fsdp", "tp"), device="cpu")
    m4 = spmd.make_mesh((4,), ("fsdp",), device="cpu")
    p32 = _params(d["params"])
    bf16 = TL._map(lambda t: t.to(torch.bfloat16), p32)

    def placed(tree, mesh, zeros=False):
        if zeros:
            tree = TL._map(torch.zeros_like, tree)
        return TL.shard_params(tree, cfg, mesh, _specs_on(specs, mesh))

    state = {"params": placed(p32, m22), "bf16": placed(bf16, m22),
             "step": 3}
    C.save_state_dict(state, os.path.join(DIR, "port22"))
    reload = {"params": placed(p32, m4, True),
              "bf16": placed(bf16, m4, True), "step": 0}
    C.load_state_dict(reload, os.path.join(DIR, "port22"))
    jax8 = {"params": placed(p32, m22, True),
            "bf16": placed(bf16, m22, True), "step": 0}
    C.load_state_dict(jax8, os.path.join(DIR, "jax8"))
    mgr = C.CheckpointManager(os.path.join(DIR, "managed"), async_save=True)
    mgr.save(5, state)
    for leaf in TL._leaves(state["params"]):
        leaf.to_local().add_(1.0)          # in place, after the snapshot
    restored = {"params": placed(p32, m4, True), "step": 0}
    step = mgr.restore_latest(restored)
    mgr.close()
    out = {"reload": reload["params"], "reload_bf16": reload["bf16"],
           "jax8": jax8["params"], "jax8_bf16": jax8["bf16"],
           "restored": restored["params"]}
    host = {k: spmd.full(v).detach().float().numpy()
            for k, v in flat_tensors(out).items()}
    if RANK == 0:
        np.savez(os.path.join(DIR, "out_ckpt_mesh.npz"), **host)
    with open(os.path.join(DIR, f"out_ckpt_mesh_r{RANK}.json"), "w") as f:
        json.dump({"steps": [reload["step"], jax8["step"],
                             restored["step"], step],
                   "placements": str(reload["params"]["embed"].placements)},
                  f)


def case_sentinel_agree():
    """The sentinel's skip agreement (2 ranks): rank 0 locally anomalous
    makes both skip; healthy steps with rank-dependent norms keep the
    EMA state rank-identical (the max norm wins)."""
    from paddle_tpu_torch.training import sentinel as S
    sent = S.AnomalySentinel(S.SentinelConfig(warmup_steps=1,
                                              name="agreetest"))
    verdicts = [sent.observe(finite=(RANK != 0), grad_norm=float("nan")),
                sent.observe(finite=True, grad_norm=1.0 + RANK),
                sent.observe(finite=True, grad_norm=2.0)]
    with open(os.path.join(DIR, f"out_sentinel_agree_r{RANK}.json"),
              "w") as f:
        json.dump({"verdicts": verdicts, "n": sent.stats.n,
                   "mean": sent.stats.mean, "cap": sent.gnorm_cap(),
                   "consecutive": sent.consecutive}, f)


def _mark(what):
    """One timestamped line in the rank's log (seconds since the launch,
    peak resident MB), so a failed launch shows where each rank spent
    its time and memory."""
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"[rank {RANK}] {time.time() - T0:.1f}s rss_max={rss:.0f}MB "
          f"{what}", flush=True)


def main():
    torch.set_num_threads(1)
    _mark("imported")
    dist.init_process_group("gloo", init_method=f"file://{DIR}/pg",
                            rank=RANK, world_size=WORLD)
    _mark("joined")
    # the launcher starts its cap on the ranks' own work once every rank
    # has joined (see _torch_mesh_common.launch)
    open(os.path.join(DIR, f"joined_r{RANK}"), "w").close()
    try:
        for case in sys.argv[4:]:
            globals()[f"case_{case}"]()
            dist.barrier()
            _mark(f"case {case} done")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

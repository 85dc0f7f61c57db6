"""An elastic training worker: the script ``ElasticManager.run`` launches.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        paddle_tpu_torch/training/elastic_worker.py --out DIR [options]

Each rank joins the launched world (``env.init_parallel_env``: NCCL on
the card, gloo with ``--device cpu``), builds the Llama train step (a
``dp`` mesh over every rank when there are several, the one-device step
for one) at ``--config`` widths (``tiny``: ``llama_tiny``; ``8b``:
``llama_3_8b``) and ``--layers`` deep, random weights from ``--seed``
and float32 AdamW moments, and resumes from the newest committed checkpoint under
``PADDLE_ELASTIC_CKPT_DIR`` (``fleet.elastic.load_state``; step 0 when
there is none). Step ``s`` trains on ids drawn from ``(--seed, s)``, so
a resumed world sees the batches an uninterrupted one would.
Every ``--save-every`` steps it checkpoints ``{"params", "opt"}``
through ``save_state`` (asynchronous: a world killed mid-save resumes
from the save before). On the first world (``PADDLE_ELASTIC_RUN`` 0)
the process exits hard (``os._exit(137)``, a ``kill -9``'s rc, no
cleanup) right after step ``--kill-at``; a rank listed in
``--fail-ranks`` exits with 137 before training while the world has
more than ``--min-world`` ranks (a sick host the manager scales in past); with
``--max-seconds`` a rank that runs that long exits with rc 124.

Rank 0 appends one JSON line a step to ``DIR/losses.jsonl``: ``run``,
``world``, ``step`` (1-based, after the update), ``loss``,
``resumed_from`` and the wall clock ``t``; the last line of a finished
world has ``"done"`` and the kernels' launch counts of the run
(``kernels.dispatch_stats``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--config", choices=("tiny", "8b"), default="tiny")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-every", type=int, default=2)
    p.add_argument("--kill-at", type=int, default=0,
                   help="exit hard after this step on the first world "
                        "(0: never)")
    p.add_argument("--fail-ranks", default="",
                   help="comma-separated ranks that exit at start while "
                        "the world is larger than --min-world")
    p.add_argument("--min-world", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="exit with rc 124 once the process has run this "
                        "long (0: never), so a hung world ends")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.max_seconds > 0:
        import threading
        timer = threading.Timer(args.max_seconds, os._exit, (124,))
        timer.daemon = True
        timer.start()
    import numpy as np
    import torch

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import env, spmd
    from paddle_tpu_torch.distributed.fleet import elastic
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.testing.faults import KILL_EXIT_CODE

    cpu = args.device == "cpu"
    env.init_parallel_env(device="cpu" if cpu else None)
    rank, world = env.get_rank(), env.get_world_size()
    run = elastic.elastic_run_index()
    fail = {int(r) for r in args.fail_ranks.split(",") if r}
    if rank in fail and world > args.min_world:
        os._exit(KILL_EXIT_CODE)
    dev = "cpu" if cpu else None
    if args.config == "tiny":
        cfg = L.llama_tiny(num_hidden_layers=args.layers, fused_ce=False)
    else:
        cfg = L.llama_3_8b(num_hidden_layers=args.layers)
    params = L.init_params(cfg, seed=args.seed, device=dev)
    mesh = None
    if world > 1:
        mesh = spmd.make_mesh((world, 1, 1), ("dp", "fsdp", "tp"),
                              device=dev)
        params = L.shard_params(params, cfg, mesh)
    opt = L.adamw_init(params, moment_dtype=torch.float32)
    step_fn = L.make_train_step(cfg, mesh, lr=args.lr)
    start, state = elastic.load_state({"params": params, "opt": opt})
    params, opt = state["params"], state["opt"]
    device = L._leaves(params)[0].device

    def log(**rec):
        if rank == 0:
            with open(os.path.join(args.out, "losses.jsonl"), "a") as f:
                f.write(json.dumps(dict(rec, run=run, world=world,
                                        resumed_from=start,
                                        t=time.time())) + "\n")

    pending = None
    for step in range(start, args.steps):
        ids = np.random.default_rng([args.seed, step]).integers(
            0, cfg.vocab_size, (args.batch, args.seq + 1))
        params, opt, loss = step_fn(params, opt,
                                    torch.as_tensor(ids, device=device))
        log(step=step + 1, loss=float(spmd.full(loss)))
        if (step + 1) % args.save_every == 0:
            pending = elastic.save_state(step + 1,
                                         {"params": params, "opt": opt})
        if run == 0 and step + 1 == args.kill_at:
            os._exit(KILL_EXIT_CODE)
    elastic.finish_saves(pending)
    log(done=True, launches=K.dispatch_stats())
    return 0


if __name__ == "__main__":
    # run as a file: the checkout's root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main())

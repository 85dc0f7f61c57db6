"""A ``Model.fit`` run of the port (not collected; the port only,
nothing of JAX). ``tests/test_torch_hapi.py`` calls :func:`fit_linear`
in its own process and starts this file as a process of its own with
``FLAGS_fault_injection=train.batch:kill:N`` to kill it mid-epoch:

    python tests/_torch_hapi_worker.py DIR

:func:`fit_linear` reads ``DIR/in.npz`` (the weights ``w`` / ``b`` and
the data ``x`` / ``y``), fits a ``Linear`` with Adam over batches of 4
through a ``FaultTolerantCheckpoint`` under ``DIR/ck`` (a save a step,
resuming from the newest), and hands each step's loss to ``on_loss``.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu_torch as P  # noqa: E402


def fit_linear(out, on_loss):
    P.set_device("cpu")
    d = np.load(os.path.join(out, "in.npz"))
    net = P.nn.Linear(*d["w"].shape)
    net.set_state_dict({"weight": d["w"], "bias": d["b"]})
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(learning_rate=0.05,
                                   parameters=net.parameters()),
                  P.nn.MSELoss())

    class Losses(P.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            on_loss(logs["loss"][0])

    ck = P.callbacks.FaultTolerantCheckpoint(
        os.path.join(out, "ck"), save_interval_steps=1, async_save=False,
        preemption_hook=False)
    loader = P.io.DataLoader(P.io.TensorDataset([d["x"], d["y"]]),
                             batch_size=4, shuffle=True, seed=21)
    model.fit(loader, epochs=1, verbose=0, callbacks=[Losses(), ck])
    return model, ck


def main():
    out = sys.argv[1]
    with open(os.path.join(out, "losses.txt"), "a") as f:
        fit_linear(out, lambda loss: (f.write(repr(loss) + "\n"),
                                      f.flush()))


if __name__ == "__main__":
    main()

"""The port's sharding inspector (``paddle_tpu_torch/distributed/
introspect.py``) against the JAX reference's (``paddle_tpu/distributed/
introspect.py``; its own tests are in ``tests/test_comms_roofline.py``).

The same llama and MoE trees are placed by their ``param_specs``, on a
(2, 2, 2) dp / fsdp / tp mesh and a (2, 2, 2, 1) dp / fsdp / ep / tp
mesh: JAX's on its 8 fake CPU devices here, the port's on 8 gloo ranks
(``tests/_torch_mesh_worker.py`` case ``introspect``). ``describe_tree``
is compared field by field; the per-device byte table covers every rank
of the mesh on each rank, so the imbalance block is the reference's on
every rank. Device names differ by design (``TFRT_CPU_<n>`` against
``cpu:<rank>``) and are not compared."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import introspect as JI
from paddle_tpu.models import llama as JL
from paddle_tpu.models import moe as JM
from paddle_tpu_torch.distributed import introspect as TI

from _torch_mesh_common import launched, load_json, save_tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    llama = JL.init_params(JL.llama_tiny(), jax.random.PRNGKey(0))
    moe = JM.init_params(JM.moe_tiny(), jax.random.key(3))
    tmp = launched(tmp_path_factory, "introspect", 8, ["introspect"],
                   lambda d: save_tree(d / "in_introspect.npz",
                                       {"llama": _np(llama),
                                        "moe": _np(moe)}))
    devs = np.array(jax.devices()[:8])
    m3 = Mesh(devs.reshape(2, 2, 2), ("dp", "fsdp", "tp"))
    m4 = Mesh(devs.reshape(2, 2, 2, 1), ("dp", "fsdp", "ep", "tp"))

    def place(tree, specs, mesh):
        return jax.tree.map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), tree,
            specs, is_leaf=lambda x: isinstance(x, JP))

    want = {"llama": JI.describe_tree(place(llama, JL.param_specs(
                JL.llama_tiny()), m3)),
            "moe": JI.describe_tree(place(moe, JM.param_specs(
                JM.moe_tiny()), m4))}
    want["leaf"] = JI.describe_leaf(
        place(llama, JL.param_specs(JL.llama_tiny()), m3)["layers"]["wq"],
        "wq")
    return want, [load_json(tmp / f"out_introspect_r{r}.json")
                  for r in range(8)]


@pytest.mark.parametrize("tree", ["llama", "moe"])
def test_describe_tree_matches_the_reference(ran, tree):
    want, got = ran
    w, g = want[tree], got[0][tree]
    assert [leaf["path"] for leaf in g["leaves"]] == \
        [leaf["path"] for leaf in w["leaves"]]
    for gl, wl in zip(g["leaves"], w["leaves"]):
        assert gl == wl, (gl["path"], gl, wl)
    for key in ("num_arrays", "truncated", "total_global_bytes",
                "total_shard_bytes_per_device", "replicated_bytes",
                "imbalance"):
        assert g[key] == w[key], key
    # every rank computes the whole mesh's table
    assert all(r[tree] == g for r in got[1:])


def test_describe_leaf_matches_the_reference(ran):
    want, got = ran
    assert got[0]["leaf"] == want["leaf"]
    assert got[0]["leaf"]["spec"] == "PartitionSpec(None, 'fsdp', 'tp')"


def test_plain_tensors_and_registration(monkeypatch):
    """A tree of plain tensors reports unsharded leaves, as the
    reference's single-device arrays; registration follows the monitor
    flag."""
    import torch
    from paddle_tpu_torch import monitor as TM
    from paddle_tpu_torch.core import flags as TF
    tree = {"w": np.ones((4, 8), np.float32)}
    want = JI.describe_tree(jax.tree.map(jax.numpy.asarray, tree))
    got = TI.describe_tree({"w": torch.ones(4, 8)})
    assert got["leaves"] == want["leaves"]
    assert got["imbalance"]["devices"] == want["imbalance"]["devices"] == 1
    saved = TF.flag_value("enable_monitor")
    try:
        TF.set_flags({"FLAGS_enable_monitor": False})
        assert TI.register_sharded_tree("t", {"w": torch.ones(2)}) is None
        assert TI.sharding_snapshot()["trees"] == {}
        TF.set_flags({"FLAGS_enable_monitor": True})
        assert TI.register_sharded_tree("t", {"w": torch.ones(2)})
        assert TI.ensure_sharded_tree("t", lambda: 1 / 0) is False
        snap = TI.sharding_snapshot()
        assert set(snap) == {"world", "programs", "trees"}
        assert snap["world"] == {"devices": 1, "local_devices": 1,
                                 "process_count": 1}
        assert list(snap["trees"]) == ["t"]
        TM.reset()
        assert TI.sharding_snapshot()["trees"] == {}
        assert TI.ensure_sharded_tree("t", lambda: {"w": torch.ones(2)})
    finally:
        TI.reset()
        TF.set_flags({"FLAGS_enable_monitor": saved})

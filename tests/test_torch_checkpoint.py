"""Port parity: the distributed checkpoint and its manager
(``paddle_tpu_torch/distributed/checkpoint/`` against
``paddle_tpu/distributed/checkpoint/``).

- Format, both ways, bit for bit: a checkpoint the JAX package writes
  (float32, bfloat16 and int32 leaves, Adam's 0-d ``int32`` step) loads
  into the port, the step into the port's ``int`` slot; one the port
  writes loads into the JAX package (params and moments; the port's
  ``int`` step reaches JAX as an ``int``). The same tree written by both
  gives the same metadata and the same ``.npy`` members byte for byte,
  bfloat16 included. The JAX loader cannot assemble bfloat16 entries at
  all (numpy loads the ``'<V2'`` payload as raw void, which will not
  cast into an ``ml_dtypes`` array): pinned as reference behaviour.
- Across meshes (4 gloo ranks, ``tests/_torch_mesh_worker.py``
  ``case_ckpt_mesh``, launched once for the module): a port save on a
  (2, 2) fsdp x tp mesh reloads on a (4,) fsdp mesh; a JAX save over 8
  fake devices loads on the (2, 2) mesh; JAX loads the port's mesh
  save; the windows of a (2, 2) save are JAX's; an async manager save
  restores through ``restore_latest``'s agreement.
- The commit protocol: artifacts, refusal of uncommitted / corrupt /
  truncated dirs naming the file, a raised failure at each fault point
  leaving the previous checkpoint, a kill at each fault point in a
  subprocess (sync, and async at ``checkpoint.write``).
- ``CheckpointManager``: its lifecycle against the reference's on the
  same saves, retention, the interval policy, the fallback past a
  corrupt dir, graveyard recovery, the emergency save and the SIGTERM
  hook (subprocess), ``ambient_phase`` billing, metrics.
- An async save followed at once by an in-place train step loads the
  values at the save.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from _torch_mesh_common import launched, load_json, load_tree, save_tree
from paddle_tpu import monitor as JMon
from paddle_tpu.core import flags as JF
from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import monitor as TMon
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.distributed.checkpoint import (CheckpointError,
                                                     CheckpointManager)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W0 = torch.arange(12, dtype=torch.float32).reshape(3, 4)
POINTS = ("checkpoint.write", "checkpoint.metadata", "checkpoint.rename",
          "checkpoint.commit")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


def _state(step):
    return {"w": W0 + step, "step": step}


def _template():
    return {"w": torch.zeros(3, 4), "step": 0}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np(tree))


def _jax_tree():
    """llama_tiny float32 params, random float32 moments and the
    reference's Adam step (a 0-d int32), a bf16 copy of the params and
    an int32 leaf, as numpy."""
    params = _np(JL.init_params(JL.llama_tiny(), jax.random.PRNGKey(0)))
    return {"params": params,
            "opt": {"step": np.asarray(5, np.int32),
                    "m": _rand_like(params, 1), "v": _rand_like(params, 2)},
            "bf16": jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16),
                                 params),
            "ids": np.arange(12, dtype=np.int32).reshape(3, 4)}


def _to_torch(tree):
    return TL.params_from_numpy(tree, device="cpu")


def _zeros_torch(tree):
    return TL._map(torch.zeros_like, tree)


def _bits(x):
    """Host bytes of a leaf (torch or numpy), bf16 as its 16-bit words."""
    if torch.is_tensor(x):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bits(got, want):
    g_leaves, w_leaves = (jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_bits, t, is_leaf=torch.is_tensor))[0]
        for t in (got, want))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


# -- the format, both ways ----------------------------------------------------

def test_jax_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    tree = _jax_tree()
    JC.save_state_dict({**jax.tree.map(jnp.asarray, tree), "step": 5},
                       str(tmp_path / "j"))
    tmpl = {"params": _zeros_torch(_to_torch(tree["params"])),
            "opt": {"step": 0,
                    "m": _zeros_torch(_to_torch(tree["opt"]["m"])),
                    "v": _zeros_torch(_to_torch(tree["opt"]["v"]))},
            "bf16": _zeros_torch(_to_torch(tree["bf16"])),
            "ids": torch.zeros(3, 4, dtype=torch.int32), "step": 0}
    assert tmpl["bf16"]["embed"].dtype == torch.bfloat16
    TC.load_state_dict(tmpl, str(tmp_path / "j"))
    # the reference's 0-d int32 Adam step fills the port's int slot
    assert tmpl["opt"]["step"] == 5 and type(tmpl["opt"]["step"]) is int
    assert tmpl["step"] == 5
    for key in ("params", "bf16", "ids"):
        _assert_bits(tmpl[key], tree[key])
    _assert_bits({k: tmpl["opt"][k] for k in "mv"},
                 {k: tree["opt"][k] for k in "mv"})


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    tree = _jax_tree()
    port = {"params": _to_torch(tree["params"]),
            "opt": {"step": 5, "m": _to_torch(tree["opt"]["m"]),
                    "v": _to_torch(tree["opt"]["v"])},
            "step": 5}
    TC.save_state_dict(port, str(tmp_path / "p"))
    jt = {"params": jax.tree.map(jnp.zeros_like, tree["params"]),
          "opt": {"step": jnp.zeros((), jnp.int32),
                  "m": jax.tree.map(jnp.zeros_like, tree["opt"]["m"]),
                  "v": jax.tree.map(jnp.zeros_like, tree["opt"]["v"])},
          "step": 0}
    JC.load_state_dict(jt, str(tmp_path / "p"))
    _assert_bits(_np(jt["params"]), tree["params"])
    _assert_bits(_np({k: jt["opt"][k] for k in "mv"}),
                 {k: tree["opt"][k] for k in "mv"})
    # the port's host-int step reaches JAX as an int
    assert jt["opt"]["step"] == 5 and type(jt["opt"]["step"]) is int


def test_same_tree_gives_the_references_metadata_and_members(tmp_path):
    tree = _jax_tree()
    small = {"ln_f": tree["params"]["ln_f"], "wq": tree["params"]["layers"][
        "wq"], "bf16": tree["bf16"]["layers"]["wo"], "ids": tree["ids"]}
    JC.save_state_dict({**jax.tree.map(jnp.asarray, small), "step": 5,
                        "note": "x"}, str(tmp_path / "j"))
    TC.save_state_dict({**_to_torch(small), "step": 5, "note": "x"},
                       str(tmp_path / "p"))
    meta = {side: json.loads((tmp_path / side / "0.metadata").read_text())
            for side in "jp"}
    assert meta["p"] == meta["j"]
    with zipfile.ZipFile(tmp_path / "j" / "0_0.distcp") as zj, \
            zipfile.ZipFile(tmp_path / "p" / "0_0.distcp") as zp:
        assert sorted(zp.namelist()) == sorted(zj.namelist())
        for name in zj.namelist():
            assert zp.read(name) == zj.read(name), name
    assert set(os.listdir(tmp_path / "p")) == set(os.listdir(tmp_path / "j"))


def test_reference_loader_cannot_assemble_bf16(tmp_path):
    """Reference behaviour: the JAX loader's ``np.zeros(..., bfloat16)``
    window assembly refuses numpy's raw ``'<V2'`` payload, whoever wrote
    it. The port's member holds JAX's bf16 bits: read as ml_dtypes
    bfloat16 words, it equals the source."""
    bf = _jax_tree()["bf16"]["layers"]["wo"]
    TC.save_state_dict({"w": _to_torch({"w": bf})["w"]}, str(tmp_path / "p"))
    JC.save_state_dict({"w": jnp.asarray(bf)}, str(tmp_path / "j"))
    for side in "pj":
        with pytest.raises(ValueError, match="cast"):
            JC.load_state_dict({"w": jnp.zeros(bf.shape, jnp.bfloat16)},
                               str(tmp_path / side))
    with np.load(tmp_path / "p" / "0_0.distcp") as z:
        got = z["w@0"].view(ml_dtypes.bfloat16)
    assert np.array_equal(got.view(np.int16), bf.view(np.int16))


def test_load_places_slots_by_kind(tmp_path):
    """A tensor slot is filled in place; an int slot takes a 0-d entry as
    an int; another slot gets a tensor on ``device``; without a card the
    default device raises (no fallback to the CPU)."""
    path = str(tmp_path / "ck")
    TC.save_state_dict({"w": W0, "s": torch.tensor(3), "v": W0 * 2,
                        "gone": W0}, path)
    w = torch.zeros(3, 4)
    tmpl = {"w": w, "s": 0, "v": None}
    TC.load_state_dict(tmpl, path, device="cpu")
    assert tmpl["w"] is w and torch.equal(w, W0)
    assert tmpl["s"] == 3 and type(tmpl["s"]) is int
    assert torch.equal(tmpl["v"], W0 * 2) and "gone" not in tmpl
    with pytest.raises(CheckpointError, match="shape"):
        TC.load_state_dict({"w": torch.zeros(2, 2)}, path)
    if not torch.cuda.is_available():
        from paddle_tpu_torch.core import enforce as E
        with pytest.raises(E.UnavailableError):
            TC.load_state_dict({"v": None}, path)


# -- across meshes (4 gloo ranks) ---------------------------------------------

def _mesh_prepare(tmp):
    cfg = JL.llama_tiny()
    params = JL.init_params(cfg, jax.random.PRNGKey(4))
    save_tree(tmp / "in_ckpt_mesh.npz", {"params": _np(params)})
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "fsdp", "tp"))
    specs = JL.param_specs(cfg)

    def place(tree):
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree,
            specs)

    JC.save_state_dict({
        "params": place(params),
        "bf16": place(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                   params)),
        "step": jnp.asarray(7, jnp.int32)}, str(tmp / "jax8"))


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    return launched(tmp_path_factory, "ckpt", 4, ["ckpt_mesh"],
                    _mesh_prepare)


def _want(meshed):
    params = load_tree(meshed / "in_ckpt_mesh.npz")["params"]
    bf16 = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16).astype(
        np.float32), params)
    return params, bf16


def test_port_mesh_save_reloads_on_another_mesh(meshed):
    out = load_tree(meshed / "out_ckpt_mesh.npz")
    params, bf16 = _want(meshed)
    _assert_bits(out["reload"], params)
    _assert_bits(out["reload_bf16"], bf16)
    for r in range(4):
        got = load_json(meshed / f"out_ckpt_mesh_r{r}.json")
        assert got["steps"][0] == 3
        assert got["placements"] == "(Shard(dim=1),)"


def test_jax_eight_device_save_loads_on_the_port_mesh(meshed):
    out = load_tree(meshed / "out_ckpt_mesh.npz")
    params, bf16 = _want(meshed)
    _assert_bits(out["jax8"], params)
    _assert_bits(out["jax8_bf16"], bf16)
    assert all(load_json(meshed / f"out_ckpt_mesh_r{r}.json")["steps"][1]
               == 7 for r in range(4))


def test_port_mesh_save_loads_in_jax(meshed):
    params, _ = _want(meshed)
    jt = {"params": jax.tree.map(jnp.zeros_like, params), "step": 0}
    JC.load_state_dict(jt, str(meshed / "port22"))
    _assert_bits(_np(jt["params"]), params)
    assert jt["step"] == 3


def test_mesh_save_windows_are_the_references(meshed, tmp_path):
    """A JAX save of the same tree over a (2, 2) fsdp x tp mesh of 4 fake
    devices records the same windows, shapes and dtypes a key."""
    cfg = JL.llama_tiny()
    params, _ = _want(meshed)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("fsdp", "tp"))
    JC.save_state_dict({"params": jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
        JL.param_specs(cfg)), "step": 3}, str(tmp_path / "j22"))

    def entries(path):
        meta = json.loads((path / "0.metadata").read_text())["tensors"]
        return {k: ({k2: v for k2, v in e.items() if k2 != "shards"},
                    sorted(map(str, (s["window"] for s in e["shards"]))))
                for k, e in meta.items()
                if e["kind"] == "tensor" and not k.startswith("bf16.")}

    port = entries(meshed / "port22")
    assert port == entries(tmp_path / "j22")
    assert len(port["params.layers.wq"][1]) == 4          # sharded 2 x 2
    assert len(port["params.ln_f"][1]) == 1               # replicated
    assert sorted(n for n in os.listdir(meshed / "port22")
                  if n.endswith(".distcp")) == [f"{r}_0.distcp"
                                                for r in range(4)]


def test_async_manager_save_restores_through_the_agreement(meshed):
    out = load_tree(meshed / "out_ckpt_mesh.npz")
    params, _ = _want(meshed)
    _assert_bits(out["restored"], params)     # the values at the save
    for r in range(4):
        steps = load_json(meshed / f"out_ckpt_mesh_r{r}.json")["steps"]
        assert steps[2:] == [3, 5]      # the state's "step", the dir's


# -- the commit protocol ------------------------------------------------------

def test_commit_artifacts_and_manifest(tmp_path):
    path = str(tmp_path / "ck")
    TC.save_state_dict(_state(1), path)
    assert {"COMMIT", "checkpoint.manifest", "0.metadata",
            "0_0.distcp"} == set(os.listdir(path))
    with open(os.path.join(path, "checkpoint.manifest")) as f:
        manifest = json.load(f)
    assert set(manifest["files"]) == {"0.metadata", "0_0.distcp"}
    for fname, rec in manifest["files"].items():
        assert os.path.getsize(os.path.join(path, fname)) == rec["size"]
    assert TC.is_committed(path)
    TC.verify_checkpoint(path)
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


def test_chunked_writes_keep_every_crc(tmp_path, monkeypatch):
    """The writer's member and file CRC32s are combined from its chunks'
    (a chunk of 1000 bytes: many a member, and members of 0, 1 and odd
    sizes): the manifest's is zlib's over the file, zipfile's member
    check passes, and numpy and the reference read the members."""
    import zlib
    monkeypatch.setattr(TC, "_CHUNK", 1000)
    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(3001, generator=g),
             "b": torch.randn(37, 11, generator=g).to(torch.bfloat16),
             "e": torch.zeros(0, 3), "one": torch.ones(1, dtype=torch.bool),
             "ids": torch.arange(4097, dtype=torch.int32)}
    path = tmp_path / "ck"
    TC.save_state_dict(state, str(path))
    shard = path / "0_0.distcp"
    manifest = json.loads((path / "checkpoint.manifest").read_text())
    assert manifest["files"]["0_0.distcp"] == {
        "size": os.path.getsize(shard),
        "crc32": zlib.crc32(shard.read_bytes())}
    assert TC._crc32_of(str(shard)) == zlib.crc32(shard.read_bytes())
    with zipfile.ZipFile(shard) as z:
        assert z.testzip() is None
    with np.load(shard) as z:
        np.testing.assert_array_equal(z["a@0"], state["a"].numpy())
        np.testing.assert_array_equal(z["ids@0"], state["ids"].numpy())
    jt = {"a": jnp.zeros(3001), "ids": jnp.zeros(4097, jnp.int32)}
    JC.load_state_dict(jt, str(path))
    _assert_bits(_np(jt), {k: state[k].numpy() for k in ("a", "ids")})
    tmpl = TL._map(torch.zeros_like, state)
    TC.load_state_dict(tmpl, str(path))
    _assert_bits(tmpl, state)


@pytest.mark.parametrize("damage,match", [
    ("uncommitted", "COMMIT"), ("flip", "CRC32"), ("truncate", "bytes"),
    ("missing", "missing")])
def test_load_refuses_a_damaged_checkpoint(tmp_path, damage, match):
    path = str(tmp_path / "ck")
    TC.save_state_dict(_state(1), path)
    shard = os.path.join(path, "0_0.distcp")
    if damage == "uncommitted":
        os.remove(os.path.join(path, "COMMIT"))
    elif damage == "flip":
        with open(shard, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
    elif damage == "truncate":
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 7)
    else:
        os.remove(shard)
    with pytest.raises(CheckpointError, match=match) as e:
        TC.load_state_dict(_template(), path)
    assert path in str(e.value)
    if damage != "uncommitted":
        assert "0_0.distcp" in str(e.value)
    if damage in ("uncommitted", "flip"):
        tgt = _template()
        TC.load_state_dict(tgt, path, verify=False)   # legacy dirs
        if damage == "uncommitted":
            assert torch.equal(tgt["w"], W0 + 1)


@pytest.mark.parametrize("point", POINTS)
def test_raise_mid_save_preserves_previous(tmp_path, point):
    path = str(tmp_path / "ck")
    TC.save_state_dict(_state(1), path)
    faults.inject(point, "raise")
    with pytest.raises(faults.FaultInjected):
        TC.save_state_dict(_state(2), path)       # overwrite in place
    faults.clear()
    tgt = _template()
    TC.load_state_dict(tgt, path)
    assert torch.equal(tgt["w"], W0 + 1) and tgt["step"] == 1
    assert sorted(os.listdir(tmp_path)) == ["ck"]   # no debris


def test_async_writer_fault_surfaces(tmp_path):
    path = str(tmp_path / "ck")
    TC.save_state_dict(_state(1), path)
    faults.inject("checkpoint.metadata", "raise")
    h = TC.async_save_state_dict(_state(2), path)
    with pytest.raises(faults.FaultInjected):
        h.result(timeout=60)
    assert h.done()
    tgt = _template()
    TC.load_state_dict(tgt, path)
    assert tgt["step"] == 1


_CRASH_CHILD = textwrap.dedent("""\
    import sys
    import torch
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager

    root, mode = sys.argv[1], sys.argv[2]
    W0 = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mgr = CheckpointManager(root, keep_last_n=3,
                            async_save=(mode == "async"))
    mgr.save(1, {"w": W0 + 1, "step": 1}, blocking=True)
    print("SAVED1", flush=True)
    # FLAGS_fault_injection armed a kill at the point's second hit: the
    # second save
    mgr.save(2, {"w": W0 + 2, "step": 2})
    mgr.wait()
    print("SAVED2", flush=True)
""")


@pytest.mark.parametrize("mode,point", [("sync", p) for p in POINTS]
                         + [("async", "checkpoint.write")])
def test_kill_mid_save_leaves_the_previous_checkpoint(tmp_path, mode, point):
    script = tmp_path / "child.py"
    script.write_text(_CRASH_CHILD)
    root = str(tmp_path / "root")
    r = subprocess.run(
        [sys.executable, str(script), root, mode], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 FLAGS_fault_injection=f"{point}:kill:2"))
    assert r.returncode == faults.KILL_EXIT_CODE, r.stderr[-3000:]
    assert "SAVED1" in r.stdout and "SAVED2" not in r.stdout
    mgr = CheckpointManager(root)
    assert mgr.latest_step() == 1
    tgt = _template()
    assert mgr.restore_latest(tgt) == 1
    assert torch.equal(tgt["w"], W0 + 1) and tgt["step"] == 1
    partial = [n for n in os.listdir(root) if n.startswith("step_2")]
    assert len(partial) == 1, os.listdir(root)
    want = "step_2" if point == "checkpoint.commit" else "step_2.tmp."
    assert partial[0].startswith(want)
    with pytest.raises(CheckpointError, match="COMMIT") as e:
        TC.load_state_dict(_template(), os.path.join(root, partial[0]))
    assert partial[0] in str(e.value)


# -- the manager --------------------------------------------------------------

def _corrupt_newest(mgr_root, step):
    shard = os.path.join(mgr_root, f"step_{step}", "0_0.distcp")
    with open(shard, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))


def test_manager_lifecycle_matches_the_reference(tmp_path):
    """The same saves through both managers (keep 2, every 2nd step, one
    skipped save offered last), then the newest corrupted: the same
    committed steps, the same fallback, the same counters."""
    from paddle_tpu.distributed.checkpoint import CheckpointManager as JCM
    JF.set_flags({"enable_monitor": True})
    TF.set_flags({"enable_monitor": True})
    out = {}
    try:
        for side, M, Mgr, mk in (
                ("jax", JMon, JCM, lambda s: {"w": jnp.asarray(
                    np.asarray(W0) + s), "step": s}),
                ("torch", TMon, CheckpointManager, _state)):
            M.reset()
            root = str(tmp_path / side)
            mgr = Mgr(root, keep_last_n=2, save_interval_steps=2)
            saved = [mgr.save(s, mk(s)) for s in range(1, 8)]
            steps = mgr.all_steps()
            _corrupt_newest(root, steps[-1])
            tgt = {"w": (jnp.zeros((3, 4)) if side == "jax"
                         else torch.zeros(3, 4)), "step": 0}
            restored = mgr.restore_latest(tgt)
            counters = {k: v for k, v in M.snapshot()["counters"].items()
                        if k.startswith("ckpt.") and k != "ckpt.save.bytes"}
            out[side] = (saved, steps, restored, tgt["step"],
                         np.asarray(tgt["w"]).tolist(), counters,
                         sorted(os.listdir(root)))
    finally:
        JF.set_flags({"enable_monitor": False})
        TF.set_flags({"enable_monitor": False})
        JMon.reset()
        TMon.reset()
    assert out["torch"] == out["jax"]
    saved, steps, restored, step, w, counters, names = out["torch"]
    assert steps == [4, 6] and restored == step == 4
    assert counters["ckpt.restore.fallbacks"] == 1


def test_retention_and_interval(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), keep_last_n=1)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3]        # the newest is never deleted
    m5 = CheckpointManager(str(tmp_path / "i"), save_interval_steps=5)
    assert not m5.save(3, _state(3)) and m5.save(5, _state(5))
    assert m5.save(6, _state(6), force=True)
    assert m5.all_steps() == [5, 6]
    assert CheckpointManager(str(tmp_path / "fresh")).restore_latest(
        _template()) is None
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "bad"), keep_last_n=0)


def test_graveyards_are_recovered(tmp_path):
    """A kill between the overwrite's two renames strands the committed
    copy at ``step_N.old.<uid>``: a new manager renames it back, over an
    uncommitted dir at the step path."""
    root = tmp_path / "root"
    mgr = CheckpointManager(str(root))
    mgr.save(3, _state(3))
    os.rename(root / "step_3", root / "step_3.old.99.1")
    os.makedirs(root / "step_3")                       # uncommitted
    mgr2 = CheckpointManager(str(root))
    assert mgr2.all_steps() == [3]
    assert not (root / "step_3.old.99.1").exists()
    tgt = _template()
    assert mgr2.restore_latest(tgt) == 3 and torch.equal(tgt["w"], W0 + 3)
    # a raised commit failure on an overwrite puts the old copy back
    faults.inject("checkpoint.commit", "raise")
    with pytest.raises(faults.FaultInjected):
        mgr2.save(3, _state(4), force=True)
    faults.clear()
    tgt = _template()
    assert mgr2.restore_latest(tgt) == 3 and torch.equal(tgt["w"], W0 + 3)


def test_emergency_save_and_finalize(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "e"), save_interval_steps=5)
    assert mgr.save(5, _state(5))
    assert not mgr.save(7, _state(7))            # interval-skipped
    mgr.finalize_on_preemption()
    assert mgr.latest_step() == 7                # emergency sync save
    tgt = _template()
    assert mgr.restore_latest(tgt) == 7 and torch.equal(tgt["w"], W0 + 7)
    am = CheckpointManager(str(tmp_path / "a"), async_save=True)
    faults.inject("checkpoint.rename", "delay", delay_s=0.2)
    am.save(1, _state(1))
    am.finalize_on_preemption()                  # joins the writer
    assert am.latest_step() == 1


_SIGTERM_CHILD = textwrap.dedent("""\
    import os, signal, sys
    import torch
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.testing import faults

    root = sys.argv[1]
    W0 = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mgr = CheckpointManager(root, keep_last_n=3, async_save=True,
                            save_interval_steps=2)
    assert mgr.install_preemption_hook()
    # the writer is still in flight when SIGTERM lands
    faults.inject("checkpoint.rename", action="delay", delay_s=0.5)
    assert mgr.save(2, {"w": W0 + 2, "step": 2})
    assert not mgr.save(3, {"w": W0 + 3, "step": 3})   # interval-skipped
    os.kill(os.getpid(), signal.SIGTERM)
    print("UNREACHABLE", flush=True)
""")


def test_sigterm_finalizes_and_takes_the_emergency_save(tmp_path):
    """The SIGTERM hook joins the save in flight (step 2), then takes an
    emergency save of the newer interval-skipped state (step 3), then
    re-delivers the signal."""
    script = tmp_path / "child.py"
    script.write_text(_SIGTERM_CHILD)
    root = str(tmp_path / "root")
    r = subprocess.run([sys.executable, str(script), root],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO,
                                OMP_NUM_THREADS="1"))
    assert r.returncode == -signal.SIGTERM, (r.returncode, r.stderr[-3000:])
    assert "UNREACHABLE" not in r.stdout
    mgr = CheckpointManager(root)
    assert mgr.all_steps() == [2, 3]
    tgt = _template()
    assert mgr.restore_latest(tgt) == 3 and torch.equal(tgt["w"], W0 + 3)


def test_save_bills_the_checkpoint_phase_and_counts(tmp_path):
    TF.set_flags({"enable_monitor": True})
    TMon.reset()
    try:
        mgr = CheckpointManager(str(tmp_path / "m"))
        st = TMon.StepTimer("loop")
        faults.inject("checkpoint.rename", "delay", delay_s=0.05)
        with st:
            mgr.save(1, _state(1))
        report = st.report()
        snap = TMon.snapshot()
    finally:
        TF.set_flags({"enable_monitor": False})
        TMon.reset()
    assert report["checkpoint_s"] >= 0.05
    assert snap["histograms"]["train.step.checkpoint_ms"]["count"] == 1
    assert snap["counters"]["ckpt.saves"] == 1
    assert snap["counters"]["ckpt.save.bytes"] == os.path.getsize(
        tmp_path / "m" / "step_1" / "0_0.distcp")
    assert snap["histograms"]["ckpt.save.duration_ms"]["count"] == 1


def test_async_save_then_in_place_step_loads_the_values_at_the_save(
        tmp_path, monkeypatch):
    """The port's train step updates parameters and moments in place: an
    async save's snapshot must be taken before it returns. The writer is
    held at its first write until a step has run."""
    import threading
    cfg = TL.llama_tiny()
    params = TL.init_params(cfg, seed=0, device="cpu")
    opt = TL.adamw_init(params)
    step = TL.make_train_step(cfg)
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)))
    step(params, opt, batch)
    state = {"params": params, "opt": opt, "step": 1}
    want = TL._map(lambda t: t.clone(), {"params": params, "m": opt["m"]})
    gate = threading.Event()
    write = TC._write_local_shards

    def held(*args, **kw):
        assert gate.wait(60)
        return write(*args, **kw)

    monkeypatch.setattr(TC, "_write_local_shards", held)
    h = TC.async_save_state_dict(state, str(tmp_path / "a"))
    step(params, opt, batch)                     # in place, while writing
    assert not h.done()
    gate.set()
    h.result(timeout=60)
    tmpl = {"params": _zeros_torch(params),
            "opt": {"step": 0, "m": _zeros_torch(opt["m"]),
                    "v": _zeros_torch(opt["v"])}, "step": 0}
    TC.load_state_dict(tmpl, str(tmp_path / "a"))
    _assert_bits(tmpl["params"], want["params"])
    _assert_bits(tmpl["opt"]["m"], want["m"])
    assert tmpl["opt"]["step"] == 1 and opt["step"] == 2
    assert not torch.equal(tmpl["params"]["embed"], params["embed"])

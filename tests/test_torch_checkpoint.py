"""The port's checkpointing (repro_torch.ckpt) against the JAX package's
(repro.ckpt): CheckpointManager's atomic and async saves, keep-GC,
uncommitted directories, missing and optional leaves, the flattened npz
keys (equal to `jax.tree_util.tree_flatten_with_path`'s on a packed tree),
step directories restored across the two packages both ways, and the
packed single-file format's torn-write window and header checks."""
import json
import os
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.ckpt import pack_tree as jax_pack_tree
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.core.pipeline import make_qtensor as jax_make_qtensor
from repro_torch.ckpt import (CheckpointManager, PackedCkptError,
                              flatten_with_paths, load_packed_ckpt,
                              pack_tree, save_packed_ckpt, tree_bytes,
                              unpack_tree)
from repro_torch.core.pipeline import make_qtensor

torch.set_num_threads(2)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def _assert_same(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, k
            assert torch.equal(x, y), k
        else:
            assert type(x) is type(y) and np.array_equal(x, y), k


def _packed_table(bits=(4, 8, 2)):
    """A small "__qlayers__"-like table: QTensors at several widths, a
    float leaf, an expert stack's broadcast scales; packed."""
    rs = np.random.RandomState(0)
    out = {}
    for i, b in enumerate(bits):
        lo = -(2 ** (b - 1))
        q = torch.from_numpy(rs.randint(lo, -lo, (16, 32)))
        out[str(i)] = {
            "attn": {"wq": make_qtensor(q, torch.full((32,), 0.1),
                                        torch.full((32,), lo,
                                                   dtype=torch.int32),
                                        (16, 4, 8), bits=b)},
            "attn_norm": torch.from_numpy(rs.randn(16).astype(np.float32))}
    qe = torch.from_numpy(rs.randint(-8, 8, (3, 16, 8)))
    out["moe"] = {"w_up": make_qtensor(qe, torch.full((3, 1, 8), 0.2),
                                       torch.full((3, 1, 8), -8,
                                                  dtype=torch.int32),
                                       (3, 16, 8), bits=4)}
    return pack_tree(out)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    return tree


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(5, t, extra={"foo": 1})
    like = {"a": torch.zeros(8, 16), "nested": {
        "b": torch.zeros(10, dtype=torch.int32), "c": torch.tensor(0.0)}}
    out, meta = mgr.restore(None, like)
    assert meta["step"] == 5 and meta["extra"]["foo"] == 1
    _assert_same(t, out)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, blocking=False)
    mgr.wait()
    assert mgr.steps() == [3, 4]


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken before save() returns: a tensor changed
    while the write runs does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    mgr.save(1, t, blocking=False)
    t["a"].add_(1.0)
    mgr.wait()
    out, _ = mgr.restore(1, _tree(1))
    assert torch.equal(out["a"], want)


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_2")
    (tmp_path / "step_2" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_3.tmp")
    assert mgr.latest_step() == 1


def test_restore_places_tensors_on_the_device(tmp_path):
    """restore(device=) replaces JAX's re-shard argument: every tensor
    leaf lands on the given device, Python scalars keep their type."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(3), "n": 7, "flag": True, "s": (2, 3)}
    mgr.save(1, t)
    out, _ = mgr.restore(1, t, device="cpu")
    assert out["w"].device.type == "cpu"
    assert out["n"] == 7 and type(out["n"]) is int
    assert out["flag"] is True and out["s"] == (2, 3)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, t)


def test_elastic_restore_resharding(tmp_path):
    """restore(shardings=) on the smoke mesh (a world of one), JAX's
    tests/test_checkpoint.py::test_elastic_restore_resharding: every leaf
    comes back a DTensor on the mesh whose full tensor is the saved one,
    for a replicated spec and one split over the (size-one) data axis."""
    from torch.distributed.tensor import DTensor
    from repro_torch import dist as rd
    from repro_torch.dist.sharding import P, NamedSharding
    from repro_torch.launch.mesh import make_smoke_mesh
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    mesh = make_smoke_mesh("cpu")
    try:
        sh = {"a": NamedSharding(mesh, P("data", None)),
              "nested": {"b": NamedSharding(mesh, P()),
                         "c": NamedSharding(mesh, P())}}
        out, _ = mgr.restore(1, t, shardings=sh)
        for got, want in zip(flatten_with_paths(out).values(),
                             flatten_with_paths(t).values()):
            assert isinstance(got, DTensor)
            assert torch.equal(got.full_tensor(), want)
            assert torch.equal(got.to_local(), want)
        assert str(out["a"].placements[0]) == "S(0)"
    finally:
        rd.close_world(True)


def test_elastic_restore_shards_over_a_gloo_world_of_two(tmp_path):
    """In a gloo world of 2 on the CPU a leaf sharded over "data" gives
    each rank its slice of rows; a replicated leaf is whole on both."""
    from torch_dist_worker import spawn
    from repro_torch.dist.sharding import P
    t = _tree()
    CheckpointManager(str(tmp_path / "ck")).save(1, {"a": t["a"],
                                                     "b": t["nested"]["b"]})
    outs = spawn("restore", {"dir": str(tmp_path / "ck"),
                             "shapes": {"a": (8, 16), "b": (10,)},
                             "specs": {"a": P("data", None), "b": P()}},
                 2, tmp_path / "w")
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["local"]["a"],
                                      t["a"][4 * r:4 * (r + 1)].numpy())
        np.testing.assert_array_equal(o["full"]["a"], t["a"].numpy())
        np.testing.assert_array_equal(o["local"]["b"], t["nested"]["b"])
        assert o["placements"] == {"a": ["S(0)"], "b": ["R"]}


def test_missing_leaf_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        mgr.restore(1, {"a": torch.zeros(3), "b": torch.zeros(4)})


def test_optional_leaf_backfilled_with_warning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    like = {"a": torch.ones(3), "opt": {"ef": torch.full((2,), 5.0)}}
    with pytest.warns(UserWarning, match="backfilling"):
        out, _ = mgr.restore(1, like)
    assert torch.equal(out["a"], torch.zeros(3))
    assert torch.equal(out["opt"]["ef"], torch.full((2,), 5.0))


# ---------------------------------------------------------------------------
# keys and step directories across the two packages
# ---------------------------------------------------------------------------

def test_flattened_keys_equal_jax_on_a_packed_tree():
    """The port's flattener gives JAX's keys, in JAX's order, on the same
    packed tree built by each package from the same codes."""
    rs = np.random.RandomState(1)
    trees = []
    for mk, pk, conv in ((make_qtensor, pack_tree, torch.from_numpy),
                         (jax_make_qtensor, jax_pack_tree, jnp.asarray)):
        t = {}
        for i, b in enumerate((4, 8, 2)):
            lo = -(2 ** (b - 1))
            q = rs.randint(lo, -lo, (16, 32))
            t[str(i)] = {"attn": {
                "wq": mk(conv(q), conv(np.full((32,), 0.1, np.float32)),
                         conv(np.full((32,), lo, np.int32)), (16, 4, 8),
                         bits=b)},
                "attn_norm": conv(np.ones(16, np.float32))}
        trees.append(pk(t))
    ours = flatten_with_paths(trees[0])
    theirs = jax_flatten(trees[1])
    assert list(ours) == list(theirs)
    assert "0/attn/wq/shape/[2]" in ours and "0/attn/wq/packed_cpb" in ours
    for k in ours:
        a = ours[k]
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.asarray(theirs[k]).shape == a.shape, k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_step_dir_restores_across_packages(tmp_path, writer):
    """A step_0 written by either package's CheckpointManager restores in
    the other's with a `like` of the same tree, to the same arrays."""
    table = _packed_table()
    extra = {"arch": "qwen2-7b-smoke", "bits": 4}
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(0, table, extra=extra)
        out, meta = JCheckpointManager(str(tmp_path)).restore(
            0, _to_jax(table))
        theirs = jax_flatten(out)
        for k, v in flatten_with_paths(table).items():
            want = v.numpy() if isinstance(v, torch.Tensor) else np.array(v)
            got = np.asarray(theirs[k])
            assert got.dtype == want.dtype and np.array_equal(got, want), k
    else:
        JCheckpointManager(str(tmp_path)).save(0, _to_jax(table),
                                               extra=extra)
        out, meta = CheckpointManager(str(tmp_path)).restore(0, table)
        _assert_same(table, out)
        assert unpack_tree(out)["0"]["attn"]["wq"]["codes"].shape == (16, 32)
    assert meta["step"] == 0 and meta["extra"] == extra
    names = sorted(os.listdir(tmp_path / "step_0"))
    assert names == ["_COMMITTED", "arrays.npz", "treedef.json"]


# ---------------------------------------------------------------------------
# the packed single-file format (tests/test_serve_faults.py, header tests)
# ---------------------------------------------------------------------------

def test_quantized_pack_roundtrip():
    q = torch.from_numpy(np.random.RandomState(0).randint(-8, 8, (32, 64)))
    qt = make_qtensor(q, torch.full((64,), 0.1),
                      torch.full((64,), -8, dtype=torch.int32), (32, 64),
                      bits=4)
    packed = pack_tree({"w": qt})
    assert packed["w"].get("packed4") and packed["w"]["packed_cpb"] == 2
    assert tree_bytes(packed) < tree_bytes({"w": qt})
    assert torch.equal(unpack_tree(packed)["w"]["codes"], qt["codes"])


def test_ckpt_write_fault_leaves_the_old_file_or_none(tmp_path):
    """fault_cb runs after the tmp file is durable and before the rename:
    a fault there leaves the tmp file and no target (or the old target)."""
    path = str(tmp_path / "leaf.qt")

    def boom():
        raise RuntimeError("torn write")

    with pytest.raises(RuntimeError, match="torn"):
        save_packed_ckpt(path, {"w": np.zeros(4)}, fault_cb=boom)
    assert os.path.exists(path + ".tmp") and not os.path.exists(path)
    crc = save_packed_ckpt(path, {"w": np.ones(4)}, layer=0)
    with pytest.raises(RuntimeError):
        save_packed_ckpt(path, {"w": np.full(4, 2.0)}, fault_cb=boom)
    blob = load_packed_ckpt(path, expect_crc=crc)
    np.testing.assert_array_equal(blob["tree"]["w"], np.ones(4))
    with pytest.raises(PackedCkptError, match="does not match"):
        load_packed_ckpt(path, expect_crc=crc ^ 1)


def test_packed_ckpt_truncation_and_checksum_fail_clearly(tmp_path):
    path = str(tmp_path / "q.pkl")
    save_packed_ckpt(path, {"w": np.zeros(64, np.uint8)}, bits=4)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(PackedCkptError, match="truncated|corrupt"):
        load_packed_ckpt(path)
    flipped = bytearray(data)
    flipped[-20] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(flipped))
    with pytest.raises(PackedCkptError,
                       match="checksum mismatch|truncated or corrupt"):
        load_packed_ckpt(path)


def test_packed_ckpt_wrong_format_and_version(tmp_path):
    path = str(tmp_path / "q.pkl")
    payload = pickle.dumps({"tree": {}})
    with open(path, "wb") as f:
        pickle.dump({"format": "other", "version": 1,
                     "crc32": zlib.crc32(payload), "payload": payload}, f)
    with pytest.raises(PackedCkptError, match="format"):
        load_packed_ckpt(path)
    with open(path, "wb") as f:
        pickle.dump({"format": "comq-packed-qt", "version": 99,
                     "crc32": zlib.crc32(payload), "payload": payload}, f)
    with pytest.raises(PackedCkptError, match="newer"):
        load_packed_ckpt(path)


def test_treedef_json_is_the_jax_layout(tmp_path):
    CheckpointManager(str(tmp_path)).save(3, {"x": torch.zeros(1)},
                                          extra={"k": [1, 2]})
    with open(tmp_path / "step_3" / "treedef.json") as f:
        meta = json.load(f)
    assert set(meta) == {"step", "extra", "time"} and meta["step"] == 3
    assert meta["extra"] == {"k": [1, 2]}
    assert list(np.load(tmp_path / "step_3" / "arrays.npz").files) == ["x"]

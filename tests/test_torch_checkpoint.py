"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``)
against the reference's (``repro/checkpoint/manager.py``): round trips of
nested dicts and lists (bf16, f32, int32, int64), keep-k pruning, the
cleanup of ``.tmp-*`` directories, the readable errors, the same ``/``-joined
keys, and trees crossing the two packages in both directions bit for bit
(bf16 as the reference's 2-byte void arrays, uint32 bitmap words against
the port's int32 bit-views)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.checkpoint.manager import _flatten as jax_flatten

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.serving import corrupt_snapshot

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "arena": {"l0": {"k_bitmap": torch.randint(
                              -2 ** 31, 2 ** 31 - 1, (2, 3, 4),
                              generator=g, dtype=torch.int64)
                              .to(torch.int32),
                          "k_values": torch.randn(2, 3, 8, generator=g)
                              .to(torch.bfloat16)},
                  "l1": {"v_values": torch.randn(5, generator=g)}},
        "hashes": np.array([2 ** 62 + 7, -(2 ** 61) - 3], np.int64),
        "ids": np.array([3, 1], np.int32),
        "steps": [torch.arange(4, dtype=torch.int64), torch.ones(2)],
    }


def _like(tree):
    """A template of meta tensors (and the numpy leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v) for v in tree]
    if torch.is_tensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return np.zeros_like(tree)


def _same(a, b):
    """Bit-equal trees of tensors and arrays of the same dtypes."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype
        assert a.shape == b.shape and b.device.type == "cpu"
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)
    else:
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("blocking", [True, False])
def test_roundtrip_nested_dtypes(tmp_path, blocking):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(5, tree, meta={"kind": "test"}, blocking=blocking)
    # the host copy is taken before save returns: an in-place change of
    # the caller's tensors afterwards is not in the checkpoint
    kept = {k: v.clone() for k, v in tree["arena"]["l0"].items()}
    tree["arena"]["l0"]["k_values"].zero_()
    mgr.wait()
    assert mgr.steps() == [5] and mgr.latest_step() == 5
    got, man = mgr.restore(5, _like(_tree()), to_device=False)
    want = _tree()
    want["arena"]["l0"].update(kept)
    _same(want, got)
    assert man["step"] == 5 and man["kind"] == "test"
    assert man["n_arrays"] == 7
    assert mgr.read_manifest(5) == man


def test_restore_places_tensors_on_the_template_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(3), "h": np.arange(3)}, blocking=True)
    got, _ = mgr.restore(1, {"a": torch.zeros(3), "h": np.zeros(3, int)})
    assert got["a"].device.type == "cpu" and isinstance(got["h"],
                                                        np.ndarray)
    got, _ = mgr.restore(1, {"a": torch.zeros(3), "h": np.zeros(3, int)},
                         device="cpu")
    assert torch.equal(got["a"], torch.ones(3))


def test_keys_match_the_reference():
    tree = _tree()
    jtree = {"arena": {"l0": {"k_bitmap": np.zeros((2, 3, 4), np.uint32),
                              "k_values": jnp.zeros((2, 3, 8), jnp.bfloat16)},
                       "l1": {"v_values": np.zeros(5, np.float32)}},
             "hashes": tree["hashes"], "ids": tree["ids"],
             "steps": [np.zeros(4, np.int64), np.zeros(2, np.float32)]}
    assert sorted(_flatten(tree)) == sorted(jax_flatten(jtree))
    assert "arena/l0/k_bitmap" in _flatten(tree)
    assert "steps/1" in _flatten(tree)


def test_keep_k_pruning_and_tmp_cleanup(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp-9"))       # a crash mid-save
    mgr = CheckpointManager(d, keep=2)
    assert not os.path.exists(os.path.join(d, ".tmp-9"))
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    got, _ = mgr.restore(4, {"x": torch.zeros(2)}, to_device=False)
    assert got["x"].tolist() == [4.0, 4.0]


def test_readable_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    like = {"x": torch.zeros(3), "y": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not found"):
        mgr.restore(1, like)
    mgr.save(1, {"x": torch.ones(3)}, blocking=True)
    with pytest.raises(ValueError, match="missing array 'y'"):
        mgr.restore(1, like)
    with pytest.raises(ValueError, match="geometry mismatch at 'x'"):
        mgr.restore(1, {"x": torch.zeros(4)})
    man = os.path.join(str(tmp_path), "step_0000000001", "manifest.json")
    with open(man, "w") as f:
        f.write("{trunc")
    with pytest.raises(ValueError, match="corrupt"):
        mgr.read_manifest(1)
    os.remove(man)
    with pytest.raises(ValueError, match="no manifest"):
        mgr.read_manifest(1)
    mgr.save(2, {"x": torch.ones(3)}, blocking=True)
    corrupt_snapshot(str(tmp_path), mode="truncate")
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(2, {"x": torch.zeros(3)})


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A tree saved by the reference's manager (ml_dtypes bf16, uint32
    bitmap words, int64 hashes) restores bit-exact through the port's."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (2, 3, 4), dtype=np.uint64) \
        .astype(np.uint32)
    vals = rng.normal(size=(2, 3, 8)).astype(np.float32)
    jtree = {"arena": {"l0": {"k_bitmap": words,
                              "k_values": jnp.asarray(vals, jnp.bfloat16)}},
             "hashes": np.array([2 ** 62 + 1, -5], np.int64),
             "ids": np.array([0, 7], np.int32)}
    JaxManager(str(tmp_path)).save(1, jtree, meta={"kind": "x"},
                                   blocking=True)
    like = {"arena": {"l0": {"k_bitmap": torch.empty(
                2, 3, 4, dtype=torch.int32, device="meta"),
                             "k_values": torch.empty(
                2, 3, 8, dtype=torch.bfloat16, device="meta")}},
            "hashes": np.zeros(2, np.int64), "ids": np.zeros(2, np.int32)}
    got, man = CheckpointManager(str(tmp_path)).restore(1, like,
                                                        to_device=False)
    assert man["kind"] == "x"
    bm = got["arena"]["l0"]["k_bitmap"]
    assert bm.dtype == torch.int32
    np.testing.assert_array_equal(bm.numpy().view(np.uint32), words)
    kv = got["arena"]["l0"]["k_values"]
    assert kv.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        kv.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jtree["arena"]["l0"]["k_values"]).view(np.uint16))
    np.testing.assert_array_equal(got["hashes"], jtree["hashes"])
    np.testing.assert_array_equal(got["ids"], jtree["ids"])


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The reverse: the port's bf16 (written as 2-byte void) and int32
    bit-view bitmaps restore bit-exact through the reference's manager
    into its bf16 and uint32 template."""
    tree = _tree(3)
    CheckpointManager(str(tmp_path)).save(2, tree, blocking=True)
    l0 = tree["arena"]["l0"]
    like = {"arena": {"l0": {"k_bitmap": np.zeros((2, 3, 4), np.uint32),
                             "k_values": jnp.zeros((2, 3, 8), jnp.bfloat16)},
                      "l1": {"v_values": np.zeros(5, np.float32)}},
            "hashes": np.zeros(2, np.int64), "ids": np.zeros(2, np.int32),
            "steps": [np.zeros(4, np.int64), np.zeros(2, np.float32)]}
    got, _ = JaxManager(str(tmp_path)).restore(2, like, to_device=False)
    bm = got["arena"]["l0"]["k_bitmap"]
    assert bm.dtype == np.uint32
    np.testing.assert_array_equal(bm.view(np.int32), l0["k_bitmap"].numpy())
    kv = got["arena"]["l0"]["k_values"]
    assert kv.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        kv.view(np.uint16), l0["k_values"].view(torch.int16).numpy()
        .view(np.uint16))
    np.testing.assert_array_equal(got["arena"]["l1"]["v_values"],
                                  tree["arena"]["l1"]["v_values"].numpy())
    np.testing.assert_array_equal(got["hashes"], tree["hashes"])
    with open(os.path.join(str(tmp_path), "step_0000000002",
                           "manifest.json")) as f:
        assert json.load(f)["n_arrays"] == 7

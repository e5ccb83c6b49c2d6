"""The port's checkpoint manager: atomicity, integrity checksums, keep-k
pruning, AsyncWriter error surfacing, bf16 round trip and restore
validation, as ``tests/test_checkpoint_manager.py`` holds the reference's;
and the on-disk layout, which each package must read from the other.

Crash and torn-write cases go through the ``"checkpoint-write"`` fault
site, between the payload write and the manifest/rename commit point.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import faults


def _tree(step):
    rng = np.random.default_rng(step)
    return {"phi": rng.integers(0, 9, 50).astype(np.int64),
            "alive": rng.random(50) < 0.5}


# ----------------------------------------------------------------- atomicity

def test_crash_mid_write_leaves_previous_snapshot_intact(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1), metadata={"stage": "lb"})
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.CHECKPOINT_WRITE, kind="crash")])
    with faults.active(plan):
        with pytest.raises(OSError, match="injected crash"):
            ckpt.save(d, 2, _tree(2))
    assert ckpt.all_steps(d) == [1]
    assert os.path.isdir(os.path.join(d, "step_0000000002.tmp"))
    tree, meta = ckpt.restore(d)
    assert meta == {"stage": "lb"}
    np.testing.assert_array_equal(tree["phi"], _tree(1)["phi"])
    # a later save of the same step clears the stale .tmp and commits
    ckpt.save(d, 2, _tree(2))
    assert ckpt.all_steps(d) == [1, 2]
    assert not os.path.exists(os.path.join(d, "step_0000000002.tmp"))


def test_truncated_payload_detected_and_fallback(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1), metadata={"idx": 1})
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.CHECKPOINT_WRITE, kind="truncate")])
    with faults.active(plan):
        ckpt.save(d, 2, _tree(2), metadata={"idx": 2})  # commits corrupted
    assert ckpt.all_steps(d) == [1, 2]
    with pytest.warns(UserWarning, match="skipping corrupt"):
        tree, meta = ckpt.restore(d)
    assert meta == {"idx": 1}                 # fell back to step 1
    with pytest.raises(ckpt.CheckpointCorruptionError, match="sha256"):
        ckpt.restore(d, step=2)


def test_all_snapshots_corrupt_raises_corruption_error(tmp_path):
    d = str(tmp_path)
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.CHECKPOINT_WRITE, kind="truncate", times=3)])
    with faults.active(plan):
        for s in (1, 2, 3):
            ckpt.save(d, s, _tree(s))
    with pytest.warns(UserWarning), \
            pytest.raises(ckpt.CheckpointCorruptionError, match="no intact"):
        ckpt.restore(d)


def test_missing_dir_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"))


def test_atomic_file_write_replaces_whole_file(tmp_path):
    path = str(tmp_path / "f.bin")
    ckpt.atomic_file_write(path, b"first")
    ckpt.atomic_file_write(path, b"second")
    with open(path, "rb") as f:
        assert f.read() == b"second"
    assert not os.path.exists(path + ".tmp")


# ------------------------------------------------------------ keep-k pruning

def test_keep_k_prunes_oldest(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(d, s, _tree(s), keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    tree, _ = ckpt.restore(d)
    np.testing.assert_array_equal(tree["phi"], _tree(5)["phi"])


def test_keep_nonpositive_keeps_everything(tmp_path):
    d = str(tmp_path)
    for s in range(1, 4):
        ckpt.save(d, s, _tree(s), keep=0)
    assert ckpt.all_steps(d) == [1, 2, 3]


# ------------------------------------------------------ AsyncWriter surfacing

def test_async_writer_surfaces_worker_error_on_next_wait(tmp_path):
    d = str(tmp_path)
    w = ckpt.AsyncWriter(d)
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.CHECKPOINT_WRITE, kind="crash")])
    with faults.active(plan):
        w.save(1, _tree(1))           # worker thread hits the injected crash
        with pytest.raises(OSError, match="injected crash"):
            w.wait()
    w.wait()                          # cleared after surfacing
    tree = {"phi": torch.arange(6), "alive": np.ones(6, bool)}
    w.save(2, tree)
    tree["phi"].zero_()               # the writer holds its own copy
    w.wait()
    assert ckpt.all_steps(d) == [2]
    got, _ = ckpt.restore(d)
    np.testing.assert_array_equal(got["phi"], np.arange(6))


# ------------------------------------------------------------ dtype roundtrip

def test_bf16_roundtrip(tmp_path):
    d = str(tmp_path)
    arr = torch.arange(16, dtype=torch.float32).to(torch.bfloat16)
    ckpt.save(d, 1, {"w": arr})
    tree, _ = ckpt.restore(d, {"w": torch.zeros(16, dtype=torch.bfloat16)})
    assert tree["w"].dtype == torch.bfloat16
    assert torch.equal(tree["w"], arr)


def test_tensor_leaves_go_to_the_host(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"sup": torch.arange(5, dtype=torch.int32),
                     "opt": {"mu": [torch.ones(2), np.zeros(3)]}})
    tree, _ = ckpt.restore(d)
    assert set(tree) == {"sup", "opt/mu/0", "opt/mu/1"}
    assert isinstance(tree["sup"], np.ndarray)
    np.testing.assert_array_equal(tree["sup"], np.arange(5))
    like = {"sup": torch.zeros(5, dtype=torch.int64),
            "opt": {"mu": [torch.zeros(2), np.zeros(3, np.float32)]}}
    back, _ = ckpt.restore(d, like)
    assert back["sup"].dtype == torch.int64
    assert back["opt"]["mu"][1].dtype == np.float32


def test_like_none_returns_plain_named_tree(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"sup": np.arange(4), "nested": {"lb": np.ones(2)}})
    tree, _ = ckpt.restore(d)
    assert set(tree) == {"sup", "nested/lb"}


# ------------------------------------------------ restore shape validation

def test_restore_wrong_leaf_count_raises_structure_error(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    with pytest.raises(ckpt.CheckpointStructureError, match="leaves"):
        ckpt.restore(d, {"phi": np.zeros(50)})


def test_restore_wrong_shape_raises_structure_error(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    like = {"phi": np.zeros(49, np.int64), "alive": np.zeros(50, bool)}
    with pytest.raises(ckpt.CheckpointStructureError, match="shape"):
        ckpt.restore(d, like)


def test_structure_error_is_not_swallowed_by_fallback(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    ckpt.save(d, 2, _tree(2))
    with pytest.raises(ckpt.CheckpointStructureError):
        ckpt.restore(d, {"phi": np.zeros(50)})
    assert issubclass(ckpt.CheckpointStructureError, ckpt.CheckpointError)
    assert issubclass(ckpt.CheckpointCorruptionError, ckpt.CheckpointError)


# ------------------------------------------------ the layout, across packages

def _nested():
    rng = np.random.default_rng(7)
    return {"sup": rng.integers(0, 99, 20).astype(np.int32),
            "alive": rng.random(20) < 0.5,
            "opt": {"mu": [np.arange(3, dtype=np.float32),
                           np.ones((2, 2), np.int64)]}}


def test_port_snapshot_restored_by_reference(tmp_path):
    d = str(tmp_path)
    tree = _nested()
    ckpt.save(d, 4, tree, metadata={"stage": "sup", "index": 3})
    got, meta = jckpt.restore(d)
    assert meta == {"stage": "sup", "index": 3}
    assert set(got) == {"sup", "alive", "opt/mu/0", "opt/mu/1"}
    np.testing.assert_array_equal(got["sup"], tree["sup"])
    np.testing.assert_array_equal(got["opt/mu/1"], tree["opt"]["mu"][1])
    # with a like tree: the reference's leaf order is the port's
    like = {"sup": np.zeros(20, np.int32), "alive": np.zeros(20, bool),
            "opt": {"mu": [np.zeros(3, np.float32),
                           np.zeros((2, 2), np.int64)]}}
    back, _ = jckpt.restore(d, like)
    np.testing.assert_array_equal(back["alive"], tree["alive"])
    np.testing.assert_array_equal(back["opt"]["mu"][0], tree["opt"]["mu"][0])


def test_reference_snapshot_restored_by_port(tmp_path):
    d = str(tmp_path)
    tree = _nested()
    tree["w"] = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jckpt.save(d, 2, tree, metadata={"stage": "lb"})
    got, meta = ckpt.restore(d)
    assert meta == {"stage": "lb"}
    np.testing.assert_array_equal(got["sup"], tree["sup"])
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(4.0))


def test_manifests_equal_across_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tree = _nested()
    ckpt.save(a, 1, tree, metadata={"x": 1})
    jckpt.save(b, 1, tree, metadata={"x": 1})
    with open(os.path.join(a, "step_0000000001", "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(b, "step_0000000001", "manifest.json")) as f:
        mb = json.load(f)
    # the zip entries carry their write time, so the payload digests may
    # differ; every other key must not
    assert set(ma) == set(mb)
    ma.pop("arrays_sha256"), mb.pop("arrays_sha256")
    assert ma == mb                  # step, paths, dtypes, shapes, metadata

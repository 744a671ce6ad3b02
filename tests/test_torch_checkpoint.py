"""The port's checkpoint store (``repro_torch.checkpoint.store``): the JAX
package's layout (``step_<N>/`` with ``meta.json``, the shard and
``COMMIT`` written last, an atomic rename), keep-k, one asynchronous save
in flight with its error raised at ``wait()``, and restores bit for bit
(bf16 included) into the structure and onto the device asked for."""
import json

import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as S
from repro_torch.tree import flatten


def _tree():
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.arange(10, dtype=torch.float32),
              "b": {"c": torch.randn((3, 4), generator=g).bfloat16(),
                    "d": torch.tensor([-0.0, float("inf"), 1e-40],
                                      dtype=torch.float32)}}
    opt = {"m": {"a": torch.zeros(10), "b": {"c": torch.ones((3, 4)),
                                             "d": torch.zeros(3)}},
           "step": torch.tensor(7, dtype=torch.int32)}
    return params, opt


@pytest.mark.parametrize("async_save", [True, False])
def test_roundtrip_bit_for_bit(tmp_path, async_save):
    tree = _tree()
    store = S.CheckpointStore(tmp_path, keep=2, async_save=async_save)
    store.save(7, tree)
    store.wait()
    assert sorted(p.name for p in (tmp_path / "step_7").iterdir()) \
        == ["COMMIT", "meta.json", S.SHARD]
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    assert meta["step"] == 7 and meta["n_leaves"] == len(flatten(tree))
    like = tuple({k: v for k, v in t.items()} for t in tree)
    (params, opt), step = store.restore(like, device="cpu")
    assert step == 7
    for a, b in zip(flatten((params, opt)), flatten(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 7


def test_keep_k_and_uncommitted_ignored(tmp_path):
    store = S.CheckpointStore(tmp_path, keep=2, async_save=False)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        store.save(s, {"x": tree["x"] + s})
    assert store.steps() == [3, 4]
    bad = tmp_path / "step_99"          # a partial checkpoint: no COMMIT
    bad.mkdir()
    (bad / "meta.json").write_text("{}")
    (tmp_path / "step_x").mkdir()
    (tmp_path / "step_x" / "COMMIT").write_text("ok")
    assert store.latest_step() == 4
    restored, step = store.restore(tree)
    assert step == 4 and torch.equal(restored["x"], torch.full((4,), 4.0))
    restored, step = store.restore(tree, step=3)
    assert torch.equal(restored["x"], torch.full((4,), 3.0))
    # the JAX package's store reads the same layout's commits
    assert jstore.CheckpointStore(tmp_path).steps() == [3, 4]


def test_async_error_raised_at_wait(tmp_path, monkeypatch):
    store = S.CheckpointStore(tmp_path, keep=2)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(S.torch, "save", fail)
    store.save(1, {"x": torch.zeros(2)})        # returns; the thread fails
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.wait()                                 # raised once
    assert store.steps() == []
    with pytest.raises(OSError, match="disk full"):
        store.save(2, {"x": torch.zeros(2)}, block=True)
    monkeypatch.undo()
    store.save(3, {"x": torch.ones(2)})
    store.save(4, {"x": torch.ones(2)})          # waits for step 3's save
    store.wait()
    assert store.steps() == [3, 4]


def test_restore_errors(tmp_path):
    store = S.CheckpointStore(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.restore({"x": torch.zeros(1)})
    store.save(1, {"x": torch.zeros(1), "y": torch.zeros(1)}, block=True)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore({"x": torch.zeros(1)})

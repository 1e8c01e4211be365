"""The port's checkpoints and snapshot resume, on the CPU.

A snapshot holds the model's and the optimizer's state (Adam's moments and
step count) with the step and the progress marker, so a Trainer built on
it continues the uninterrupted run: the resumed epoch losses and the final
parameters must equal the uninterrupted ones exactly (the same float32
arithmetic on the same values). Integrity: a corrupt latest snapshot falls
back to ``.prev`` and is quarantined; a torn file is rejected.
"""

import os

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.checkpoint import (
    SnapshotIntegrityError,
    load_checkpoint,
    load_snapshot,
    load_snapshot_with_fallback,
    quarantine,
    save_checkpoint,
    save_snapshot,
)
from distributed_pytorch_tpu_torch.models.transformer import TransformerLM, init_random_
from distributed_pytorch_tpu_torch.training import (
    Trainer,
    create_train_state,
    make_train_step,
    softmax_cross_entropy_loss,
)
from distributed_pytorch_tpu_torch.utils.data import ArrayDataset, ShardedLoader

CFG = dict(vocab_size=48, d_model=32, n_layers=2, n_heads=4, d_ff=64, n_kv_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tokens(seed, n, t=10):
    toks = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n, t + 1))
    return toks[:, :-1], toks[:, 1:]


def model(seed=0):
    return init_random_(TransformerLM(**CFG, param_dtype=torch.float32), seed)


class Capture:
    def __init__(self):
        self.epoch_losses = []

    def log(self, step, **scalars):
        if "epoch_loss" in scalars:
            self.epoch_losses.append(scalars["epoch_loss"])

    def close(self):
        pass


def trainer(path, seed=0, optimizer=torch.optim.Adam, **kw):
    xs, ys = tokens(1, 10)
    m = model(seed)
    return Trainer(
        m, ShardedLoader(ArrayDataset(xs, ys), 4, shuffle=True, seed=2),
        optimizer(m.parameters(), lr=1e-3), 1, snapshot_path=path,
        loss_fn=softmax_cross_entropy_loss, metrics=Capture(), device="cpu", **kw,
    )


def test_tree_round_trip_keeps_structure_dtypes_and_values(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16), (3, "x", None)],
        7: {"c": torch.arange(4, dtype=torch.int32), "d": 0.125, "e": True},
    }
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tree, metadata={"epoch": 2})
    got, meta = load_checkpoint(path)
    assert meta == {"epoch": 2}
    assert torch.equal(got["a"], tree["a"])
    assert got["b"][0].dtype == torch.bfloat16 and torch.equal(got["b"][0], tree["b"][0])
    assert got["b"][1] == (3, "x", None)
    assert got[7]["c"].dtype == torch.int32 and torch.equal(got[7]["c"], tree[7]["c"])
    assert got[7]["d"] == 0.125 and got[7]["e"] is True


@pytest.mark.parametrize("optimizer", [torch.optim.Adam, torch.optim.AdamW], ids=["adam", "adamw"])
def test_snapshot_round_trip_carries_the_optimizer_state(tmp_path, optimizer):
    """Two steps, snapshot, two more; against a fresh model and optimizer
    restored from the snapshot taking the same two steps."""
    def run(m, opt, state, seeds):
        step = make_train_step(m, opt, softmax_cross_entropy_loss)
        losses = []
        for s in seeds:
            xs, ys = tokens(s, 2)
            state, loss = step(state, (torch.from_numpy(xs), torch.from_numpy(ys)))
            losses.append(float(loss))
        return state, losses

    m = model()
    opt = optimizer(m.parameters(), lr=1e-3)
    state, _ = run(m, opt, create_train_state(m, opt), [10, 11])
    path = str(tmp_path / "s.npz")
    save_snapshot(path, state.state_dict(), epochs_run=1)
    _, straight = run(m, opt, state, [12, 13])

    m2 = model(seed=5)
    opt2 = optimizer(m2.parameters(), lr=1e-3)
    state2 = create_train_state(m2, opt2)
    tree, meta = load_snapshot(path)
    state2.load_state_dict(tree)
    assert meta["epochs_run"] == 1 and meta["step_in_epoch"] == 0 and state2.step == 2
    assert len(opt2.state) == len(list(m2.parameters()))
    _, resumed = run(m2, opt2, state2, [12, 13])
    assert resumed == straight
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_resumed_trainer_reproduces_the_uninterrupted_epochs(tmp_path):
    straight = trainer(str(tmp_path / "a.npz"))
    straight.train(3)
    first = trainer(str(tmp_path / "b.npz"))
    first.train(1)
    resumed = trainer(str(tmp_path / "b.npz"), seed=9)
    assert resumed.epochs_run == 1 and resumed.state.step == first.state.step == 3
    resumed.train(3)
    assert first.metrics.epoch_losses + resumed.metrics.epoch_losses == straight.metrics.epoch_losses
    for a, b in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_mid_epoch_snapshot_resumes_at_the_exact_batch(tmp_path):
    """A snapshot taken after 2 of epoch 1's 3 batches: the resumed Trainer
    skips them and logs the whole epoch's mean loss."""
    straight = trainer(str(tmp_path / "a.npz"))
    straight.train(2)
    part = trainer(str(tmp_path / "b.npz"))
    part.train(1)
    part.train_data.set_epoch(1)
    loss_sum = 0.0
    for xs, ys in list(part.train_data.iter_batches())[:2]:
        part.state, loss = part.train_step(part.state, part._put_batch(xs, ys))
        loss_sum += float(loss)
    part.save_mid_epoch_snapshot(1, steps_done=2, loss_sum=loss_sum, loss_count=2)
    resumed = trainer(str(tmp_path / "b.npz"), seed=4)
    assert resumed.epochs_run == 1 and resumed.state.step == 5
    resumed.train(2)
    assert resumed.state.step == straight.state.step == 6
    assert resumed.metrics.epoch_losses == pytest.approx(straight.metrics.epoch_losses[1:], rel=1e-12)
    for a, b in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_mid_epoch_snapshot_under_another_loader_replays_the_epoch(tmp_path):
    path = str(tmp_path / "s.npz")
    first = trainer(path)
    first.train(1)
    first.save_mid_epoch_snapshot(1, steps_done=2, loss_sum=1.0, loss_count=2)
    xs, ys = tokens(1, 10)
    m = model()
    other = Trainer(m, ShardedLoader(ArrayDataset(xs, ys), 5, shuffle=True, seed=2),
                    torch.optim.Adam(m.parameters(), lr=1e-3), 1, snapshot_path=path,
                    loss_fn=softmax_cross_entropy_loss, metrics=Capture(), device="cpu")
    assert other.epochs_run == 1 and other._resume_step == 0


def tamper(path, key, fn):
    """Rewrite the .npz with one array changed and its metadata entry (and
    so its recorded checksums) kept: the zip's own CRCs are fresh, only the
    snapshot's manifest can tell."""
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    arrays[key] = fn(arrays[key].copy())
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def flip_first_bit(a):
    a.view(np.uint8).reshape(-1)[0] ^= 0x01
    return a


def test_corrupt_latest_falls_back_to_prev_and_is_quarantined(tmp_path):
    path = str(tmp_path / "s.npz")
    save_snapshot(path, {"w": torch.ones(256)}, epochs_run=1)
    save_snapshot(path, {"w": torch.full((256,), 2.0)}, epochs_run=2)
    assert os.path.exists(path + ".prev")
    tamper(path, "w", flip_first_bit)
    tree, meta, used = load_snapshot_with_fallback(path)
    assert used == path + ".prev" and meta["epochs_run"] == 1
    assert torch.equal(tree["w"], torch.ones(256))
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_a_bit_flip_fails_the_checksum(tmp_path):
    path = str(tmp_path / "s.npz")
    save_snapshot(path, {"w": torch.zeros(4096)}, epochs_run=1)
    tamper(path, "w", flip_first_bit)
    with pytest.raises(SnapshotIntegrityError, match="checksum mismatch"):
        load_snapshot(path)


def test_a_missing_array_fails_the_manifest(tmp_path):
    path = str(tmp_path / "s.npz")
    save_snapshot(path, {"w": torch.zeros(4), "v": torch.ones(4)}, epochs_run=1)
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files if k != "v"}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(SnapshotIntegrityError, match="missing"):
        load_snapshot(path)


def test_a_torn_file_is_rejected(tmp_path):
    path = str(tmp_path / "s.npz")
    save_snapshot(path, {"w": torch.ones(1024)}, epochs_run=3)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    assert load_snapshot_with_fallback(path) is None
    assert os.path.exists(path + ".corrupt")


def test_trainer_resumes_from_prev_when_the_latest_is_torn(tmp_path):
    path = str(tmp_path / "s.npz")
    first = trainer(path)
    first.train(2)  # snapshot after epoch 1, .prev after epoch 0
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:100])
    resumed = trainer(path, seed=3)
    assert resumed.epochs_run == 1 and resumed.state.step == 3
    assert os.path.exists(path + ".corrupt")


def test_quarantine_never_overwrites_an_earlier_quarantine(tmp_path):
    path = str(tmp_path / "s.npz")
    for expect in (".corrupt", ".corrupt.1"):
        open(path, "wb").write(b"x")
        assert quarantine(path) == path + expect
    assert quarantine(path) is None


def test_checkpoint_rotation_and_plain_checkpoints(tmp_path):
    """Without a snapshot path the Trainer writes the model's weights to
    checkpoint_path every save_every epochs."""
    ck = str(tmp_path / "ck.npz")
    xs, ys = tokens(1, 8)
    m = model()
    t = Trainer(m, ShardedLoader(ArrayDataset(xs, ys), 4),
                torch.optim.SGD(m.parameters(), lr=0.1), 1, checkpoint_path=ck,
                loss_fn=softmax_cross_entropy_loss, metrics=Capture(), device="cpu")
    t.train(1)
    tree, meta = load_checkpoint(ck)
    assert meta == {"epoch": 0, "epochs_run": 1}
    for name, p in m.state_dict().items():
        assert torch.equal(tree["model"][name], p)
    save_checkpoint(ck, {"x": torch.zeros(1)}, keep_previous=True)
    assert os.path.exists(ck + ".prev")

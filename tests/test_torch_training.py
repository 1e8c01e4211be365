"""The port's training path against the JAX package's, on the CPU.

Loader batch streams must be identical to the JAX ``ShardedLoader``'s.
Losses, the training forward's logits, ``make_train_step`` and the
``Trainer`` run on the same inputs (numpy-seeded) and the same weights (the
JAX module's seeded init, crossed with ``params_from_jax``) on both sides.

Tolerances: losses 1e-6 relative (the same float32 formula); float32
logits 1e-4 (flash against dense attention, sums in another order); bf16
logits 0.1 at a logit scale of ~3 (the two frameworks round to bf16 at
other points); train steps: losses 1e-5 relative and parameters 2e-5
absolute after 3 steps (gradients summed in another order, then Adam's
normalisation); Trainer epoch losses 1e-5 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from distributed_pytorch_tpu.obs.goodput import transformer_train_flops as jax_flops
from distributed_pytorch_tpu.training import losses as jax_losses
from distributed_pytorch_tpu.training.train_step import (
    create_train_state as jax_create_state,
    make_train_step as jax_make_step,
)
from distributed_pytorch_tpu.training.trainer import Trainer as JaxTrainer
from distributed_pytorch_tpu.utils import data as jax_data
from distributed_pytorch_tpu_torch.metrics import MetricLogger
from distributed_pytorch_tpu_torch.models.transformer import TransformerLM, params_from_jax
from distributed_pytorch_tpu_torch.obs.goodput import transformer_train_flops
from distributed_pytorch_tpu_torch.parallel.bootstrap import is_main_process, process_index
from distributed_pytorch_tpu_torch.training import (
    Trainer,
    create_train_state,
    make_train_step,
    mse_loss,
    softmax_cross_entropy_loss,
)
from distributed_pytorch_tpu_torch.utils import data

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
T = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def token_data(seed, n, t=T):
    toks = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n, t + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


class Capture:
    """A metrics sink for both Trainers: keeps the epoch losses."""

    def __init__(self):
        self.epoch_losses = []

    def log(self, step, **scalars):
        if "epoch_loss" in scalars:
            self.epoch_losses.append(float(scalars["epoch_loss"]))

    def close(self):
        pass


# ---------------------------------------------------------------- loader


LOADERS = [
    dict(num_shards=1, shard_index=0),
    dict(num_shards=3, shard_index=1),
    dict(num_shards=3, shard_index=2, drop_last=True),
    dict(num_shards=1, shard_index=0, pad_final_batch=True),
    dict(num_shards=4, shard_index=3, pad_final_batch=True),
    dict(num_shards=2, shard_index=0, drop_last=True),
]


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("geometry", LOADERS, ids=[
    "one_shard", "shard1of3", "drop_last", "pad_final", "pad_shard3of4", "drop_last2",
])
def test_batch_streams_equal_the_jax_loaders(shuffle, geometry):
    n = 23
    inputs = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    targets = np.arange(n, dtype=np.int32)
    ours = data.ShardedLoader(data.ArrayDataset(inputs, targets), 4, shuffle=shuffle,
                              seed=5, **geometry)
    ref = jax_data.ShardedLoader(jax_data.ArrayDataset(inputs, targets), 4,
                                 shuffle=shuffle, seed=5, **geometry)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours.shard_indices(), ref.shard_indices())
        for start in (0, 1):
            got = list(ours.iter_batches(start))
            want = list(ref.iter_batches(start))
            assert len(got) == len(want)
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
    assert ours.order_state() == ref.order_state()
    assert ours.matches_order_state(ref.order_state())


@pytest.mark.parametrize("num_classes", [0, 10], ids=["dense", "classes"])
def test_random_dataset_samples_equal_the_jax_ones(num_classes):
    ours = data.RandomDataset(6, (4,), (3,), seed=2, num_classes=num_classes)
    ref = jax_data.RandomDataset(6, (4,), (3,), seed=2, num_classes=num_classes)
    for i in range(6):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        ours[6]


def test_loader_refuses_a_shard_outside_the_group():
    with pytest.raises(ValueError, match="shard_index"):
        data.ShardedLoader(data.ArrayDataset(np.zeros(4), np.zeros(4)), 2,
                           num_shards=2, shard_index=2)


# ---------------------------------------------------------------- losses


def test_mse_matches_jax():
    p, t = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    want = float(jax_losses.mse_loss(jnp.asarray(p), jnp.asarray(t)))
    assert math.isclose(float(mse_loss(torch.from_numpy(p), torch.from_numpy(t))), want,
                        rel_tol=1e-6)


@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 10)], ids=["rows", "tokens"])
def test_integer_cross_entropy_matches_jax(shape):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    targets = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jax_losses.softmax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(softmax_cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert math.isclose(got, want, rel_tol=1e-6)


def test_soft_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 4, 7)).astype(np.float32)
    soft = rng.random((2, 4, 7)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    want = float(jax_losses.softmax_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(soft)))
    got = float(softmax_cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(soft)))
    assert math.isclose(got, want, rel_tol=1e-6)


# ---------------------------------------------------------------- the training forward


MODELS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "window": {"attention_window": 4},
    "tied": {"tie_embeddings": True},
}


def jax_params(jm):
    return jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]


def port_model(params, dtype=torch.float32, **extra):
    tm = TransformerLM(**CFG, dtype=dtype, param_dtype=torch.float32, **extra)
    tm.load_state_dict(params_from_jax(params))
    return tm


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 1e-4), (torch.bfloat16, jnp.bfloat16, 0.1),
], ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", list(MODELS))
def test_training_forward_matches_jax_apply(variant, dtype, jdtype, tol):
    extra = MODELS[variant]
    jm = JaxLM(**CFG, dtype=jdtype, **extra)
    params = jax_params(jm)
    toks, _ = token_data(3, 2)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(toks)))
    tm = port_model(params, dtype, **extra)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, T, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_tied_model_has_no_head_and_loads_strictly():
    jm = JaxLM(**CFG, tie_embeddings=True)
    params = jax_params(jm)
    assert "lm_head" not in params
    tm = TransformerLM(**CFG, tie_embeddings=True)
    sd = params_from_jax(params)
    assert set(sd) == set(tm.state_dict()) and not any(k.startswith("lm_head") for k in sd)


def test_fp32_params_with_bf16_compute():
    tm = TransformerLM(**CFG, dtype=torch.bfloat16, param_dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    toks = torch.from_numpy(token_data(4, 2)[0])
    logits = tm(toks)
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters() if p.requires_grad)


@pytest.mark.parametrize("option,value", [
    ("dropout_rate", 0.1), ("remat", True), ("n_experts", 4), ("fused_head_chunk", 32),
])
def test_options_of_later_slices_are_refused(option, value):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TransformerLM(**CFG, **{option: value})


def test_paged_decode_refuses_a_window():
    tm = TransformerLM(**CFG, attention_window=4)
    cache = tm.init_paged_cache(4, 4, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        tm(torch.zeros((1, 1), dtype=torch.long), cache=cache,
           block_tables=torch.ones((1, 2), dtype=torch.int32),
           seq_lens=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------- train step


OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8),
             lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=0.0)),
    "adamw": (lambda: optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2),
              lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=1e-2)),
    "sgd": (lambda: optax.sgd(0.1, momentum=0.9),
            lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)),
}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_train_step_matches_jax(opt_name, grad_accum):
    """Three steps from the same weights on the same batches: the loss of
    every step and the parameters after."""
    jax_opt, torch_opt = OPTIMIZERS[opt_name]
    jm = JaxLM(**CFG)
    x0, _ = token_data(5, 4)
    state = jax_create_state(jm, jax_opt(), x0, rng_seed=0)
    jstep = jax_make_step(jm.apply, jax_opt(), jax_losses.softmax_cross_entropy_loss,
                          grad_accum=grad_accum)
    tm = port_model(state.params)
    opt = torch_opt(tm.parameters())
    tstate = create_train_state(tm, opt)
    tstep = make_train_step(tm, opt, softmax_cross_entropy_loss, grad_accum=grad_accum)
    for s in range(3):
        xs, ys = token_data(10 + s, 4)
        state, jloss = jstep(state, (jnp.asarray(xs), jnp.asarray(ys)))
        tstate, tloss = tstep(tstate, (torch.from_numpy(xs), torch.from_numpy(ys)))
        assert tloss.dim() == 0 and not tloss.requires_grad
        assert math.isclose(float(tloss), float(jloss), rel_tol=1e-5)
    assert tstate.step == 3 == int(state.step)
    want = params_from_jax(state.params)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def test_train_step_refuses_an_indivisible_microbatch_split():
    tm = TransformerLM(**CFG)
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    step = make_train_step(tm, opt, softmax_cross_entropy_loss, grad_accum=2)
    xs, ys = token_data(6, 3)
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        step(create_train_state(tm, opt), (torch.from_numpy(xs), torch.from_numpy(ys)))


def test_create_train_state_wants_float32_params_it_owns():
    bf16 = TransformerLM(**CFG, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        create_train_state(bf16, torch.optim.SGD(bf16.parameters(), lr=0.1))
    tm = TransformerLM(**CFG)
    other = TransformerLM(**CFG)
    with pytest.raises(ValueError, match="module.parameters"):
        create_train_state(tm, torch.optim.SGD(other.parameters(), lr=0.1))


# ---------------------------------------------------------------- Trainer


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_epoch_losses_match_the_jax_trainer(grad_accum):
    """Two epochs over 10 shuffled sequences at batch 4 (a ragged final
    batch of 2, wrap-padded under grad_accum 2) with Adam: the same epoch
    losses, and the same parameters at the end."""
    xs, ys = token_data(7, 10)
    jm = JaxLM(**CFG)

    def loader(mod):
        return mod.ShardedLoader(mod.ArrayDataset(xs, ys), 4, shuffle=True, seed=3)

    jcap, tcap = Capture(), Capture()
    jt = JaxTrainer(jm, loader(jax_data), optax.adam(1e-3), 0,
                    loss_fn=jax_losses.softmax_cross_entropy_loss, metrics=jcap,
                    grad_accum=grad_accum)
    tm = port_model(jt.state.params)
    tt = Trainer(tm, loader(data), torch.optim.Adam(tm.parameters(), lr=1e-3), 0,
                 loss_fn=softmax_cross_entropy_loss, metrics=tcap, grad_accum=grad_accum,
                 device="cpu")
    jt.train(2)
    tt.train(2)
    assert len(tcap.epoch_losses) == 2
    np.testing.assert_allclose(tcap.epoch_losses, jcap.epoch_losses, rtol=1e-5)
    assert tt.state.step == int(jt.state.step)
    want = params_from_jax(jt.state.params)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def test_trainer_moves_the_model_and_runs_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TransformerLM(**CFG)
    xs, ys = token_data(8, 4)
    ld = data.ShardedLoader(data.ArrayDataset(xs, ys), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tm, ld, torch.optim.SGD(tm.parameters(), lr=0.1), 0)


# ---------------------------------------------------------------- small copies


def test_bootstrap_without_a_process_group_is_rank_zero():
    assert process_index() == 0 and is_main_process()


def test_metric_logger_prints_one_json_line(capsys):
    logger = MetricLogger()
    logger.log(3, loss=1.5, epoch=0)
    logger.close()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    record = json.loads(line)
    assert record["step"] == 3 and record["loss"] == 1.5 and "elapsed_s" in record


@pytest.mark.parametrize("window", [None, 512])
def test_train_flops_equal_the_jax_model(window):
    kw = dict(n_params=436_404_224, embed_params=32768 * 2048, n_layers=6, n_heads=16,
              head_dim=128, seq_len=8192, batch=2, window=window)
    assert transformer_train_flops(**kw) == jax_flops(**kw)

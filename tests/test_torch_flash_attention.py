"""The port's flash attention against the JAX package's, on the CPU.

The plain versions of K1 (forward: out and lse), K2 (dQ) and K3 (dK, dV)
are held to the JAX Pallas kernels run in interpret mode with 8 x 8 tiles,
as ``tests/test_flash_attention.py`` runs them, and to ``jax.vjp`` through
them. The port's autograd path (``flash_attention``, and
``flash_attention_with_lse`` with a nonzero lse cotangent) runs the plain
versions on CPU tensors; it is held to the same JAX functions and to the
port's dense ``dot_product_attention``.

Tolerances: float32 throughout, 2e-5 absolute (as the JAX package's own
flash tests): the same function summed in another order. bf16 against the
dense version: 2e-2 (the two round the probabilities at other points).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops.attention import (
    dot_product_attention as jax_dense,
)
from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops.attention import NEG_INF, dot_product_attention

jf = importlib.import_module("distributed_pytorch_tpu.ops.flash_attention")
tf = importlib.import_module("distributed_pytorch_tpu_torch.ops.flash_attention")

TOL = 2e-5
BLOCK = 8  # the Pallas kernels' tile in interpret mode, and the plain versions'


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this module from crowding the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def jax_with_lse(q, k, v, g, dlse, causal, window, q_offset):
    """The Pallas kernels in interpret mode: (out, lse) and the vjp."""

    def f(q, k, v):
        return jf.flash_attention_with_lse(
            q, k, v, causal, BLOCK, BLOCK, True, window, q_offset
        )

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(dlse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


MASKS = [(False, 0), (True, 0), (True, 8), (True, 24)]
MASK_IDS = ["full", "causal", "window8", "window24"]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
def test_plain_forward_matches_pallas(causal, window, d):
    q, k, v = arrays(0, *[(4, 32, d)] * 3)
    out, lse, *_ = jax_with_lse(q, k, v, np.zeros_like(q), np.zeros((4, 32, 1), np.float32),
                                causal, window, 0)
    got_out, got_lse = tf.flash_fwd_reference(
        *map(torch.from_numpy, (q, k, v)), causal, window, 0, block_q=BLOCK, block_k=BLOCK
    )
    close(got_out, out)
    close(got_lse, lse)
    assert got_lse.shape == (4, 32, 1) and got_lse.dtype == torch.float32


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
def test_plain_backward_matches_pallas_vjp(causal, window, d):
    """K2 and K3's plain versions, fed the saved lse and
    delta = rowsum(dO * O), give jax.vjp's dQ, dK, dV."""
    q, k, v, g = arrays(1, *[(4, 32, d)] * 4)
    zero = np.zeros((4, 32, 1), np.float32)
    _, _, dq, dk, dv = jax_with_lse(q, k, v, g, zero, causal, window, 0)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    kw = dict(block_q=BLOCK, block_k=BLOCK)
    out, lse = tf.flash_fwd_reference(tq, tk, tv, causal, window, 0, **kw)
    delta = (tg * out).sum(-1, keepdim=True)
    args = (tq, tk, tv, tg, lse, delta, causal, window, 0)
    close(tf.flash_bwd_dq_reference(*args, **kw), dq)
    got_dk, got_dv = tf.flash_bwd_dkv_reference(*args, **kw)
    close(got_dk, dk)
    close(got_dv, dv)


@pytest.mark.parametrize("q_offset", [16, 40])
def test_banded_hop_with_wholly_masked_rows_matches_pallas(q_offset):
    """q_offset with a window: rows wholly masked inside live tiles take
    the tile's values with weight exp(NEG_INF - NEG_INF) = 1, rows whose
    every tile is skipped give 0 and lse = NEG_INF, exactly as the Pallas
    kernels do; the gradients (with a nonzero lse cotangent) agree too."""
    q, k, v, g, dlse = arrays(2, *[(2, 32, 16)] * 4, (2, 32, 1))
    out, lse, dq, dk, dv = jax_with_lse(q, k, v, g, dlse, True, 8, q_offset)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    kw = dict(block_q=BLOCK, block_k=BLOCK)
    got_out, got_lse = tf.flash_fwd_reference(tq, tk, tv, True, 8, q_offset, **kw)
    close(got_out, out)
    np.testing.assert_array_equal(got_lse.numpy() <= NEG_INF / 2, np.asarray(lse) <= NEG_INF / 2)
    assert (got_lse.numpy() <= NEG_INF / 2).any()
    delta = (tg * got_out).sum(-1, keepdim=True) - torch.from_numpy(dlse)
    args = (tq, tk, tv, tg, got_lse, delta, True, 8, q_offset)
    close(tf.flash_bwd_dq_reference(*args, **kw), dq)
    for got, ref in zip(tf.flash_bwd_dkv_reference(*args, **kw), (dk, dv)):
        close(got, ref)


WITH_LSE = [(False, 0, 0), (True, 0, 0), (True, 8, 0), (True, 24, 0), (True, 0, 16)]


@pytest.mark.parametrize("causal,window,q_offset", WITH_LSE,
                         ids=["full", "causal", "window8", "window24", "offset16"])
def test_with_lse_autograd_matches_pallas(causal, window, q_offset):
    """The port's FlashAttentionWithLse (CPU: the plain versions) folds a
    nonzero lse cotangent into delta as the reference's custom_vjp does."""
    q, k, v, g, dlse = arrays(3, *[(4, 32, 16)] * 4, (4, 32, 1))
    out, lse, dq, dk, dv = jax_with_lse(q, k, v, g, dlse, causal, window, q_offset)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got_out, got_lse = tf.flash_attention_with_lse(tq, tk, tv, causal, window, q_offset)
    close(got_out, out)
    close(got_lse, lse)
    loss = (got_out * torch.from_numpy(g)).sum() + (got_lse * torch.from_numpy(dlse)).sum()
    for got, ref in zip(torch.autograd.grad(loss, (tq, tk, tv)), (dq, dk, dv)):
        close(got, ref)


DENSE = [(False, 0), (True, 0), (True, 5)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window", DENSE, ids=["full", "causal", "window5"])
def test_flash_attention_matches_dense_with_gradients(causal, window, dtype, tol):
    """[B, T, H, D] through the port's flash path (T = 20, a tail tile of
    the 64-row blocks) against the port's dot_product_attention, forward
    and gradients."""
    base = arrays(4, *[(2, 20, 3, 16)] * 4)
    ins = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in base[:3]]
    g = torch.tensor(base[3], dtype=dtype)
    out = tf.flash_attention(*ins, causal=causal, window=window)
    ref = dot_product_attention(*ins, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    close(out, ref.detach().float(), tol)
    grads = torch.autograd.grad((out * g).sum(), ins)
    ref_grads = torch.autograd.grad((ref * g).sum(), ins)
    for got, want in zip(grads, ref_grads):
        close(got, want.float(), tol)


@pytest.mark.parametrize("causal,window", DENSE, ids=["full", "causal", "window5"])
def test_dense_attention_matches_jax(causal, window):
    q, k, v = arrays(5, *[(2, 12, 2, 8)] * 3)
    want = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window)
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    close(got, want, 1e-6)


@pytest.mark.parametrize("fn", [tf.flash_attention, dot_product_attention],
                         ids=["flash", "dense"])
def test_negative_window_is_refused(fn):
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="window must be >= 0"):
        fn(x, x, x, causal=True, window=-1)


@pytest.mark.parametrize("fn", [tf.flash_attention, dot_product_attention],
                         ids=["flash", "dense"])
def test_window_without_causal_is_refused(fn):
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="window requires causal"):
        fn(x, x, x, causal=False, window=2)


def test_flash_attention_refuses_mismatched_shapes():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="one \\[B, T, H, D\\] shape"):
        tf.flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(x) for x in arrays(6, *[(2, 9, 16)] * 4))
    before = dict(_build.LAUNCHES)
    out, lse = tf.flash_fwd(q, k, v, True)
    ref_out, ref_lse = tf.flash_fwd_reference(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = (do * out).sum(-1, keepdim=True)
    assert torch.equal(tf.flash_bwd_dq(q, k, v, do, lse, delta, True),
                       tf.flash_bwd_dq_reference(q, k, v, do, lse, delta, True))
    assert dict(_build.LAUNCHES) == before


def test_wrappers_refuse_devices_they_do_not_run_on():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.flash_fwd(x, x, x)

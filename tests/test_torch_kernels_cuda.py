"""The port's CUDA kernels on the card, against their plain versions.

Imports torch and the port only, so it runs on a machine with a card and no
JAX. Every test is marked ``cuda`` and skips where no CUDA device is
visible; on the card run ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances (atol, rtol): float32 (1e-5, 1e-5), sums in another order.
K4 in bf16 (2e-2, 2e-2): the plain version rounds scores and the weighted
sum through bf16, the kernel keeps float32. K1-K3 in bf16 (1e-3, 1e-2) on
each row's RMS over the head dim: the plain versions round where the
kernels round, but fp32 sums in another order now and then flip the bf16
rounding of one probability, which moves an element by up to 2^-8 of that
term however small the element is. lse is float32 on both sides and held
at (1e-5, 1e-5) element by element whatever q's dtype.
"""

import pytest
import torch

from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops.attention import dot_product_attention
from distributed_pytorch_tpu_torch.ops.paged_attention import (
    KERNEL,
    paged_attention,
    paged_attention_reference,
)
from distributed_pytorch_tpu_torch.ops.quant import quantize_int8

pytestmark = pytest.mark.cuda

PAGE = 16
PAGES_PER_SEQ = 8


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def problem(device, *, h, kv_heads, d, dtype, quant, seed=0):
    """Rows at lengths 0 (inactive), 1, 16, 17 and 127: page-boundary and
    full-table cases over pools of 4 * 8 + 1 pages."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lens = [0, 1, 16, 17, PAGES_PER_SEQ * PAGE - 1]
    s = len(lens)
    num_pages = s * PAGES_PER_SEQ + 1
    q = torch.randn(s, 1, h, d, generator=gen, device=device).to(dtype)
    k = torch.randn(num_pages, PAGE, kv_heads, d, generator=gen, device=device)
    v = torch.randn(num_pages, PAGE, kv_heads, d, generator=gen, device=device)
    kw = {}
    if quant:
        kq, vq = quantize_int8(k, (3,)), quantize_int8(v, (3,))
        k, v = kq.q, vq.q
        kw = dict(k_scale=kq.scale.squeeze(-1), v_scale=vq.scale.squeeze(-1))
    else:
        k, v = k.to(dtype), v.to(dtype)
    tables = torch.zeros(s, PAGES_PER_SEQ, dtype=torch.int32, device=device)
    for i, n in enumerate(lens):
        used = n // PAGE + 1
        tables[i, :used] = torch.arange(1, used + 1) + i * PAGES_PER_SEQ
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    return (q, k, v, tables, lens_t), kw


CASES = [
    (16, 16, 128, torch.float32, False),
    (16, 4, 64, torch.float32, False),
    (16, 16, 128, torch.bfloat16, False),
    (16, 4, 128, torch.bfloat16, False),
    (16, 16, 128, torch.bfloat16, True),
    (16, 4, 64, torch.float32, True),
]


@pytest.mark.parametrize("h,kv_heads,d,dtype,quant", CASES)
def test_kernel_matches_plain_version(device, h, kv_heads, d, dtype, quant):
    args, kw = problem(device, h=h, kv_heads=kv_heads, d=d, dtype=dtype, quant=quant)
    before = _build.LAUNCHES[KERNEL]
    out = paged_attention(*args, **kw)
    ref = paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[KERNEL] == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_poisoned_null_page_moves_no_live_row(device):
    args, _ = problem(device, h=16, kv_heads=4, d=128, dtype=torch.bfloat16, quant=False)
    q, k, v, tables, lens = args
    out = paged_attention(*args)
    k[0], v[0] = 1e4, -1e4
    poisoned = paged_attention(q, k, v, tables, lens)
    live = lens > 0
    assert torch.equal(poisoned[live], out[live])
    assert torch.isfinite(poisoned).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    args, _ = problem(device, h=16, kv_heads=4, d=128, dtype=torch.float32, quant=False)
    q, k, v, tables, lens = args
    with pytest.raises(ValueError, match="one query per row"):
        paged_attention(torch.cat([q, q], dim=1), k, v, tables, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, k, v, tables.long(), lens)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention(q, k.bfloat16(), v.bfloat16(), tables, lens)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, tables, lens)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), tables, lens)


FLASH_CASES = [
    (torch.float32, 64, True, 0, 0),
    (torch.float32, 128, False, 0, 0),
    (torch.bfloat16, 128, True, 0, 0),
    (torch.bfloat16, 128, True, 256, 0),
    (torch.bfloat16, 64, True, 256, 300),  # rows wholly masked
]


@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("dtype,d,causal,window,q_offset", FLASH_CASES)
def test_flash_kernels_match_plain_versions(device, dtype, d, causal, window, q_offset, t):
    """K1 (out, lse), K2 (dQ) and K3 (dK, dV) against their plain versions,
    at T = 1 and at T = 1000 (a tail tile: no dense fallback)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(t + d)
    q, k, v, do = (torch.randn(4, t, d, generator=gen, device=device).to(dtype)
                   for _ in range(4))
    before = {n: _build.LAUNCHES[n] for n in (fa.KERNEL_FWD, fa.KERNEL_BWD_DQ, fa.KERNEL_BWD_DKV)}
    out, lse = fa.flash_fwd(q, k, v, causal, window, q_offset)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, causal, window, q_offset)
    delta = (do.float() * ref_out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, ref_lse, delta, causal, window, q_offset)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*args)
    pairs = [(out, ref_out), (lse, ref_lse), (dq, fa.flash_bwd_dq_reference(*args)),
             (dk, ref_dk), (dv, ref_dv)]
    torch.cuda.synchronize()
    assert {n: _build.LAUNCHES[n] - c for n, c in before.items()} == dict.fromkeys(before, 1)
    for i, (got, ref) in enumerate(pairs):
        assert torch.isfinite(got).all()
        if i == 1 or dtype == torch.float32:  # lse, or any float32 result
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-5, rtol=1e-5)
        else:
            rms_err = (got.float() - ref.float()).square().mean(-1).sqrt()
            rms_ref = ref.float().square().mean(-1).sqrt()
            assert (rms_err <= 1e-3 + 1e-2 * rms_ref).all(), (rms_err / (1e-3 + 1e-2 * rms_ref)).max()


def test_flash_attention_autograd_launches_the_three_kernels(device):
    """[B, T, H, D] through flash_attention forward and backward: one launch
    of each kernel, and the dense version's output and gradients (float32)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    q, k, v = (torch.randn(2, 300, 4, 64, generator=gen, device=device).requires_grad_()
               for _ in range(3))
    g = torch.randn(2, 300, 4, 64, generator=gen, device=device)
    before = {n: _build.LAUNCHES[n] for n in (fa.KERNEL_FWD, fa.KERNEL_BWD_DQ, fa.KERNEL_BWD_DKV)}
    out = fa.flash_attention(q, k, v, causal=True, window=100)
    grads = torch.autograd.grad((out * g).sum(), (q, k, v))
    ref = dot_product_attention(q, k, v, causal=True, window=100)
    ref_grads = torch.autograd.grad((ref * g).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert {n: _build.LAUNCHES[n] - c for n, c in before.items()} == dict.fromkeys(before, 1)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(device):
    q = torch.zeros(2, 16, 64, device=device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_fwd(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), q.half(), q.half())

"""Flash attention: tiled online-softmax attention with its backward.

The port of ``distributed_pytorch_tpu/ops/flash_attention.py``. Its three
TPU kernels become the hand-written CUDA kernels of
``csrc/flash_attention.cu``, each behind a wrapper that counts its launches
in ``_build.LAUNCHES``:

* :func:`flash_fwd` (K1, ``_fwd_kernel``): ``(out, lse)`` over
  ``[B*H, T, D]``;
* :func:`flash_bwd_dq` (K2, ``_bwd_dq_kernel``): dQ;
* :func:`flash_bwd_dkv` (K3, ``_bwd_dkv_kernel``): dK and dV.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the plain PyTorch version beside it (:func:`flash_fwd_reference`,
:func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`). There is
no fallback from one to the other, and no shape falls back to dense
attention on the card: the kernels mask the tail tile, so every ``T >= 1``
runs them.

The plain versions compute the kernels' function in plain PyTorch. Scores
are ``(q . k) * D**-0.5`` in float32 from inputs in their own dtype; causal
masking writes :data:`NEG_INF`; and the probabilities are rounded where the
TPU kernels round them (``p`` to v's dtype before ``P V``, ``ds`` to k's
dtype for dQ and to q's for dK, ``p`` to dO's dtype for dV). In bf16 where
``p`` is rounded is part of the function: the forward rounds it against the
running max of the key tiles seen so far, so the plain forward walks the
key tiles in the kernels' order with the same online-softmax state (the
backward rebuilds ``p`` from the saved lse and is dense). One more rule is
part of the function: tiles with no unmasked pair are skipped
(``_tile_live`` on ``block_q x block_k`` tiles, the kernel's 64 x 64 by
default), so a row that is wholly masked inside a live tile averages that
tile's values with weight ``exp(NEG_INF - NEG_INF) = 1``, as on the TPU, and
a row whose every tile is skipped gets output 0 and ``lse = NEG_INF``. Such
rows exist only with ``q_offset`` and a window (a banded ring hop); the
model's causal forward has none.

The autograd functions (:class:`FlashAttention`,
:class:`FlashAttentionWithLse`) are the twins of the reference's
``custom_vjp``s: the forward saves ``(q, k, v, out, lse)``, and the backward
computes ``delta = rowsum(dO * O)`` in float32 with torch (as XLA did outside
the TPU kernels; minus the lse cotangent for the ``with_lse`` variant), then
launches K2 and K3. :func:`flash_attention` is the model-facing entry point
over ``[B, T, H, D]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops._build import DTYPE_CODES, HEAD_DIMS
from distributed_pytorch_tpu_torch.ops.attention import NEG_INF

#: Launch-counter names of the three kernels.
KERNEL_FWD = "flash_fwd"
KERNEL_BWD_DQ = "flash_bwd_dq"
KERNEL_BWD_DKV = "flash_bwd_dkv"

#: The CUDA kernels' tile (``kBlock`` in ``csrc/flash_attention.cu``): rows
#: of a query tile and of a key tile. The plain versions skip tiles of the
#: same size by default.
BLOCK = 64

_MAX_GRID_Y = 65535  # the kernels put B*H on the launch grid's y dimension


# ---------------------------------------------------------------- plain versions


def _positions_ok(t: int, causal: bool, window: int, q_offset: int, device):
    """[T, T] bool: query row i (at position i + q_offset) may see key j."""
    if not causal:
        return None
    q_pos = torch.arange(t, device=device)[:, None] + q_offset
    k_pos = torch.arange(t, device=device)[None, :]
    ok = q_pos >= k_pos
    if window:
        ok = ok & (q_pos - k_pos < window)
    return ok


def _live_pairs(t, causal, window, q_offset, block_q, block_k, device):
    """[T, T] bool: whether (row, key) lies in a tile the kernels run — the
    reference's ``_tile_live`` on ``block_q x block_k`` tiles. None when no
    tile is skipped (non-causal)."""
    if not causal:
        return None
    q_start = torch.arange(0, t, block_q, device=device)[:, None] + q_offset
    k_start = torch.arange(0, t, block_k, device=device)[None, :]
    live = k_start <= q_start + block_q - 1
    if window:
        live = live & (q_start - (k_start + block_k - 1) <= window - 1)
    live = live.repeat_interleave(block_q, dim=0)[:t]
    return live.repeat_interleave(block_k, dim=1)[:, :t]


def _scores(q, k, causal, window, q_offset):
    """Masked float32 scores [BH, T, T] from q, k in their own dtype (the
    products of bf16 values are exact in float32)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    ok = _positions_ok(q.shape[1], causal, window, q_offset, q.device)
    if ok is not None:
        s = torch.where(ok, s, NEG_INF)
    return s


def _probabilities(q, k, lse, causal, window, q_offset, block_q, block_k):
    """``p = exp(s - lse)`` as the backward kernels rebuild it, 0 outside
    the live tiles."""
    p = torch.exp(_scores(q, k, causal, window, q_offset) - lse)
    live = _live_pairs(q.shape[1], causal, window, q_offset, block_q, block_k, q.device)
    return p if live is None else p.masked_fill(~live, 0.0)


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int = 0,
    q_offset: int = 0,
    *,
    block_q: int = BLOCK,
    block_k: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: ``(out [BH, T, D] in q's dtype, lse [BH, T, 1] float32)``.

    The reference's ``_fwd_kernel`` over every query row at once: for each
    key tile, rows whose tile is live update their running max ``m``, sum
    ``l`` and accumulator with ``p = exp(s - m_new)``, rounded to v's dtype
    before ``P V``."""
    bh, t, d = q.shape
    m = torch.full((bh, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
    q_tile = torch.arange(t, device=q.device) // block_q * block_q + q_offset
    for k0 in range(0, t, block_k):
        k1 = min(k0 + block_k, t)
        s = torch.matmul(q.float(), k[:, k0:k1].float().transpose(-1, -2)) * d**-0.5
        if causal:
            q_pos = torch.arange(t, device=q.device)[:, None] + q_offset
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            ok = q_pos >= k_pos
            if window:
                ok = ok & (q_pos - k_pos < window)
            s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p.to(v.dtype).float(), v[:, k0:k1].float())
        if causal:  # rows of dead tiles keep their state
            live = k0 <= q_tile + block_q - 1
            if window:
                live = live & (q_tile - (k0 + block_k - 1) <= window - 1)
            live = live[None, :, None]
            m_new, l_new = torch.where(live, m_new, m), torch.where(live, l_new, l)
            acc_new = torch.where(live, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return out.to(q.dtype), lse


def flash_bwd_dq_reference(
    q, k, v, do, lse, delta, causal=False, window=0, q_offset=0,
    *, block_q: int = BLOCK, block_k: int = BLOCK,
) -> torch.Tensor:
    """Plain K2: dQ [BH, T, D] in q's dtype. ``lse`` and ``delta`` are
    float32 [BH, T, 1]."""
    p = _probabilities(q, k, lse, causal, window, q_offset, block_q, block_k)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * q.shape[-1] ** -0.5).to(k.dtype)
    return torch.matmul(ds.float(), k.float()).to(q.dtype)


def flash_bwd_dkv_reference(
    q, k, v, do, lse, delta, causal=False, window=0, q_offset=0,
    *, block_q: int = BLOCK, block_k: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3: ``(dK, dV)`` [BH, T, D] in k's and v's dtypes."""
    p = _probabilities(q, k, lse, causal, window, q_offset, block_q, block_k)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * q.shape[-1] ** -0.5).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernel wrappers


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds.pop() not in ("cpu", "cuda"):
        raise ValueError(
            f"flash attention runs on cuda or cpu tensors, all on one device; "
            f"got {[str(t.device) for t in tensors]}"
        )
    return tensors[0].device.type


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_operands(q, k, v, do=None, lse=None, delta=None) -> None:
    """Everything the CUDA kernels assume, checked before a launch."""
    _check(q.dim() == 3, f"q must be [B*H, T, D], got {tuple(q.shape)}")
    heads = [q, k, v] + ([do] if do is not None else [])
    _check(all(tuple(x.shape) == tuple(q.shape) for x in heads),
           "q, k, v (and dO) must share one [B*H, T, D] shape")
    _check(all(x.dtype == q.dtype for x in heads),
           "q, k, v (and dO) must share one dtype")
    _check(q.dtype in DTYPE_CODES, f"dtype {q.dtype} not in float32/bfloat16")
    _check(q.shape[-1] in HEAD_DIMS, f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    _check(q.shape[0] <= _MAX_GRID_Y, f"B*H {q.shape[0]} over {_MAX_GRID_Y} (the grid's y extent)")
    stats = [x for x in (lse, delta) if x is not None]
    _check(all(x.dtype == torch.float32 and tuple(x.shape) == (*q.shape[:2], 1)
               for x in stats), "lse and delta must be float32 [B*H, T, 1]")
    every = heads + stats
    _check(all(x.device == q.device for x in every), "operands must share one device")
    _check(all(x.is_contiguous() for x in every), "operands must be contiguous")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, f, i, i, i, i, vp]  # bh, t, d, scale, causal, window, q_offset, dtype, stream
        lib.flash_fwd.argtypes = [vp] * 5 + tail
        lib.flash_bwd_dq.argtypes = [vp] * 7 + tail
        lib.flash_bwd_dkv.argtypes = [vp] * 8 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, q: torch.Tensor, pointers, causal, window, q_offset) -> None:
    """Launch kernel ``name`` over ``[B*H, T, D]`` operands and count it."""
    bh, t, d = q.shape
    _build.launch(
        name, getattr(_kernel_lib(), name), q.device,
        *pointers, bh, t, d, d**-0.5, int(causal), int(window), int(q_offset),
        DTYPE_CODES[q.dtype],
    )


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int = 0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(out, lse)`` over ``[B*H, T, D]`` (lse ``[B*H, T, 1]`` float32).
    CUDA tensors launch the kernel; CPU tensors run :func:`flash_fwd_reference`."""
    if _device_kind(q, k, v) == "cpu":
        return flash_fwd_reference(q, k, v, causal, window, q_offset)
    _check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((*q.shape[:2], 1), dtype=torch.float32, device=q.device)
    if q.numel():
        _launch(KERNEL_FWD, q, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr()),
                causal, window, q_offset)
    return out, lse


def flash_bwd_dq(
    q, k, v, do, lse, delta, causal=False, window=0, q_offset=0,
) -> torch.Tensor:
    """K2: dQ. CUDA tensors launch the kernel; CPU tensors run
    :func:`flash_bwd_dq_reference`."""
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, window, q_offset)
    _check_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if q.numel():
        _launch(KERNEL_BWD_DQ, q, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                   dq.data_ptr()),
                causal, window, q_offset)
    return dq


def flash_bwd_dkv(
    q, k, v, do, lse, delta, causal=False, window=0, q_offset=0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(dK, dV)``. CUDA tensors launch the kernel; CPU tensors run
    :func:`flash_bwd_dkv_reference`."""
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, window, q_offset)
    _check_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch(KERNEL_BWD_DKV, q, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                    dk.data_ptr(), dv.data_ptr()),
                causal, window, q_offset)
    return dk, dv


# ---------------------------------------------------------------- autograd


def _backward(ctx, g_out, delta_shift: Optional[torch.Tensor]):
    q, k, v, out, lse = ctx.saved_tensors
    g_out = g_out.contiguous()
    delta = (g_out.float() * out.float()).sum(dim=-1, keepdim=True)
    if delta_shift is not None:
        delta = delta - delta_shift.float()
    args = (q, k, v, g_out, lse, delta, ctx.causal, ctx.window, ctx.q_offset)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    return dq, dk, dv, None, None, None


class FlashAttention(torch.autograd.Function):
    """``out`` over ``[B*H, T, D]``, the twin of the reference's ``_flash``:
    forward K1, backward K2 then K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, window=0, q_offset=0):
        out, lse = flash_fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, g_out):
        return _backward(ctx, g_out, None)


class FlashAttentionWithLse(torch.autograd.Function):
    """``(out, lse)`` over ``[B*H, T, D]``, differentiable in both, the twin
    of the reference's ``flash_attention_with_lse``: the lse cotangent folds
    into the backward kernels as ``delta - dlse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, window=0, q_offset=0):
        out, lse = flash_fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return _backward(ctx, g_out, g_lse)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: int = 0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled attention returning ``(out, lse)`` over ``[B*H, T, D]`` inputs
    (lse ``[B*H, T, 1]`` float32), differentiable in both outputs.
    ``window``/``q_offset`` (causal only) shift the query positions that
    masking sees, as one hop of banded ring attention needs."""
    return FlashAttentionWithLse.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, window, q_offset
    )


def flash_attention_4d(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """``[B, T, H, D]`` through the ``[B*H, T, D]`` kernels and back."""
    b, t, h, d = q.shape

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    out = FlashAttention.apply(to3(q), to3(k), to3(v), causal, window, 0)
    return out.reshape(b, h, t, d).transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Tiled attention over ``[B, T, H, D]`` (the convention of
    :func:`.attention.dot_product_attention`, to which it is numerically
    equivalent). ``window > 0`` (causal only) is sliding-window attention:
    position q attends keys in ``(q - window, q]``, and tiles wholly outside
    the band are skipped. q, k and v carry the same heads (GQA repeats k
    and v first). On CUDA tensors the kernels run for every T."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window requires causal=True")
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    return flash_attention_4d(q, k, v, causal=causal, window=window)

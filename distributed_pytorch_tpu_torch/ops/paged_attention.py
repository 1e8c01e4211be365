"""Paged single-token decode attention over the serving engine's KV pools.

The port of ``distributed_pytorch_tpu/ops/paged_attention.py``. The pools
keep the JAX package's layout, ``[num_pages, page_size, Hkv, D]`` per layer,
addressed through per-slot block tables of physical page ids (page 0 is the
NULL page), with int8 pools carrying ``[num_pages, page_size, Hkv]``
float32 scale pools.

* :func:`paged_attention` is the kernel wrapper the model's decode step
  calls. On CUDA tensors it launches the hand-written kernel
  ``csrc/paged_attention.cu`` (the port of the TPU kernel ``_decode_kernel``)
  or raises; on CPU tensors it runs :func:`paged_attention_reference`.
  There is no fallback from one to the other.
* :func:`paged_attention_reference` is the plain PyTorch version, op for op
  the JAX package's reference: gather each row's pages into its logical
  view, positional visibility mask, grouped-query einsums in q's dtype, and
  an fp32 softmax whose weights are cast back to q's dtype. The CPU tests
  hold it against the JAX reference and the Pallas kernel; ``chip_smoke.py``
  holds the CUDA kernel against it on the card.

The kernel computes scores and the weighted sum in fp32 from the loaded
pages, where the reference rounds both einsums through q's dtype: in bf16
the two agree to a bf16 tolerance, not bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops._build import DTYPE_CODES, HEAD_DIMS
from distributed_pytorch_tpu_torch.ops.attention import NEG_INF

KERNEL = "paged_attention_decode"
_MAX_SMEM_BYTES = 227 * 1024  # a block's dynamic shared memory on Hopper


def paged_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch paged attention over ``q`` [S, T_step, H, D] (post-RoPE).

    ``seq_lens`` [S] is each row's token count BEFORE the step, i.e. the
    absolute position of its first new token; key position ``kpos`` is
    visible to step-query ``i`` iff ``kpos <= seq_lens + i``. With
    ``k_scale``/``v_scale`` the pools are int8 and dequantize at the
    gather, in q's dtype. Returns [S, T_step, H, D] in q's dtype."""
    s, t_step, h, d = q.shape
    kv_heads = k_pool.shape[2]
    page = k_pool.shape[1]
    pages_per_seq = block_tables.shape[1]
    kv_len = pages_per_seq * page
    tables = block_tables.long()

    positions = seq_lens.long()[:, None] + torch.arange(t_step, device=q.device)
    keys = k_pool[tables].reshape(s, kv_len, kv_heads, d)
    values = v_pool[tables].reshape(s, kv_len, kv_heads, d)
    if k_scale is not None:
        ks = k_scale[tables].reshape(s, kv_len, kv_heads)
        vs = v_scale[tables].reshape(s, kv_len, kv_heads)
        keys = keys.to(q.dtype) * ks[..., None].to(q.dtype)
        values = values.to(q.dtype) * vs[..., None].to(q.dtype)
    scale = d**-0.5
    k_abs = torch.arange(kv_len, device=q.device)[None, None, :]
    visible = k_abs <= positions[:, :, None]  # [S, T_step, K]
    group = h // kv_heads
    qg = q.reshape(s, t_step, kv_heads, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys) * scale
    logits = torch.where(visible[:, None, None], logits, NEG_INF)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, values)
    return out.reshape(s, t_step, h, d)


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token decode attention, ``q`` [S, 1, H, D] -> [S, 1, H, D].

    CUDA tensors launch the kernel (and count the launch in
    ``_build.LAUNCHES``); CPU tensors run :func:`paged_attention_reference`.
    Shapes are as in the reference; the pools are only read."""
    if q.dim() != 4:
        raise ValueError(f"q must be [S, T_step, H, D], got {tuple(q.shape)}")
    s, t_step, h, d = q.shape
    kv_heads = k_pool.shape[2]
    if h % kv_heads:
        raise ValueError(f"query heads {h} not divisible by kv heads {kv_heads}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, seq_lens,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got {q.device}")
    if t_step != 1:
        raise ValueError(
            f"the CUDA paged-decode kernel takes one query per row, got "
            f"T_step={t_step} (prefill chunks use the model's gather path)"
        )
    return _launch(
        q.reshape(s, h, d), k_pool, v_pool, block_tables, seq_lens,
        k_scale, v_scale,
    ).reshape(s, 1, h, d)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _launch(q3, k_pool, v_pool, block_tables, seq_lens, k_scale, v_scale):
    """Validate everything the kernel assumes, then launch it on the
    current stream into a fresh output."""
    s, h, d = q3.shape
    num_pages, page, kv_heads, d_pool = k_pool.shape
    quantized = k_scale is not None
    tensors = [q3, k_pool, v_pool, block_tables, seq_lens]
    if quantized:
        tensors += [k_scale, v_scale]
    _check(
        all(t.device == q3.device for t in tensors),
        "all operands must be on one CUDA device",
    )
    _check(all(t.is_contiguous() for t in tensors), "operands must be contiguous")
    _check(q3.dtype in DTYPE_CODES, f"q dtype {q3.dtype} not in float32/bfloat16")
    _check(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _check(d_pool == d and tuple(v_pool.shape) == tuple(k_pool.shape),
           f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs head dim {d}")
    if quantized:
        _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
               "scaled pools must be int8")
        for sc in (k_scale, v_scale):
            _check(sc.dtype == torch.float32
                   and tuple(sc.shape) == (num_pages, page, kv_heads),
                   "scale pools must be float32 [num_pages, page_size, Hkv]")
    else:
        _check(k_pool.dtype == q3.dtype and v_pool.dtype == q3.dtype,
               f"pool dtype {k_pool.dtype} must match q dtype {q3.dtype}")
    _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
           and block_tables.shape[0] == s, "block_tables must be int32 [S, pages_per_seq]")
    _check(seq_lens.dtype == torch.int32 and tuple(seq_lens.shape) == (s,),
           "seq_lens must be int32 [S]")
    group = h // kv_heads
    smem = 4 * (2 * group * d + 2 * page * d + group * page + 3 * group)
    _check(smem <= _MAX_SMEM_BYTES, f"needs {smem} B of shared memory per block")

    out = torch.empty_like(q3)
    if s == 0:
        return out
    null = ctypes.c_void_p(0)
    _build.launch(
        KERNEL, _kernel_lib().paged_attention_decode, q3.device,
        q3.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else null,
        v_scale.data_ptr() if quantized else null,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        s, h, kv_heads, d, page, block_tables.shape[1], d**-0.5,
        DTYPE_CODES[q3.dtype], int(quantized),
    )
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [i] * 6 + [ctypes.c_float, i, i, vp]
        fn.restype = ctypes.c_int
    return lib

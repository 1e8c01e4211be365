"""Decoder-only TransformerLM: the paged serving path and the training path.

The port of ``distributed_pytorch_tpu/models/transformer.py`` as far as the
paged serving engine and the single-device trainer run it:
:func:`apply_rope`, :class:`Attention` (its paged branch writes this step's
K/V into the page pools, then attends through the inline gather math or,
for single-token decode steps, the paged-decode kernel K4; without a cache
it is the full causal forward through the flash-attention kernels K1-K3),
:class:`MLPBlock`, :class:`TransformerBlock` and :class:`TransformerLM`
with its float32 LM head (or, with ``tie_embeddings``, the transposed
token embedding).

Numerics follow the JAX module: matmuls and the embedding run in the
compute ``dtype``, LayerNorms (epsilon 1e-6) and the LM head in float32,
GELU is the tanh approximation, RoPE uses the split-half layout with
float32 angles, and the residual stream stays in the compute dtype.
Parameters are held in ``param_dtype``. flax keeps float32 params and
casts them to ``dtype`` at every call; training does the same here
(``param_dtype=torch.float32``), so the optimizer updates float32 weights.
``param_dtype`` defaults to ``dtype``, the serving choice: casting once at
load gives the same numbers as casting every call, and a decode step then
reads bf16 weights.

Unlike the JAX module, whose cache collection is returned fresh from every
apply, the page pools here are tensors the caller owns and the forward
updates them in place (``index_put_``). :meth:`TransformerLM.init_paged_cache`
makes them.

Left for later slices, and refused by the constructor: dropout, remat,
mixture-of-experts MLPs, the fused cross-entropy head and sequence
parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_tpu_torch.ops.attention import NEG_INF
from distributed_pytorch_tpu_torch.ops.flash_attention import flash_attention
from distributed_pytorch_tpu_torch.ops.paged_attention import paged_attention
from distributed_pytorch_tpu_torch.ops.quant import quantize_int8


def apply_rope(
    x: torch.Tensor,
    *,
    theta: float = 10000.0,
    positions: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Rotary position embedding over [B, T, H, D], split-half layout.

    ``positions`` is [T] (shared by every row) or [B, T] (each row at its
    own absolute offset, the continuous-batching case); it defaults to
    0..T-1. Angles are float32, positions are divided by ``scale`` (linear
    interpolation), and the result is cast back to ``x``'s dtype."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, d_half, dtype=torch.float32, device=x.device) / d_half
    )
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    positions = positions.to(torch.float32)
    if scale != 1.0:
        positions = positions / scale
    angles = positions[..., :, None] * freqs  # [T, D/2] or [B, T, D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :d_half], x[..., d_half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` holding its weights in ``param_dtype`` and computing in
    ``dtype``: input, weight and bias are cast at every call, as flax's
    ``Dense`` promotes its params. With the two dtypes equal it is
    ``nn.Linear``."""

    def __init__(self, in_features, out_features, *, dtype, param_dtype, device=None):
        super().__init__(in_features, out_features, dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


@dataclasses.dataclass
class PagedKV:
    """One attention layer's page pools (names as in the JAX cache
    collection). ``cached_key``/``cached_value`` are
    ``[num_pages, page_size, Hkv, D]`` in the compute dtype, or int8 with
    ``key_scale``/``value_scale`` ``[num_pages, page_size, Hkv]`` float32.
    Zero-initialised: inactive slots read key 0 of the NULL page 0, which
    must hold finite values."""

    cached_key: torch.Tensor
    cached_value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    def tensors(self) -> List[torch.Tensor]:
        out = [self.cached_key, self.cached_value]
        if self.key_scale is not None:
            out += [self.key_scale, self.value_scale]
        return out


class Attention(nn.Module):
    """Multi-head causal attention with RoPE, over the paged KV cache or
    (without one) the whole sequence.

    ``query``/``key``/``value`` are the flax ``DenseGeneral`` kernels
    ``[d_model, heads, head_dim]`` flattened to ``nn.Linear``; ``out``
    contracts ``[H, head_dim]`` back to ``d_model``. ``n_kv_heads`` > 0 is
    grouped-query attention: query head ``h`` reads kv head ``h // group``.
    ``window`` > 0 is sliding-window attention (training path only, as in
    the JAX module)."""

    def __init__(
        self,
        n_heads: int,
        d_model: int,
        *,
        n_kv_heads: int = 0,
        window: int = 0,
        rope_scale: float = 1.0,
        rope_theta: float = 10000.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.kv_heads = n_kv_heads or n_heads
        if n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {n_heads} not divisible by n_kv_heads {self.kv_heads}"
            )
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self.window = window
        self.rope_scale = rope_scale
        self.rope_theta = rope_theta
        self.dtype = dtype
        fk = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.query = Linear(d_model, n_heads * self.head_dim, **fk)
        self.key = Linear(d_model, self.kv_heads * self.head_dim, **fk)
        self.value = Linear(d_model, self.kv_heads * self.head_dim, **fk)
        self.out = Linear(n_heads * self.head_dim, d_model, **fk)

    def forward(
        self,
        x: torch.Tensor,
        cache: Optional[PagedKV] = None,
        block_tables: Optional[torch.Tensor] = None,
        seq_lens: Optional[torch.Tensor] = None,
        paged_kernel: bool = False,
    ) -> torch.Tensor:
        """Without ``cache``: the full causal forward over ``x`` [B, T,
        d_model] (RoPE at positions 0..T-1, flash attention). With it: one
        decode step (T_step == 1) or prefill chunk over ``x`` [S, T_step,
        d_model]: RoPE at absolute positions ``seq_lens + i``, write K/V
        into the pools, then attend. ``paged_kernel`` sends single-token
        steps through :func:`paged_attention`."""
        if cache is None:
            return self._forward_full(x)
        if self.window:
            raise ValueError(
                "paged decode does not compose with sliding-window attention "
                "yet (as in the JAX module)"
            )
        s, t_step, _ = x.shape
        x = x.to(self.dtype)
        q_raw = self.query(x).view(s, t_step, self.n_heads, self.head_dim)
        k_raw = self.key(x).view(s, t_step, self.kv_heads, self.head_dim)
        v = self.value(x).view(s, t_step, self.kv_heads, self.head_dim)
        positions = seq_lens.long()[:, None] + torch.arange(t_step, device=x.device)
        q = apply_rope(
            q_raw, positions=positions, theta=self.rope_theta, scale=self.rope_scale
        )
        k = apply_rope(
            k_raw, positions=positions, theta=self.rope_theta, scale=self.rope_scale
        )
        self._write(cache, k, v, block_tables, positions)
        if paged_kernel and t_step == 1:
            out = paged_attention(
                q, cache.cached_key, cache.cached_value, block_tables, seq_lens,
                k_scale=cache.key_scale, v_scale=cache.value_scale,
            )
        else:
            out = self._attend_gathered(q, cache, block_tables, positions)
        return self.out(out.reshape(s, t_step, self.n_heads * self.head_dim))

    def _forward_full(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward: causal (optionally banded) attention of
        every position over its prefix, through :func:`flash_attention`.
        GQA repeats each kv head over its query group first (the
        reference's ``jnp.repeat(k, group, axis=2)``); autograd sums the
        gradients of the copies."""
        b, t, _ = x.shape
        x = x.to(self.dtype)
        q_raw = self.query(x).view(b, t, self.n_heads, self.head_dim)
        k_raw = self.key(x).view(b, t, self.kv_heads, self.head_dim)
        v = self.value(x).view(b, t, self.kv_heads, self.head_dim)
        q = apply_rope(q_raw, theta=self.rope_theta, scale=self.rope_scale)
        k = apply_rope(k_raw, theta=self.rope_theta, scale=self.rope_scale)
        if self.kv_heads != self.n_heads:
            group = self.n_heads // self.kv_heads
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        out = flash_attention(q, k, v, causal=True, window=self.window)
        return self.out(out.reshape(b, t, self.n_heads * self.head_dim))

    def _write(self, cache, k, v, block_tables, positions) -> None:
        """Scatter this step's K/V into (physical page, in-page offset).
        Positions at or past the table's capacity go to the NULL page 0,
        like inactive rows' writes, instead of aliasing the row's last
        page; the visibility mask keeps them dead on every read."""
        s, t_step, kv_heads, d = k.shape
        page = cache.cached_key.shape[1]
        pages_per_seq = block_tables.shape[1]
        flat_pos = positions.reshape(-1)
        logical = torch.clamp(flat_pos // page, 0, pages_per_seq - 1)
        rows = torch.arange(s, device=k.device).repeat_interleave(t_step)
        phys = block_tables.long()[rows, logical]
        phys = torch.where(flat_pos < pages_per_seq * page, phys, 0)
        offset = flat_pos % page
        if cache.key_scale is not None:
            for pool, scales, x in (
                (cache.cached_key, cache.key_scale, k),
                (cache.cached_value, cache.value_scale, v),
            ):
                qt = quantize_int8(x.reshape(-1, kv_heads, d), (2,))
                pool[phys, offset] = qt.q
                scales[phys, offset] = qt.scale.squeeze(-1)
        else:
            pool_dtype = cache.cached_key.dtype
            cache.cached_key[phys, offset] = k.reshape(-1, kv_heads, d).to(pool_dtype)
            cache.cached_value[phys, offset] = v.reshape(-1, kv_heads, d).to(pool_dtype)

    def _attend_gathered(self, q, cache, block_tables, positions) -> torch.Tensor:
        """The inline read path: gather each row's pages into its logical
        [S, pages_per_seq * page_size, Hkv, D] view, mask positionally,
        grouped einsums in q's dtype, fp32 softmax."""
        s, t_step, h, d = q.shape
        kv_heads = cache.cached_key.shape[2]
        kv_len = block_tables.shape[1] * cache.cached_key.shape[1]
        tables = block_tables.long()
        keys = cache.cached_key[tables].reshape(s, kv_len, kv_heads, d)
        values = cache.cached_value[tables].reshape(s, kv_len, kv_heads, d)
        if cache.key_scale is not None:
            ks = cache.key_scale[tables].reshape(s, kv_len, kv_heads)
            vs = cache.value_scale[tables].reshape(s, kv_len, kv_heads)
            keys = keys.to(q.dtype) * ks[..., None].to(q.dtype)
            values = values.to(q.dtype) * vs[..., None].to(q.dtype)
        k_abs = torch.arange(kv_len, device=q.device)[None, None, :]
        visible = k_abs <= positions[:, :, None]  # [S, T_step, K]
        group = h // kv_heads
        qg = q.reshape(s, t_step, kv_heads, group, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys) * d**-0.5
        logits = torch.where(visible[:, None, None], logits, NEG_INF)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", weights, values)
        return out.reshape(s, t_step, h, d)


class MLPBlock(nn.Module):
    def __init__(
        self, d_ff: int, d_model: int, *, dtype=torch.float32, param_dtype=None,
        device=None,
    ):
        super().__init__()
        fk = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.up = Linear(d_model, d_ff, **fk)
        self.down = Linear(d_ff, d_model, **fk)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.up(x.to(self.dtype)), approximate="tanh")
        return self.down(h)


def _layer_norm(d_model: int, device) -> nn.LayerNorm:
    # flax LayerNorm: epsilon 1e-6, float32 params and statistics.
    return nn.LayerNorm(d_model, eps=1e-6, dtype=torch.float32, device=device)


class TransformerBlock(nn.Module):
    def __init__(
        self,
        n_heads: int,
        d_model: int,
        d_ff: int,
        *,
        n_kv_heads: int = 0,
        window: int = 0,
        rope_scale: float = 1.0,
        rope_theta: float = 10000.0,
        dtype=torch.float32,
        param_dtype=None,
        device=None,
    ):
        super().__init__()
        self.ln_attn = _layer_norm(d_model, device)
        self.attention = Attention(
            n_heads, d_model, n_kv_heads=n_kv_heads, window=window,
            rope_scale=rope_scale, rope_theta=rope_theta, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )
        self.ln_mlp = _layer_norm(d_model, device)
        self.mlp = MLPBlock(
            d_ff, d_model, dtype=dtype, param_dtype=param_dtype, device=device
        )

    def forward(self, x, cache=None, block_tables=None, seq_lens=None, paged_kernel=False):
        x = x + self.attention(
            self.ln_attn(x.float()), cache, block_tables, seq_lens, paged_kernel
        )
        return x + self.mlp(self.ln_mlp(x.float()))


class TransformerLM(nn.Module):
    """GPT-style causal LM, token ids [B, T] -> logits [B, T, V] (float32).

    Constructor arguments are the JAX module's (``vocab_size``, ``d_model``,
    ``n_layers``, ``n_heads``, ``d_ff``, ``dtype``, ``n_kv_heads``,
    ``attention_window``, ``tie_embeddings``, ``rope_scale``,
    ``rope_theta``) plus ``param_dtype`` (see the module docstring) and
    ``device``. ``dropout_rate``, ``remat``, ``n_experts`` and
    ``fused_head_chunk`` are accepted only at their off values: those
    options arrive with later slices of the port."""

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 512,
        n_layers: int = 6,
        n_heads: int = 8,
        d_ff: int = 2048,
        *,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        n_kv_heads: int = 0,
        attention_window: int = 0,
        tie_embeddings: bool = False,
        rope_scale: float = 1.0,
        rope_theta: float = 10000.0,
        dropout_rate: float = 0.0,
        remat: bool = False,
        n_experts: int = 0,
        fused_head_chunk: int = 0,
        device=None,
    ):
        super().__init__()
        later = {
            "dropout_rate": (dropout_rate, "the training-regularisation slice"),
            "remat": (remat, "the training-regularisation slice"),
            "n_experts": (n_experts, "the parallelism slice (MoE/EP)"),
            "fused_head_chunk": (fused_head_chunk, "the fused cross-entropy head slice"),
        }
        for name, (value, slice_name) in later.items():
            if value:
                raise NotImplementedError(
                    f"TransformerLM({name}={value!r}) is not ported yet; it "
                    f"arrives with {slice_name} (ROADMAP.md Queue 1)"
                )
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = d_model // n_heads
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.attention_window = attention_window
        self.tie_embeddings = tie_embeddings
        self.embed = nn.Embedding(
            vocab_size, d_model, dtype=self.param_dtype, device=device
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(
                n_heads, d_model, d_ff, n_kv_heads=n_kv_heads,
                window=attention_window, rope_scale=rope_scale,
                rope_theta=rope_theta, dtype=dtype, param_dtype=self.param_dtype,
                device=device,
            )
            for _ in range(n_layers)
        )
        self.ln_final = _layer_norm(d_model, device)
        # Logits in float32 for a numerically stable softmax. Tied: the
        # head is the transposed token embedding in float32, no bias.
        self.lm_head = None if tie_embeddings else nn.Linear(
            d_model, vocab_size, dtype=torch.float32, device=device
        )

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # Gathering then casting is flax's cast-then-gather, row for row.
        return self.embed(tokens.long()).to(self.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_final(x.float())
        if self.lm_head is None:
            return x @ self.embed.weight.float().t()
        return self.lm_head(x)

    def init_paged_cache(
        self,
        num_pages: int,
        page_size: int,
        kv_quant: Optional[str] = None,
        device=None,
    ) -> List[PagedKV]:
        """Zero-initialised page pools for every layer (page 0 is the NULL
        page). ``kv_quant="int8"`` makes int8 pools with float32 scales;
        None or "" makes pools in the compute dtype."""
        if num_pages < 2:
            raise ValueError(
                f"paged decode needs num_pages >= 2 (page 0 is the reserved "
                f"null page), got {num_pages}"
            )
        if kv_quant not in (None, "", "int8"):
            raise ValueError(
                f"unknown kv_quant {kv_quant!r} (expected None, '' or 'int8')"
            )
        shape = (num_pages, page_size, self.n_kv_heads, self.head_dim)
        dtype = torch.int8 if kv_quant else self.dtype

        def layer() -> PagedKV:
            pools = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
            scales = (
                [torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                 for _ in range(2)]
                if kv_quant else [None, None]
            )
            return PagedKV(*pools, *scales)

        return [layer() for _ in range(self.n_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        cache: Optional[List[PagedKV]] = None,
        block_tables: Optional[torch.Tensor] = None,
        seq_lens: Optional[torch.Tensor] = None,
        paged_kernel: bool = False,
        logits: Optional[str] = "all",
    ) -> Optional[torch.Tensor]:
        """Without ``cache``: the full causal forward over ``tokens`` [B, T]
        (the training path; attention through the flash kernels), returning
        float32 logits [B, T, V].

        With ``cache``, ``block_tables`` and ``seq_lens``: one paged step
        over ``tokens`` [S, T_step], writing every layer's K/V into
        ``cache`` (in place) at positions ``seq_lens + i``. ``logits``:
        ``"all"`` -> [S, T_step, V] float32, ``"last"`` -> [S, V] at the
        final position, ``None`` -> no LM head (a prefill chunk that only
        fills the cache)."""
        if logits not in ("all", "last", None):
            raise ValueError(f"logits must be 'all', 'last' or None, got {logits!r}")
        if cache is None:
            if block_tables is not None or seq_lens is not None:
                raise ValueError("block_tables/seq_lens need a paged cache")
            x = self._embed(tokens)
            for block in self.blocks:
                x = block(x)
        else:
            if block_tables is None or seq_lens is None:
                raise ValueError("a paged step needs block_tables and seq_lens")
            if len(cache) != self.n_layers:
                raise ValueError(
                    f"cache has {len(cache)} layers, model has {self.n_layers}"
                )
            x = self._embed(tokens)
            for block, layer_cache in zip(self.blocks, cache):
                x = block(x, layer_cache, block_tables, seq_lens, paged_kernel)
        if logits is None:
            return None
        if logits == "last":
            x = x[:, -1]
        return self._head(x)


def init_random_(model: TransformerLM, seed: int) -> TransformerLM:
    """Fill ``model`` in place with seeded random weights, drawn on the
    model's own device: flax's defaults (lecun-normal kernels, unit-variance
    normal embedding, zero biases, unit LayerNorm scales)."""
    device = model.embed.weight.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            elif name == "embed.weight":
                p.normal_(0.0, 1.0, generator=gen)
            else:  # nn.Linear weight [out, in]: fan-in is dim 1
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
    return model


def params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``TransformerLM``'s params tree (numpy or jax arrays) as a
    state dict for the port's :class:`TransformerLM` (float32; ``load_state_dict``
    casts to ``param_dtype``; a tied model's tree has no ``lm_head``, and
    neither has the state dict). Layouts: ``DenseGeneral`` kernels
    ``[d_model, H, Dh]`` -> ``Linear.weight [H*Dh, d_model]``; the attention
    ``out`` kernel ``[H, Dh, d_model]`` -> ``[d_model, H*Dh]``; ``Dense``
    kernels ``[in, out]`` -> their transpose; LayerNorm ``scale`` ->
    ``weight``."""

    def arr(x) -> np.ndarray:
        return np.array(x, dtype=np.float32)

    def linear(prefix: str, kernel, bias, n_in_dims: int = 1) -> None:
        k = arr(kernel)
        rows = int(np.prod(k.shape[:n_in_dims]))
        sd[f"{prefix}.weight"] = k.reshape(rows, -1).T
        sd[f"{prefix}.bias"] = arr(bias).reshape(-1)

    def norm(prefix: str, tree) -> None:
        sd[f"{prefix}.weight"] = arr(tree["scale"])
        sd[f"{prefix}.bias"] = arr(tree["bias"])

    sd: Dict[str, np.ndarray] = {"embed.weight": arr(flax_params["embed"]["embedding"])}
    i = 0
    while f"block_{i}" in flax_params:
        block = flax_params[f"block_{i}"]
        if "mlp" not in block:
            raise NotImplementedError("MoE blocks arrive with a later slice")
        pre = f"blocks.{i}"
        norm(f"{pre}.ln_attn", block["ln_attn"])
        norm(f"{pre}.ln_mlp", block["ln_mlp"])
        att = block["attention"]
        for name in ("query", "key", "value"):
            linear(f"{pre}.attention.{name}", att[name]["kernel"], att[name]["bias"])
        linear(f"{pre}.attention.out", att["out"]["kernel"], att["out"]["bias"], 2)
        for name in ("up", "down"):
            mlp = block["mlp"][name]
            linear(f"{pre}.mlp.{name}", mlp["kernel"], mlp["bias"])
        i += 1
    norm("ln_final", flax_params["ln_final"])
    if "lm_head" in flax_params:  # absent under tie_embeddings
        linear("lm_head", flax_params["lm_head"]["kernel"], flax_params["lm_head"]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

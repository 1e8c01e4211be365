"""The port's serving TransformerLM against the JAX module.

Weights come from the JAX module's seeded init and cross with
``params_from_jax``; token inputs are numpy-seeded. A paged prefill chunk
and the decode steps after it must give the JAX ``decode_token_step``
path's logits (float32, 1e-5: sums run in another order) and write the same
pools (int8 values within 1 LSB where a rounding tie falls differently);
prefill then decode in the port must give the JAX model's full causal
forward (float32, 1e-4: a different attention algorithm on that side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.generation import decode_token_step as jax_decode_step
from distributed_pytorch_tpu.models.transformer import (
    TransformerLM as JaxLM,
    apply_rope as jax_apply_rope,
)
from distributed_pytorch_tpu_torch.generation import decode_token_step
from distributed_pytorch_tpu_torch.models.transformer import (
    TransformerLM,
    apply_rope,
    init_random_,
    params_from_jax,
)

CFG = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64)
PAGE = 4
NUM_PAGES = 10
TABLES = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here gain nothing from intra-op threads; one thread keeps
    this module from crowding the CPU that the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def build(n_kv_heads=0):
    jm = JaxLM(**CFG, dtype=jnp.float32, n_kv_heads=n_kv_heads)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(**CFG, n_kv_heads=n_kv_heads)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module", params=[0, 2], ids=["mha", "gqa"])
def models(request):
    return build(request.param)


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape).astype(np.int32)


def port_step(tm, cache, toks, lens, kernel, logits="all"):
    with torch.no_grad():
        return tm(
            torch.from_numpy(toks), cache=cache,
            block_tables=torch.from_numpy(TABLES), seq_lens=torch.from_numpy(lens),
            paged_kernel=kernel, logits=logits,
        )


def test_params_from_jax_loads_strictly(models):
    _, params, tm = models
    sd = params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("scale,theta", [(1.0, 10000.0), (2.0, 500.0)])
def test_apply_rope_matches_jax(shared, scale, theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = (np.arange(5) + 7) if shared else rng.integers(0, 100, (2, 5))
    ref = jax_apply_rope(jnp.asarray(x), positions=jnp.asarray(pos), scale=scale, theta=theta)
    out = apply_rope(torch.from_numpy(x), positions=torch.from_numpy(pos), scale=scale, theta=theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("kernel", [False, True])
def test_paged_steps_match_jax(models, kv_quant, kernel):
    """A 5-token prefill chunk for two rows, then four batched decode
    steps: logits and every layer's pools agree with the JAX paged path
    (which runs its Pallas kernel through the interpreter when ``kernel``)."""
    jm, params, tm = models
    dm = jm.clone(
        decode=True, page_size=PAGE, num_pages=NUM_PAGES, kv_quant=kv_quant,
        paged_kernel="interpret" if kernel else "",
    )
    jcache = jax.jit(dm.init)(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32))["cache"]
    jax_step = jax.jit(
        lambda c, cur, lens: jax_decode_step(
            dm, params, c, cur, block_tables=jnp.asarray(TABLES), seq_lens=lens
        )
    )
    cache = tm.init_paged_cache(NUM_PAGES, PAGE, kv_quant, device="cpu")
    toks = tokens(1, (2, 9))
    for start, n in [(0, 5), (5, 1), (6, 1), (7, 1)]:
        lens = np.full((2,), start, np.int32)
        cur = toks[:, start : start + n]
        jlogits, jcache = jax_step(jcache, jnp.asarray(cur), jnp.asarray(lens))
        if n == 1:
            logits = decode_token_step(
                tm, cache, torch.from_numpy(cur),
                block_tables=torch.from_numpy(TABLES),
                seq_lens=torch.from_numpy(lens), paged_kernel=kernel,
            )
        else:
            logits = port_step(tm, cache, cur, lens, kernel, logits="last")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    for i, layer in enumerate(cache):
        ref = jcache[f"block_{i}"]["attention"]
        for name in ("cached_key", "cached_value"):
            ours = getattr(layer, name).numpy()
            theirs = np.asarray(ref[name])
            if kv_quant:
                assert ours.dtype == np.int8
                assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)
        if kv_quant:
            for name in ("key_scale", "value_scale"):
                np.testing.assert_allclose(
                    getattr(layer, name).numpy(), np.asarray(ref[name]), atol=1e-7, rtol=1e-5
                )


@pytest.mark.parametrize("prefill", [1, 4, 7])
def test_prefill_then_decode_matches_full_forward(models, prefill):
    """Chunked prefill (all positions' logits) then one-token decode steps
    reproduce the JAX model's full causal forward over the whole row."""
    jm, params, tm = models
    toks = tokens(2, (2, 10))
    full = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(toks)))
    cache = tm.init_paged_cache(NUM_PAGES, PAGE, device="cpu")
    got = [port_step(tm, cache, toks[:, :prefill], np.zeros(2, np.int32), False).numpy()]
    for t in range(prefill, toks.shape[1]):
        got.append(port_step(tm, cache, toks[:, t : t + 1], np.full(2, t, np.int32), True).numpy())
    np.testing.assert_allclose(np.concatenate(got, axis=1), full, atol=1e-4, rtol=1e-4)


def test_full_causal_forward_is_refused_until_k1():
    """K1 is ported: the full causal forward, refused until then, runs the
    flash-attention path (on the CPU, K1's plain version) and gives the JAX
    model's logits (float32, 1e-4); options of later slices stay refused."""
    jm, params, tm = build()
    toks = tokens(6, (2, 9))
    full = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, full, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="fused cross-entropy"):
        TransformerLM(**CFG, fused_head_chunk=32)


def test_write_past_table_capacity_goes_to_null_page(models):
    """A position at or past pages_per_seq * page_size is routed to page
    0 instead of clobbering the row's last page."""
    _, _, tm = models
    cache = tm.init_paged_cache(NUM_PAGES, PAGE, device="cpu")
    table = np.asarray([[1, 2]], np.int32)
    with torch.no_grad():
        tm(
            torch.from_numpy(tokens(4, (1, 3))), cache=cache,
            block_tables=torch.from_numpy(table),
            seq_lens=torch.from_numpy(np.asarray([7], np.int32)), logits=None,
        )
    key = cache[0].cached_key
    assert key[2, 3].abs().sum() > 0  # position 7: last slot of page 2
    assert key[1].abs().sum() == 0  # positions 8, 9 never alias page 1...
    assert key[2, :3].abs().sum() == 0  # ...nor page 2's earlier slots
    assert key[0].abs().sum() > 0  # they land on the NULL page


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_init_paged_cache_layout(kv_quant):
    tm = TransformerLM(**CFG, n_kv_heads=2, dtype=torch.bfloat16)
    cache = tm.init_paged_cache(5, PAGE, kv_quant, device="cpu")
    assert len(cache) == CFG["n_layers"]
    layer = cache[0]
    assert layer.cached_key.shape == (5, PAGE, 2, 8)
    assert layer.cached_key.dtype == (torch.int8 if kv_quant else torch.bfloat16)
    assert all(t.abs().sum() == 0 for t in layer.tensors())
    assert (layer.key_scale is not None) == bool(kv_quant)
    with pytest.raises(ValueError, match="null page"):
        tm.init_paged_cache(1, PAGE)


def test_bf16_model_holds_matmul_weights_in_bf16_and_head_in_fp32(models):
    """Compute dtype bf16: matmul weights and the embedding are cast once
    at load, LayerNorms and the LM head stay float32, and a decode step's
    logits track the float32 model to bf16 precision."""
    jm, params, tm32 = models
    tm = TransformerLM(**CFG, n_kv_heads=jm.n_kv_heads, dtype=torch.bfloat16)
    tm.load_state_dict(params_from_jax(params))
    assert tm.blocks[0].attention.query.weight.dtype == torch.bfloat16
    assert tm.embed.weight.dtype == torch.bfloat16
    assert tm.lm_head.weight.dtype == torch.float32
    assert tm.ln_final.weight.dtype == torch.float32
    toks = tokens(5, (2, 6))
    out = {}
    for name, m in (("bf16", tm), ("fp32", tm32)):
        cache = m.init_paged_cache(NUM_PAGES, PAGE, device="cpu")
        port_step(m, cache, toks[:, :5], np.zeros(2, np.int32), False)
        out[name] = port_step(m, cache, toks[:, 5:], np.full(2, 5, np.int32), True, "last")
    assert out["bf16"].dtype == torch.float32
    np.testing.assert_allclose(out["bf16"].numpy(), out["fp32"].numpy(), atol=0.1)


def test_init_random_is_seeded():
    a = init_random_(TransformerLM(**CFG), seed=7).state_dict()
    b = init_random_(TransformerLM(**CFG), seed=7).state_dict()
    c = init_random_(TransformerLM(**CFG), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert torch.equal(a["ln_final.weight"], torch.ones(CFG["d_model"]))

"""The port's serving engine against the JAX ``InferenceEngine``.

Greedy tokens must be identical to the JAX engine on the same weights and
prompts across ``prefix_cache x overlap``, under forced preemption (small
``num_pages``) and with copy-on-write of shared partial pages. Inside the
port: a request's sampled stream does not depend on what shares its batch
or on preemption, pages never leak, the package imports nothing of JAX, it
refuses to start without a card unless asked for the CPU, and on the CPU
its kernel wrapper launches nothing.

The JAX engine refills numpy staging buffers in place after each dispatch;
on the CPU backend ``jnp.asarray`` may alias such a buffer instead of
copying it, and with async dispatch a later refill can race the program
still reading it (ROADMAP.md, Queue 3). The fixture below has the JAX
engine's module copy its staged inputs, which removes the race without
changing its math.
"""

import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu.serving.engine as jax_engine_module
from distributed_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from distributed_pytorch_tpu.serving import (
    InferenceEngine as JaxEngine,
    SamplingParams as JaxSamplingParams,
)
from distributed_pytorch_tpu_torch.models.transformer import TransformerLM, params_from_jax
from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops.paged_attention import KERNEL
from distributed_pytorch_tpu_torch.serving import (
    InferenceEngine,
    RequestTooLong,
    SamplingParams,
)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
ENGINE_KW = dict(
    max_slots=3, max_seq_len=32, page_size=4, token_budget=16, max_prefill_chunk=8
)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here gain nothing from intra-op threads; one thread keeps
    this module from crowding the CPU that the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _prompts():
    """Five prompts: four share a 6-token prefix (one full page and a
    partial page at page size 4), one does not."""
    rng = np.random.default_rng(1)
    shared = rng.integers(1, 64, 6).tolist()
    out = [shared + rng.integers(1, 64, n).tolist() for n in (1, 3, 5, 2)]
    return out + [rng.integers(1, 64, 7).tolist()]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def jax_staging_copies():
    shim = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}
    )
    shim.asarray = lambda x, *a, **k: jnp.array(np.array(x, copy=True), *a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine_module, "jnp", shim)
        yield


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(**CFG)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def run_jax(models, prompts, **kw):
    jm, params, _ = models
    eng = JaxEngine(jm, params, **{**ENGINE_KW, **kw})
    ids = [eng.submit(p, JaxSamplingParams(max_new_tokens=MAX_NEW)) for p in prompts]
    eng.run()
    out = [eng.poll(i).generated for i in ids]
    stats = eng.stats()
    eng.close()
    return out, stats


def run_port(models, prompts, params=None, **kw):
    eng = InferenceEngine(models[2], device="cpu", debug=True, **{**ENGINE_KW, **kw})
    params = params or SamplingParams(max_new_tokens=MAX_NEW)
    ids = [eng.submit(p, params) for p in prompts]
    eng.run()
    out = [eng.poll(i).generated for i in ids]
    stats = eng.stats()
    eng.close()
    return out, stats


@pytest.fixture(scope="module")
def jax_greedy(models, jax_staging_copies):
    return run_jax(models, PROMPTS)[0]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_greedy_tokens_match_jax_engine(models, jax_staging_copies, jax_greedy,
                                        prefix_cache, overlap):
    ref, _ = run_jax(models, PROMPTS, prefix_cache=prefix_cache, overlap=overlap)
    assert ref == jax_greedy  # the JAX engine agrees with itself
    out, stats = run_port(models, PROMPTS, prefix_cache=prefix_cache, overlap=overlap)
    assert out == ref
    assert stats["requests_completed"] == len(PROMPTS)
    if prefix_cache:
        assert stats["prefix_tokens_hit"] > 0


@pytest.mark.parametrize("overlap", [True, False])
def test_greedy_tokens_match_jax_under_preemption(models, jax_greedy, overlap):
    """Nine allocatable pages for three slots of up to eight pages each:
    requests are preempted and re-prefilled, and the tokens are still the
    JAX engine's (which gives the same tokens with or without preemption)."""
    out, stats = run_port(models, PROMPTS, num_pages=10, overlap=overlap)
    assert stats["preemptions"] > 0
    assert out == jax_greedy


def test_copy_on_write_of_shared_partial_page(models, jax_staging_copies):
    """A retired request registers its partial last page (its last two
    prompt tokens and its first generated one, at page size 4); two later
    requests that extend that prefix share the page and copy it before
    writing."""
    base = PROMPTS[0][:6]
    jm, params, tm = models
    engines = (
        (JaxEngine(jm, params, **ENGINE_KW), JaxSamplingParams(max_new_tokens=2)),
        (InferenceEngine(tm, device="cpu", debug=True, **ENGINE_KW),
         SamplingParams(max_new_tokens=2)),
    )
    results = []
    for eng, sp in engines:
        ids = [eng.submit(base, sp)]
        eng.run()
        prefix = base + eng.poll(ids[0]).generated[:1]
        ids += [eng.submit(prefix + tail, sp) for tail in ([7, 8, 9], [10, 11])]
        eng.run()
        results.append(([eng.poll(i).generated for i in ids], eng.stats()["cow_copies"]))
        eng.close()
    (ref, jax_cow), (got, cow) = results
    assert got == ref
    assert cow == jax_cow > 0


def test_int8_pages_match_jax_engine(models, jax_staging_copies):
    ref, _ = run_jax(models, PROMPTS, kv_quant="int8")
    out, _ = run_port(models, PROMPTS, kv_quant="int8")
    assert out == ref


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kernel_flag_on_cpu_is_token_identical_and_launches_nothing(models, kv_quant):
    before = _build.LAUNCHES[KERNEL]
    plain, _ = run_port(models, PROMPTS, kv_quant=kv_quant)
    kernel, stats = run_port(models, PROMPTS, kv_quant=kv_quant, paged_kernel=True)
    assert kernel == plain
    assert stats["decode_steps"] > 0
    assert _build.LAUNCHES[KERNEL] == before


SAMPLED = SamplingParams(max_new_tokens=MAX_NEW, temperature=1.0, seed=11)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (8, 0.0), (0, 0.9)])
def test_sampled_stream_is_independent_of_batch(models, top_k, top_p):
    alone, _ = run_port(models, PROMPTS[:1], params=SAMPLED, top_k=top_k, top_p=top_p)
    crowd, _ = run_port(models, PROMPTS, params=SAMPLED, top_k=top_k, top_p=top_p)
    assert crowd[0] == alone[0]
    # Same seed and prompt in one batch: same stream.
    twins, _ = run_port(models, [PROMPTS[0]] * 3, params=SAMPLED, top_k=top_k, top_p=top_p)
    assert twins == [alone[0]] * 3


def test_sampled_stream_survives_preemption_and_overlap(models):
    ref, _ = run_port(models, PROMPTS, params=SAMPLED)
    preempted, stats = run_port(models, PROMPTS, params=SAMPLED, num_pages=10, overlap=False)
    assert stats["preemptions"] > 0
    assert preempted == ref
    other_seed, _ = run_port(
        models, PROMPTS, params=SamplingParams(max_new_tokens=MAX_NEW, temperature=1.0, seed=12)
    )
    assert other_seed != ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_page_leaks_under_random_workload(models, seed):
    """Random prompts and lengths with preemption pressure: every request
    finishes, and at close no page is referenced (close() asserts it)."""
    rng = np.random.default_rng(seed)
    eng = InferenceEngine(models[2], device="cpu", debug=True, **{**ENGINE_KW, "num_pages": 11})
    ids = [
        eng.submit(
            rng.integers(1, 64, int(rng.integers(1, 12))).tolist(),
            SamplingParams(max_new_tokens=int(rng.integers(1, 10))),
        )
        for _ in range(8)
    ]
    eng.run()
    assert all(eng.poll(i).finished for i in ids)
    assert eng.allocator.num_allocated == 0
    eng.allocator.check_invariants()
    eng.close()


def test_admission_refuses_too_long_requests(models):
    eng = InferenceEngine(models[2], device="cpu", **ENGINE_KW)
    with pytest.raises(RequestTooLong):
        eng.submit(list(range(1, 30)), SamplingParams(max_new_tokens=8))
    with pytest.raises(RequestTooLong):
        eng.submit([], SamplingParams())
    eng.close()


def test_engine_without_device_needs_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(models[2], **ENGINE_KW)


def test_import_leaves_jax_out():
    code = (
        "import sys, distributed_pytorch_tpu_torch, "
        "distributed_pytorch_tpu_torch.serving.engine, "
        "distributed_pytorch_tpu_torch.ops._build, "
        "distributed_pytorch_tpu_torch.obs.goodput\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributed_pytorch_tpu')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parent.parent,
    )
    assert result.returncode == 0, result.stdout + result.stderr

"""The port's GPT cache path against the JAX package's.

``gpt_tiny`` (fp32) runs with the flax parameters converted by
``gpt_params_from_jax``; prefill and token-by-token decode logits of the
incremental path must agree with the JAX model's to atol 1e-4 — the
reference's own ``FP32_ATOL`` (``tests/test_serve.py``) — for both cache
kinds. Inputs are seeded numpy arrays handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt as jgpt
from horovod_tpu_torch.models import convert, gpt

FP32_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny_pair():
    jm = jgpt.gpt_tiny()
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))
    np_params = jax.tree.map(np.asarray, params)
    tm = gpt.gpt_tiny()
    tm.load_state_dict(convert.gpt_params_from_jax(np_params))
    return jm, params, tm.eval()


def _jax_incremental(jm, params, toks, kind, prefill_len, max_len):
    cache = jgpt.init_kv_cache(jm, slots=toks.shape[0], max_len=max_len,
                               kind=kind)
    apply = jax.jit(lambda p, t, c: jm.apply(p, t, cache=c))
    lp, cache = apply(params, jnp.asarray(toks[:, :prefill_len]), cache)
    outs = [np.asarray(lp)]
    for t in range(prefill_len, toks.shape[1]):
        lg, cache = apply(params, jnp.asarray(toks[:, t:t + 1]), cache)
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1), cache


def _torch_incremental(tm, toks, kind, prefill_len, max_len):
    cache = gpt.init_kv_cache(tm, slots=toks.shape[0], max_len=max_len,
                              kind=kind, device="cpu")
    tt = torch.from_numpy(toks)
    lp, cache = tm(tt[:, :prefill_len], cache=cache)
    outs = [lp.numpy()]
    for t in range(prefill_len, toks.shape[1]):
        lg, cache = tm(tt[:, t:t + 1], cache=cache)
        outs.append(lg.numpy())
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_cache_path_logits_match_jax(tiny_pair, kind, rng):
    """Prefill 5 tokens, then decode 9 one by one, past a ring wrap of
    the 12-line cache: logits agree to 1e-4 and the caches' bookkeeping
    is identical."""
    jm, params, tm = tiny_pair
    toks = rng.integers(1, 128, (2, 14)).astype(np.int64)
    want, jcache = _jax_incremental(jm, params, toks, kind, 5, 12)
    got, tcache = _torch_incremental(tm, toks, kind, 5, 12)
    assert got.shape == want.shape == (2, 14, 128)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def test_rope_and_cache_attend_match_jax(rng):
    """The two plain building blocks on their own: RoPE at arbitrary
    global positions, and attention over a ring cache with empty and
    causally hidden lines (mask value -1e30, fp32 softmax)."""
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        gpt.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jgpt.rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    q_pos = np.array([[4, 5, 6], [0, 1, 2]], np.int32)
    k_pos = np.array([[0, 1, 2, 3, 4, 5, 6, -1],
                      [0, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    got = gpt._cache_attend(*(torch.from_numpy(a)
                              for a in (q, k, v, q_pos, k_pos)))
    want = jgpt._cache_attend(*(jnp.asarray(a)
                                for a in (q, k, v, q_pos, k_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bf16_geometry_matches_gpt2_medium():
    """``gpt_medium`` is GPT-2 medium's width at bf16 compute over fp32
    parameters, with the flax model's parameter count (built on the meta
    device: no memory)."""
    with torch.device("meta"):
        m = gpt.gpt_medium()
    jm = jgpt.gpt_medium()
    geometry = (24, 1024, 16, 4096, 50257)
    assert (m.num_layers, m.hidden, m.num_heads, m.mlp_dim,
            m.vocab_size) == geometry
    assert (jm.num_layers, jm.hidden, jm.num_heads, jm.mlp_dim,
            jm.vocab_size) == geometry
    assert m.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    h, f, v = 1024, 4096, 50257
    per_layer = 2 * 2 * h + (3 * h * h + 3 * h) + (h * h + h) \
        + (h * f + f) + (f * h + h)
    assert sum(p.numel() for p in m.parameters()) == \
        v * h + 24 * per_layer + 2 * h


def test_converter_covers_every_parameter(tiny_pair):
    _, params, tm = tiny_pair
    sd = convert.gpt_params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(
        sd["layers.0.attn.qkv.weight"].numpy(),
        np.asarray(params["params"]["layer0"]["attn"]["qkv"]["kernel"]).T)


def test_unported_paths_raise(tiny_pair):
    """The parallel/MoE model options belong to later slices: they
    raise, so no plain stand-in sits on any path. The full-sequence
    forward is ported (the training slice) and gives logits."""
    _, _, tm = tiny_pair
    logits = tm(torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, 128) and logits.dtype == torch.float32
    for kw in ({"tp_axis": "tp"}, {"seq_parallel": "sp"},
               {"moe_experts": 4}, {"remat": True}):
        with pytest.raises(NotImplementedError):
            gpt.gpt_tiny(**kw)


def test_init_kv_cache_device_rule(tiny_pair):
    """The cache lands on the GPU by default: without one, and without
    an explicit ``device="cpu"``, it raises instead of falling back."""
    _, _, tm = tiny_pair
    cache = gpt.init_kv_cache(tm, 2, 8, device="cpu")
    assert cache["pos"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.init_kv_cache(tm, 2, 8)

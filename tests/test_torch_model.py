"""The port's model against the JAX package's on the same weights.

Reduced llama3.2-3b (2 layers, d 256, f32): the JAX param tree is
converted with ``repro_torch.convert`` and both forwards run on the same
numpy inputs. Bars: hidden states within atol/rtol 2e-4 (the bars of
tests/test_kernel_integration.py), on plain and SPA-packed rows; one paged
decode step of the attention block against JAX ``attention`` on the same
page pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.queue import RolloutGroup  # noqa: E402
from repro.core.spa import pack_spa  # noqa: E402
from repro.models import forward_hidden as jax_forward_hidden  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.models import forward, forward_hidden, init  # noqa: E402
from repro_torch.models.attention import (PagedCacheBackend,  # noqa: E402
                                          gqa_attention)
from repro_torch.models.transformer import param_shapes  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    jparams = jax.device_get(jax_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jparams, from_jax(jparams, cfg, device="cpu")


def test_reduced_config_matches_jax():
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta", "norm_eps",
              "tie_embeddings", "param_dtype", "compute_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full, jfull = get_config("llama3.2-3b"), jax_get_config("llama3.2-3b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
        jfull.num_layers, jfull.d_model, jfull.num_heads, jfull.num_kv_heads,
        jfull.head_dim, jfull.d_ff, jfull.vocab_size)
    with pytest.raises(KeyError, match="not ported"):
        get_config("deepseek-v2-lite-16b")


def test_convert_round_trip(setup):
    _, cfg, jparams, params = setup
    back = to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    bad = jax.tree.map(lambda a: a, jparams)
    bad["layers"]["attn"]["wq"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="attn/wq"):
        from_jax(bad, cfg, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_jax(bad, cfg, device="cpu")


def test_init_is_seeded_and_shaped():
    cfg = reduced_config(get_config("llama3.2-3b"))
    a = init(cfg, seed=3, device="cpu")
    b = init(cfg, seed=3, device="cpu")
    c = init(cfg, seed=4, device="cpu")
    shapes = param_shapes(cfg)
    assert tuple(a["layers"]["mlp"]["w_down"].shape) == \
        shapes["layers"]["mlp"]["w_down"]
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])
    w = a["layers"]["attn"]["wk"]
    # truncated normal at +-2 sigma, sigma = fan_in^-0.5
    assert w.abs().max() <= 2.0 * cfg.d_model ** -0.5 + 1e-6


def test_cuda_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = reduced_config(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init(cfg, seed=0)


def test_forward_hidden_matches_jax_plain_rows(setup):
    jcfg, cfg, jparams, params = setup
    toks = np.random.RandomState(1).randint(3, cfg.vocab_size, size=(2, 24))
    want, _, _, _ = jax_forward_hidden(jparams, jcfg, jnp.asarray(toks))
    got, _ = forward_hidden(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits, _ = forward(params, cfg, torch.from_numpy(toks))
    assert logits.shape == (2, 24, cfg.vocab_size)


def test_forward_hidden_matches_jax_spa_packed_rows(setup):
    """SPA-packed segment masks (the SPA kernel's raison d'etre)."""
    jcfg, cfg, jparams, params = setup
    rng = np.random.RandomState(0)
    g = RolloutGroup(
        uid=0, prompt_ids=rng.randint(3, 250, size=(12,)).astype(np.int32),
        response_ids=rng.randint(3, 250, size=(3, 6)).astype(np.int32),
        response_len=np.full((3,), 6, np.int32),
        rewards=np.asarray([1.0, 0.0, 1.0], np.float32), weight_version=0)
    mb = pack_spa(g, np.asarray([0.5, -1.0, 0.5], np.float32), 12, 6,
                  responses_per_row=3)
    want, _, _, _ = jax_forward_hidden(
        jparams, jcfg, jnp.asarray(mb.tokens),
        positions=jnp.asarray(mb.positions), segments=jnp.asarray(mb.segments))
    got, _ = forward_hidden(params, cfg, torch.from_numpy(mb.tokens).long(),
                            positions=torch.from_numpy(mb.positions),
                            segments=torch.from_numpy(mb.segments))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_step_matches_jax_attention():
    """One paged decode step through the attention block, on the page
    pool of tests/test_kernel_integration.py: same output, and the token's
    K/V and position land in the same slots."""
    from repro.models.attention import PagedCacheBackend as JaxBackend
    from repro.models.attention import attention as jax_attention
    from repro.models.attention import init_attention
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    rng = np.random.RandomState(7)
    jp = jax.device_get(init_attention(jax.random.PRNGKey(11), jcfg,
                                       jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    P, page, B = 6, 4, 2
    jcache = JaxBackend(jcfg, page).init(P, jnp.float32)
    kv = {k: rng.randn(*v.shape).astype(np.float32)
          for k, v in jcache.items() if k != "pos_pages"}
    pos = np.full((P, page), 2 ** 30, np.int32)
    for j, p0 in ((2, 0), (3, 4), (4, 0), (5, 4)):
        pos[j] = np.arange(p0, p0 + page)
    jcache = {**{k: jnp.asarray(v) for k, v in kv.items()},
              "pos_pages": jnp.asarray(pos)}
    tcache = PagedCacheBackend(cfg, page).init(P, torch.float32, "cpu")
    for k, v in kv.items():
        tcache[k].copy_(torch.from_numpy(v))
    tcache["pos_pages"].copy_(torch.from_numpy(pos))
    table = np.asarray([[2, 3, 0], [4, 5, 0]], np.int32)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    positions = np.full((B, 1), 8, np.int32)
    wslot = np.asarray([3 * page + 0, 5 * page + 0], np.int32)
    o_j, c_j = jax_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(positions),
                             jnp.zeros((B, 1), jnp.int32), cache=jcache,
                             cache_offset=jnp.asarray(wslot),
                             page_table=jnp.asarray(table))
    t = torch.from_numpy
    o_t, c_t = gqa_attention(tp, cfg, t(x), t(positions),
                             torch.zeros((B, 1), dtype=torch.int32),
                             cache=tcache, cache_offset=t(wslot),
                             page_table=t(table))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    for k in c_j:
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                   atol=1e-6)

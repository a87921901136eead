"""The port's group-at-a-time ``Sampler`` and its dense (and ring) KV
cache, held to the JAX package on the CPU.

Reduced llama3.2-3b, the same with a window of 8 tokens (prompts longer
than the window: the ring prefill of S > L tokens and the ring's wrap
during decode), reduced ``mla_dense`` (deepseek-v2-lite with MoE off)
and reduced deepseek-v2-lite with MoE on, f32, on the same weights
(``convert.from_jax``): greedy tokens, response lengths (an EOS mid-
response among them) and captured logprobs equal to the JAX ``Sampler``
at the same B and prompt length. The cache backend is held to the JAX one
call by call; sampled rows equal the port's paged engine's under the same
key; ``serve_batch`` and ``--engine fixed`` run end to end.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models.attention import \
    DenseCacheBackend as JaxDense  # noqa: E402
from repro.rl.rollout import Sampler as JaxSampler  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import engine_support  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init, init_caches  # noqa: E402
from repro_torch.models.attention import (INVALID_POS,  # noqa: E402
                                          DenseCacheBackend, cache_streams)
from repro_torch.rl.rollout import Sampler  # noqa: E402
from test_torch_mla import mla_dense  # noqa: E402
from test_torch_train import port_rope_freqs  # noqa: E402,F401

LP, T, WINDOW = 16, 12, 8
_rng = np.random.RandomState(0)
# mixed lengths, one longer than LP (kept to its tail); under the window
# the 14-, 16- and 21-token prompts are longer than it
PROMPTS = [_rng.randint(3, 500, size=(n,)).astype(np.int32)
           for n in (3, 14, 9, 21)]
FAMILIES = {
    "llama": (lambda get: get("llama3.2-3b"), None),
    "window": (lambda get: get("llama3.2-3b"), WINDOW),
    "mla_dense": (mla_dense, None),
    "deepseek_moe": (lambda get: get("deepseek-v2-lite-16b"), None),
}
# logprobs: f32 noise of two frameworks' sums
LP_TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(name):
    base, window = FAMILIES[name]
    jcfg, cfg = jax_reduced(base(jax_get_config)), reduced_config(
        base(get_config))
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return jcfg, cfg


@pytest.fixture(scope="module")
def setups():
    """family -> (jcfg, cfg, JAX params, port params) on the same
    weights (made by the port's seeded ``init``)."""
    out = {}
    for name in FAMILIES:
        jcfg, cfg = _pair(name)
        tree = to_numpy(init(cfg, seed=0, device="cpu"))
        out[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                     from_jax(tree, cfg, device="cpu"))
    return out


def _both(setup, prompts, **kw):
    jcfg, cfg, jp, p = setup
    got = Sampler(cfg, LP, T, device="cpu", **kw).generate(p, prompts, 0)
    want = JaxSampler(jcfg, LP, T, **kw).generate(jp, prompts,
                                                  jax.random.PRNGKey(0))
    return got, jax.device_get(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_tokens_match_the_jax_sampler(setups, family,
                                             port_rope_freqs):  # noqa: F811
    """Greedy, twice: as drawn, then with EOS set to the token row 0 drew
    at step 3, so that rows stop mid-response and emit PAD after. Tokens
    and response lengths equal; captured logprobs within 1e-4. The MoE
    model routes each forward's B x S tokens, pads included, in both."""
    got, want = _both(setups[family], PROMPTS, temperature=0.0)
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids)
    eos = int(want.response_ids[0, 3])
    got, want = _both(setups[family], PROMPTS, temperature=0.0, eos_id=eos)
    lens = want.response_len
    assert lens[0] <= 4 and (lens < T).any()
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids)
    np.testing.assert_array_equal(got.response_len.numpy(), lens)
    np.testing.assert_allclose(got.response_logprobs.numpy(),
                               want.response_logprobs, **LP_TOL)
    past = np.arange(T)[None] >= lens[:, None]
    assert (got.response_ids.numpy()[past] == 0).all()
    assert (got.response_logprobs.numpy()[past] == 0).all()


def _cache_case(cfg, jcfg, L, B=3):
    """A (B, L) cache in each package and a seeded stream of writes: left
    padding at pos 0 / seg -1 in the prefill, as the Sampler writes it."""
    rng = np.random.RandomState(1)
    streams = cache_streams(cfg)

    def vals(S):
        return tuple(rng.randn(B, S, *shp).astype(np.float32)
                     for _, shp in streams)
    port = DenseCacheBackend(cfg, L)
    jax_be = JaxDense(jcfg, L)
    return (port, port.init(B, torch.float32, "cpu"), jax_be,
            jax_be.init(B, jnp.float32), vals, [n for n, _ in streams])


def _assert_cache_equal(state, jstate, names):
    for n in names:
        np.testing.assert_array_equal(state[n].numpy(), np.asarray(jstate[n]))
    seg = np.asarray(jstate["seg"])
    np.testing.assert_array_equal(state["seg"].numpy(), seg)
    # padding is stored at INVALID_POS: the decode kernels mask by
    # position, JAX masks it by segment
    np.testing.assert_array_equal(
        state["pos"].numpy(),
        np.where(seg == -1, INVALID_POS, np.asarray(jstate["pos"])))


@pytest.mark.parametrize("family", ["llama", "window", "mla_dense"])
@pytest.mark.parametrize("S", [5, 13])
def test_dense_cache_writes_match_jax(family, S):
    """``write_prefill`` (S <= L at offset 0; S > L ring-writes the
    trailing window) and then ``write_decode`` of one token at the
    Sampler's offsets, past the ring's wrap, call by call against the JAX
    backend, pads included."""
    jcfg, cfg = _pair(family)
    L = WINDOW if cfg.sliding_window else S + 6
    port, state, jbe, jstate, vals, names = _cache_case(cfg, jcfg, L)
    B = 3
    lens = np.array([S, 2, S - 1])
    ar = np.arange(S)[None]
    pad = S - lens[:, None]
    pos = np.where(ar >= pad, ar - pad, 0).astype(np.int32)
    seg = np.where(ar >= pad, 0, -1).astype(np.int32)
    v = vals(S)
    port.write_prefill(state, tuple(map(torch.from_numpy, v)),
                       torch.from_numpy(pos), torch.from_numpy(seg))
    jstate = jbe.write_prefill(jstate, tuple(map(jnp.asarray, v)),
                               jnp.asarray(pos), jnp.asarray(seg))
    _assert_cache_equal(state, jstate, names)
    for t in range(6):
        v = vals(1)
        p = (lens + t).astype(np.int32)[:, None]
        z = np.zeros((B, 1), np.int32)
        port.write_decode(state, tuple(map(torch.from_numpy, v)),
                          torch.from_numpy(p), torch.from_numpy(z), S + t)
        jstate = jbe.write_decode(jstate, tuple(map(jnp.asarray, v)),
                                  jnp.asarray(p), jnp.asarray(z), S + t)
        _assert_cache_equal(state, jstate, names)


def test_dense_cache_refuses_what_jax_would_clamp():
    """A non-ring cache refuses a prefill longer than itself and a write
    past its end at a scalar offset (JAX's dynamic_update_slice would
    clamp the write) and an offset that is neither an int nor a (B,)
    tensor; a per-row (B,) offset, the slot engines' form, writes row b
    at its own slot."""
    _, cfg = _pair("llama")
    be = DenseCacheBackend(cfg, 4)
    st = be.init(1, torch.float32, "cpu")
    kv = torch.zeros(1, 5, cfg.num_kv_heads, cfg.head_dim)
    ids = torch.zeros(1, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        be.write_prefill(st, (kv, kv), ids, ids)
    with pytest.raises(ValueError, match="overruns"):
        be.write_decode(st, (kv[:, :1], kv[:, :1]), ids[:, :1], ids[:, :1], 4)
    with pytest.raises(TypeError, match="scalar"):
        be.write_decode(st, (kv[:, :1], kv[:, :1]), ids[:, :1], ids[:, :1],
                        1.0)
    with pytest.raises(TypeError, match=r"\(B,\)"):
        be.write_decode(st, (kv[:, :1], kv[:, :1]), ids[:, :1], ids[:, :1],
                        torch.zeros((1, 1), dtype=torch.int64))
    one = torch.ones(1, 1, cfg.num_kv_heads, cfg.head_dim)
    be.write_decode(st, (one, one), ids[:, :1] + 7, ids[:, :1],
                    torch.full((1,), 3, dtype=torch.int64))
    assert st["pos"].tolist() == [[INVALID_POS] * 3 + [7]]
    assert torch.equal(st["k"][0, 3], one[0, 0])


@pytest.mark.parametrize("family", ["llama", "window", "deepseek_moe"])
@pytest.mark.parametrize("ring,slack", [(True, 0), (False, 0), (True, 3)])
@pytest.mark.parametrize("length", [5, 28])
def test_init_caches_slot_counts_match_jax(family, ring, slack, length):
    """A windowed config's ring holds ``min(length, window + slack)``
    slots, ``length`` with ``ring=False`` or without a window, as JAX's."""
    jcfg, cfg = _pair(family)
    jparams = {"prelude": [None] * jcfg.first_k_dense} if jcfg.is_moe \
        else {}
    want = jax_init_caches(jparams, jcfg, 2, length, ring=ring,
                           ring_slack=slack)["layers"]["kv"]["pos"].shape
    got = init_caches(cfg, 2, length, device="cpu", ring=ring,
                      ring_slack=slack)["layers"]["kv"]["pos"].shape
    assert got[1:] == want[1:] and got[0] == cfg.num_layers


@pytest.mark.parametrize("family", ["llama", "window", "mla_dense"])
def test_sampled_rows_equal_the_paged_engine(setups, family):
    """Temperature 1 and the same key: each row's tokens, length and
    captured logprobs are the paged engine's for that row of the group
    (the counter hash keys a draw by (key, row, t) alone), with EOS set to
    a token row 0 drew mid-response. MoE is left out: its capacity
    follows each forward's token count, which the two engines size
    differently."""
    _, cfg, _, p = setups[family]
    G, key = 4, (7, 1)
    prompt = PROMPTS[1]

    def paged(eos):
        eng = PagedGroupEngine(
            cfg, num_slots=G, page_size=4, num_pages=0, max_prompt_len=LP,
            max_new_tokens=T, group_size=G, temperature=1.0, eos_id=eos,
            device="cpu")
        eng.set_params(p)
        h = eng.submit(prompt, key)
        while eng.step():
            pass
        return h.result(timeout=0)

    def group(eos):
        return Sampler(cfg, LP, T, temperature=1.0, eos_id=eos,
                       device="cpu").generate(p, [prompt] * G, key)
    eos = int(group(-1).response_ids[0, 4])
    got, want = group(eos), paged(eos)
    lens = want.response_len.numpy()
    assert lens[0] <= 5 and (lens < T).any()
    np.testing.assert_array_equal(got.response_len.numpy(), lens)
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids.numpy())
    np.testing.assert_allclose(got.response_logprobs.numpy(),
                               want.response_logprobs.numpy(), **LP_TOL)


def test_group_engine_support_matrix():
    """The group engine (and the slot engine, ``cbatch``) takes GQA and
    MLA, dense or MoE, with or without a window; SSM/hybrid, enc-dec and
    VLM wait; spec decode rides every engine (the SpecSampler on the
    group engine), the radix cache the paged engine only."""
    for name in FAMILIES:
        for engine in ("group", "cbatch"):
            assert engine_support(_pair(name)[1], engine)[0]
            assert engine_support(_pair(name)[1], "spec",
                                  rollout_engine=engine)[0]
    _, cfg = _pair("llama")
    for bad in (dict(family="ssm", ssm_state_size=16), dict(hybrid=True),
                dict(is_encoder_decoder=True), dict(vision_prefix_len=4)):
        for engine in ("group", "cbatch"):
            ok, reason = engine_support(dataclasses.replace(cfg, **bad),
                                        engine)
            assert not ok and "not ported" in reason
            assert not engine_support(dataclasses.replace(cfg, **bad),
                                      "spec", rollout_engine=engine)[0]
    ok, reason = engine_support(cfg, "spec", rollout_engine="group")
    assert ok and "past the frontier" in reason
    assert "contiguous cache" in engine_support(cfg, "cbatch")[1]
    for engine in ("group", "cbatch"):
        assert not engine_support(cfg, "prefix", rollout_engine=engine)[0]
    assert engine_support(cfg, "spec")[0]


def test_instance_runs_exactly_one_engine():
    """An ``InferenceInstance`` takes exactly one of a sampler, a paged
    engine and a scripted_fn; with the sampler its flips land at once
    (nothing to keep quiescent)."""
    from repro_torch.core.engine import InferenceInstance
    _, cfg = _pair("llama")
    sampler = Sampler(cfg, LP, T, device="cpu")
    inst = InferenceInstance(0, cfg, sampler)
    assert inst.store.on_flip is None and not inst.store.defer_flip
    for bad in (dict(), dict(sampler=sampler, scripted_fn=print)):
        with pytest.raises(ValueError, match="exactly one"):
            InferenceInstance(0, cfg, **bad)


def test_serve_batch_on_cpu(setups):
    """``serve_batch``: one Sampler call without capture, sampled under
    ``seed + 1``, its stats counting every row's tokens up to its EOS."""
    _, cfg, _, p = setups["llama"]
    out, stats = serve.serve_batch(cfg, PROMPTS, max_prompt_len=LP,
                                   max_new=T, seed=3, device="cpu", params=p)
    assert out.response_logprobs is None
    assert out.response_ids.shape == (len(PROMPTS), T)
    assert stats["generated_tokens"] == int(out.response_len.sum()) > 0
    assert stats["tok_per_s"] > 0 and stats["wall_s"] > 0
    again = Sampler(cfg, LP, T, temperature=0.7, capture_logprobs=False,
                    device="cpu").generate(p, PROMPTS, 4)
    assert torch.equal(out.response_ids, again.response_ids)


def test_serve_cli_fixed_engine_on_cpu(capsys):
    serve.main(["--engine", "fixed", "--device", "cpu", "--reduced",
                "--num-requests", "3", "--max-new", "6"])
    text = capsys.readouterr().out
    assert "(fixed batch of 3)" in text and text.count("  req ") == 3
    with pytest.raises(SystemExit):
        serve.main(["--engine", "fixed", "--device", "cpu", "--reduced",
                    "--spec"])

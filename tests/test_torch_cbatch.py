"""The port's dense-slot continuous-batching engine
(``core/cbatch.py ContinuousBatchingSampler``) and the per-row writes of
its dense (and ring) cache, held to the JAX package on the CPU.

``DenseCacheBackend.write_decode`` at per-row (B,) offsets, one token and
a k+1-token block, plain and on a ring with slack, call by call against
the JAX backend (pads stored at INVALID_POS); an idle slot's pad write
lands in slot 0 of its finished row, which no live row reads. On reduced
llama3.2-3b, the same with a window of 8, reduced ``mla_dense`` and
reduced deepseek-v2-lite with MoE on, f32, on the same weights
(``convert.from_jax``): greedy tokens, completion order and
``finish_step`` equal to the JAX engine with 2 slots for 5 requests and
per-request caps that stop rows mid-block, at D 1 / 3 / 8 and with spec
k 2 (and its spec stats); greedy rows equal to the port's ``Sampler``;
sampled rows independent of the slot count and D and equal to the paged
engine's ``serve`` under the same key.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.cbatch import \
    ContinuousBatchingSampler as JaxCB  # noqa: E402
from repro.models.attention import \
    DenseCacheBackend as JaxDense  # noqa: E402
from repro_torch.core.cbatch import ContinuousBatchingSampler  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.attention import (INVALID_POS,  # noqa: E402
                                          DenseCacheBackend, cache_streams)
from repro_torch.rl.rollout import Sampler  # noqa: E402
from test_torch_sampler import (FAMILIES, _assert_cache_equal,  # noqa: E402
                                _pair, setups)
from test_torch_train import port_rope_freqs  # noqa: E402,F401

LP, T, SLOTS = 16, 12, 2
_rng = np.random.RandomState(3)
# five requests for two slots; the 21-token prompt keeps its first LP
PROMPTS = [_rng.randint(3, 500, size=(n,)).astype(np.int32)
           for n in (3, 14, 9, 21, 6)]
# per-request caps: with D 3 / 8 rows stop mid-block
CAPS = [10, 4, 12, 7, 9]
MODES = {"d1": dict(drain_interval=1), "d3": dict(drain_interval=3),
         "d8": dict(drain_interval=8), "spec2": dict(spec_k=2)}


# ---------------------------------------------------------------------
# per-row writes of the dense (and ring) cache
# ---------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "window", "mla_dense"])
@pytest.mark.parametrize("S", [1, 3])
def test_per_row_writes_match_jax(family, S):
    """Eight writes of S tokens a row at per-row (B,) offsets, a row's
    pads at seg -1 among them, call by call against the JAX backend: a
    plain cache of 20 slots, and under the window a ring of window + S
    slots (the spec engines' ring slack), offsets past its wrap."""
    jcfg, cfg = _pair(family)
    B = 3
    L = cfg.sliding_window + S if cfg.sliding_window else 20
    rng = np.random.RandomState(S)
    port = DenseCacheBackend(cfg, L)
    jbe = JaxDense(jcfg, L)
    state, jstate = port.init(B, torch.float32, "cpu"), jbe.init(
        B, jnp.float32)
    names = [n for n, _ in cache_streams(cfg)]
    hi = 3 * L if cfg.sliding_window else L - S + 1
    for _ in range(8):
        vals = tuple(rng.randn(B, S, *shp).astype(np.float32)
                     for _, shp in cache_streams(cfg))
        off = rng.randint(0, hi, size=(B,))
        pos = (off[:, None] + np.arange(S)[None]).astype(np.int32)
        seg = np.where(rng.rand(B, S) < 0.3, -1, 0).astype(np.int32)
        port.write_decode(state, tuple(map(torch.from_numpy, vals)),
                          torch.from_numpy(pos), torch.from_numpy(seg),
                          torch.from_numpy(off))
        jstate = jbe.write_decode(jstate, tuple(map(jnp.asarray, vals)),
                                  jnp.asarray(pos), jnp.asarray(seg),
                                  jnp.asarray(off, jnp.int32))
        _assert_cache_equal(state, jstate, names)


def test_idle_slots_clobber_slot_zero_that_no_live_row_reads(setups):
    """At D 3 the engine's idle and finished slots decode a pad at offset
    0 (as in JAX): it lands in slot 0 of the finished request's row. Every
    decode call is checked: a live row (its query past position 0) always
    finds its own first prompt token in slot 0, and at least one call
    sees a clobbered slot 0 in an idle row."""
    _, cfg, _, p = setups["llama"]
    seen = {"live": 0, "clobbered": 0}
    orig = attention.decode_attention

    def checked(q, k, v, kv_pos, q_pos, **kw):
        live = q_pos > 0
        assert bool((kv_pos[live, 0] == 0).all())
        seen["live"] += int(live.sum())
        seen["clobbered"] += int((kv_pos[~live, 0] == INVALID_POS).sum())
        return orig(q, k, v, kv_pos, q_pos, **kw)
    attention.decode_attention = checked
    try:
        ContinuousBatchingSampler(
            cfg, num_slots=SLOTS, max_prompt_len=LP, max_new_tokens=T,
            temperature=0.0, drain_interval=3, device="cpu").run(
            p, PROMPTS, 0, max_new_per_request=CAPS)
    finally:
        attention.decode_attention = orig
    assert seen["live"] > 0 and seen["clobbered"] > 0


# ---------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------

def _records(done):
    return [(c.request_id, np.asarray(c.response_ids).tolist(),
             c.finish_step) for c in done]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_matches_the_jax_engine(setups, family, mode,
                                       port_rope_freqs):  # noqa: F811
    """2 slots, 5 requests, per-request caps: tokens, completion order and
    finish steps equal to the JAX ``ContinuousBatchingSampler`` at the
    same D (or spec k 2, with its spec stats). The MoE model routes each
    forward's tokens (B a decode step, one (1, Lp) prompt a prefill,
    B x (k + 1) a verify step) in both."""
    jcfg, cfg, jp, p = setups[family]
    kw = dict(num_slots=SLOTS, max_prompt_len=LP, max_new_tokens=T,
              temperature=0.0, **MODES[mode])
    jeng = JaxCB(jcfg, **kw)
    want = jeng.run(jp, PROMPTS, jax.random.PRNGKey(0),
                    max_new_per_request=CAPS)
    eng = ContinuousBatchingSampler(cfg, device="cpu", **kw)
    got = eng.run(p, PROMPTS, 0, max_new_per_request=CAPS)
    assert _records(got) == _records(want)
    assert [c.request_id for c in got] != list(range(len(PROMPTS)))
    if mode == "spec2":
        assert (eng.spec_steps, eng.drafted_tokens, eng.accepted_tokens) \
            == (jeng.spec_steps, jeng.drafted_tokens, jeng.accepted_tokens)
        assert eng.acceptance_rate == jeng.acceptance_rate
        assert eng.steps == max(c.finish_step for c in got)


@pytest.mark.parametrize("family", ["llama", "mla_dense"])
@pytest.mark.parametrize("mode", ["d1", "d3", "spec2"])
def test_greedy_rows_equal_the_sampler(setups, family, mode):
    """Each request's greedy tokens are the port's Sampler row for its
    prompt, up to its EOS-free length, whatever the slot it ran in (MoE
    off: its capacity follows each forward's token count)."""
    _, cfg, _, p = setups[family]
    # the Sampler keeps a prompt's last LP tokens, the slot engine its
    # first (as JAX's): hand both prompts of at most LP
    prompts = [q[:LP] for q in PROMPTS]
    ref = Sampler(cfg, LP, T, temperature=0.0, device="cpu").generate(
        p, prompts, 0)
    done = ContinuousBatchingSampler(
        cfg, num_slots=SLOTS, max_prompt_len=LP, max_new_tokens=T,
        temperature=0.0, device="cpu", **MODES[mode]).run(p, prompts, 1)
    ids, lens = ref.response_ids.numpy(), ref.response_len.numpy()
    assert len(done) == len(PROMPTS)
    for c in done:
        i = c.request_id
        np.testing.assert_array_equal(c.response_ids, ids[i, : lens[i]])


def test_sampled_rows_do_not_depend_on_slots_or_d_and_equal_paged(setups):
    """Temperature 1 under one key: 1 slot == 3 slots, D 1 == D 3, every
    request's tokens equal to the paged engine's ``serve`` of the same
    prompts (request rid draws as row 0 of the group keyed (key, rid)),
    with EOS set to a token one request drew mid-response."""
    _, cfg, _, p = setups["llama"]

    def cbatch(slots, D, eos):
        done = ContinuousBatchingSampler(
            cfg, num_slots=slots, max_prompt_len=LP, max_new_tokens=T,
            temperature=1.0, eos_id=eos, drain_interval=D,
            device="cpu").run(p, PROMPTS, 5)
        return {c.request_id: c.response_ids.tolist() for c in done}
    eos = cbatch(1, 1, -1)[1][4]
    runs = [cbatch(s, d, eos) for s, d in ((1, 1), (3, 1), (3, 3))]
    assert runs[0] == runs[1] == runs[2]
    assert any(len(r) < T for r in runs[0].values())
    eng = PagedGroupEngine(cfg, num_slots=3, page_size=4, num_pages=0,
                           max_prompt_len=LP, max_new_tokens=T,
                           group_size=1, temperature=1.0, eos_id=eos,
                           device="cpu")
    paged = eng.serve(p, [q[:LP] for q in PROMPTS], 5)
    assert {c.request_id: c.response_ids.tolist() for c in paged} \
        == runs[0]


def test_cbatch_refuses_what_jax_refuses():
    """SSM is refused on the slot engine, with and without spec, and D
    below 1."""
    import dataclasses
    _, cfg = _pair("llama")
    ssm = dataclasses.replace(cfg, family="ssm", ssm_state_size=16)
    kw = dict(num_slots=2, max_prompt_len=8, max_new_tokens=4, device="cpu")
    for extra in ({}, {"spec_k": 2}):
        with pytest.raises(ValueError, match="not ported"):
            ContinuousBatchingSampler(ssm, **kw, **extra)
    with pytest.raises(ValueError, match="drain_interval"):
        ContinuousBatchingSampler(cfg, drain_interval=0, **kw)

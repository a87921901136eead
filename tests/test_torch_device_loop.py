"""The port's device-resident decode loop (``drain_interval`` D) on the CPU,
against the JAX package's ``PagedGroupEngine`` at the same D.

The cases of ``tests/test_device_loop.py`` on the port's engine (reduced
configs, 2 layers, f32): greedy tokens, captured logprobs and
``decode_steps`` equal to the JAX engine's at D 2, 3 and 8 for GQA and at
D 3 and 8 for ``mla_dense`` (MoE off), with spec decode and the radix
prefix cache riding along; sampled tokens do not depend on D or on the
slot count (the counter-based draws); EOS in mid-block, on a block's last
token and at the final step; slot re-assignment while a stale block
drains. Also the counter-based uniforms against a numpy reference of the
hash (bitwise) and Gumbel-max frequencies against the softmax (chi-square),
the launch tally of a graph capture, and ``decode_drain_interval``
through ``build_pipeline`` and the train CLI. On the CPU the engine runs
its step function eagerly; the card replays it as a CUDA graph
(``tests/test_torch_cuda.py``).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.graphs import StaticInputs  # noqa: E402
from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.rl.rollout import (ACCEPT_LANE, _filter_logits,  # noqa: E402
                                    _sample_token_rows, row_seed,
                                    uniform_words, uniforms)
from test_torch_mla import mla_dense  # noqa: E402

T, LP = 8, 16
_rng = np.random.RandomState(0)
# mixed lengths, one longer than max_prompt_len (kept to its tail)
PROMPTS = [_rng.randint(3, 500, size=(n,)).astype(np.int32)
           for n in (3, 10, 6, 21)]


def _setup(jax_base, base):
    jcfg, cfg = jax_reduced(jax_base), reduced_config(base)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


@pytest.fixture(scope="module")
def gqa():
    return _setup(jax_get_config("llama3.2-3b"), get_config("llama3.2-3b"))


@pytest.fixture(scope="module")
def mla():
    return _setup(mla_dense(jax_get_config), mla_dense(get_config))


def _kw(G, **over):
    kw = dict(num_slots=3, page_size=4, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=G, temperature=0.0)
    kw.update(over)
    return kw


def _drive(eng, submits):
    handles = [eng.submit(*a) for a in submits]
    while eng.step():
        pass
    return handles


def _rows(handles):
    return [r.tolist() for h in handles for r in h.host_rows()]


def _engine(params, cfg, G, **over):
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(G, **over))
    eng.set_params(params)
    return eng


def _against_jax(setup, G, **over):
    """The port's and the JAX engine's greedy runs of PROMPTS (G rows a
    group) at the same settings: tokens, captured logprobs, decode steps
    and peak pages equal; every page back."""
    jcfg, cfg, jparams, params = setup
    jeng = JaxEngine(jcfg, **_kw(G, **over))
    jeng.set_params(jparams)
    # The JAX engine hands host numpy arrays (the page table) to its
    # asynchronous block call and rewrites them when it drains the block
    # before; on the CPU backend the call may alias them, and under load
    # it then reads the rewritten table (wrong tokens in about 1 run of 60
    # at D > 1). Waiting for each JAX block keeps its drain protocol and
    # removes the race.
    decode = jeng._decode
    jeng._decode = lambda *a: jax.block_until_ready(decode(*a))
    eng = _engine(params, cfg, G, **over)
    free0 = eng.alloc.num_free
    jh = _drive(jeng, [(p, jax.random.PRNGKey(i))
                       for i, p in enumerate(PROMPTS)])
    th = _drive(eng, [(p, i) for i, p in enumerate(PROMPTS)])
    assert _rows(th) == _rows(jh)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b.result(0).response_logprobs.numpy(),
                                   np.asarray(a.result(0).response_logprobs),
                                   atol=1e-4, rtol=1e-4)
    assert eng.decode_steps == jeng.decode_steps
    assert eng.generated_tokens == jeng.generated_tokens
    assert eng.peak_pages_used == jeng.peak_pages_used
    assert eng.alloc.num_free == free0 and eng.alloc.num_live == 0
    return eng


# ---------------------------------------------------------------------
# greedy against the JAX engine at the same D
# ---------------------------------------------------------------------

@pytest.mark.parametrize("drain", [2, 3, 8])
def test_greedy_drain_matches_jax_engine(gqa, drain):
    """D 3 does not divide T 8 (the last block is short), D 8 fuses the
    whole budget into one block, and G 3 rows on 3 slots put one group's
    rows and the next group's admission into different block phases."""
    eng = _against_jax(gqa, 3, drain_interval=drain)
    assert eng.drain == drain and eng.decode_steps % drain == 0


@pytest.mark.parametrize("drain", [3, 8])
def test_greedy_drain_matches_jax_engine_mla(mla, drain):
    """The latent pool (absorbed MLA decode) under fused blocks."""
    _against_jax(mla, 3, drain_interval=drain)


def test_spec_with_drain_interval_matches_jax_spec_engine(gqa):
    """Spec engines drain per verify step whatever D says; D 8 rides along
    without changing the spec path."""
    eng = _against_jax(gqa, 1, spec_k=2, drain_interval=8)
    assert eng.spec_steps > 0


# ---------------------------------------------------------------------
# sampled: tokens are a function of (key, row, step)
# ---------------------------------------------------------------------

def test_sampled_tokens_do_not_depend_on_drain_interval(gqa):
    _, cfg, _, params = gqa
    runs = {}
    for drain in (1, 3, 8):
        eng = _engine(params, cfg, 3, temperature=1.0, drain_interval=drain)
        hs = _drive(eng, [(p, (5, i)) for i, p in enumerate(PROMPTS)])
        runs[drain] = (_rows(hs), [h.result(0).response_logprobs
                                   for h in hs])
        assert eng.alloc.num_live == 0
    rows1, lps1 = runs[1]
    assert len({len(r) for r in rows1}) > 1     # rows stop at EOS or T
    for drain in (3, 8):
        rows, lps = runs[drain]
        assert rows == rows1
        for a, b in zip(lps, lps1):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_sampled_tokens_do_not_depend_on_slot_count(gqa):
    """One slot against three at D 3; and the key matters."""
    _, cfg, _, params = gqa
    out = {}
    for slots, key in ((1, 5), (3, 5), (3, 6)):
        eng = _engine(params, cfg, 1, num_slots=slots, temperature=1.0,
                      drain_interval=3)
        out[slots, key] = _rows(_drive(eng, [(p, (key, i)) for i, p
                                             in enumerate(PROMPTS)]))
    assert out[1, 5] == out[3, 5] != out[3, 6]


# ---------------------------------------------------------------------
# the prefix cache and the drain edge cases
# ---------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_prefix_cache_warm_fused_equals_cold(request, family):
    """Warm serving at D 8 through the radix cache equals cold serving at
    D 1 (a cached page is bitwise what a cold prefill writes), on K/V
    pages and on MLA latent pages."""
    _, cfg, _, params = request.getfixturevalue(family)
    rng = np.random.RandomState(3)
    system = list(rng.randint(3, 200, size=12))
    prompts = [np.asarray(system + list(rng.randint(3, 200, size=3)),
                          np.int32) for _ in range(4)]

    def serve(eng):
        return {c.request_id: c.response_ids.tolist()
                for c in eng.serve(params, prompts, 11)}
    cold = serve(PagedGroupEngine(cfg, device="cpu",
                                  **_kw(1, num_slots=2)))
    warm_eng = PagedGroupEngine(cfg, device="cpu", prefix_cache=True,
                                **_kw(1, num_slots=2, drain_interval=8))
    assert serve(warm_eng) == cold          # populates the tree
    assert serve(warm_eng) == cold          # served warm
    assert warm_eng.prefix_hit_pages > 0 and warm_eng.warm_prefills > 0


def test_eos_mid_block_at_block_edge_and_at_the_end(gqa):
    """EOS pinned to exact steps by re-running with eos_id set to a token
    the no-EOS greedy stream emits: mid-block (the in-flight block's
    trailing steps run masked and contribute nothing), on a block's last
    token (the drain must not read past it), and at the final step."""
    _, cfg, _, params = gqa
    D = 3

    def serve_one(eos_id, drain):
        eng = PagedGroupEngine(cfg, device="cpu", **_kw(
            1, num_slots=1, eos_id=eos_id, drain_interval=drain))
        done = eng.serve(params, [PROMPTS[1]], 4)
        assert eng.alloc.num_live == 0
        return done[0].response_ids.tolist()

    stream = serve_one(-1, 1)        # EOS never fires: the full budget
    assert len(stream) == T
    for t_star in (D + 1, 2 * D - 1, T - 1):
        tok = stream[t_star]
        want = stream.index(tok) + 1     # the first occurrence stops it
        fused = serve_one(tok, D)
        assert fused == serve_one(tok, 1)
        assert len(fused) == want and fused[-1] == tok


def test_slot_reassignment_during_stale_drain(gqa):
    """More requests than slots with a large D: a row that finishes inside
    one block frees its slot while the next block, dispatched for it, is
    in flight; the drain skips those stale entries and the successor
    decodes exactly as at D 1. Every page returns."""
    _, cfg, _, params = gqa
    rng = np.random.RandomState(9)
    prompts = [rng.randint(3, 200, size=(2 + i,)).astype(np.int32)
               for i in range(6)]

    def serve(drain):
        eng = PagedGroupEngine(cfg, device="cpu", **_kw(
            1, num_slots=2, temperature=1.0, drain_interval=drain))
        done = eng.serve(params, prompts, 6)
        assert eng.idle and eng.alloc.num_live == 0
        assert eng.alloc.num_free == eng.P - FIRST_PAGE
        return {c.request_id: c.response_ids.tolist() for c in done}

    assert serve(5) == serve(1)


def test_drain_interval_must_be_positive(gqa):
    with pytest.raises(ValueError, match="drain_interval"):
        PagedGroupEngine(gqa[1], device="cpu", **_kw(1, drain_interval=0))


# ---------------------------------------------------------------------
# the counter-based draws
# ---------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _np_mix(x):
    """lowbias32 on uint64 words below 2^32 (each product fits uint64)."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & _M32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & _M32
    return x ^ (x >> np.uint64(16))


def _np_words(seed, counter, lane, n):
    s = np.asarray(seed, np.int64).view(np.uint64)
    c = _np_mix((np.asarray(counter, np.int64).astype(np.uint64) & _M32)
                ^ _np_mix(np.asarray(lane, np.uint64)
                          ^ np.uint64(0x9E3779B9)))
    k_lo = _np_mix((s & _M32) ^ c)
    k_hi = _np_mix((s >> np.uint64(32)) ^ _np_mix(k_lo))
    v = np.arange(n, dtype=np.uint64)
    return _np_mix(_np_mix(v ^ k_lo[..., None]) ^ k_hi[..., None])


def test_uniform_words_bitwise_equal_to_numpy_reference():
    rng = np.random.RandomState(1)
    seeds = np.concatenate([
        [0, -1, 2 ** 63 - 1, -2 ** 63, row_seed((7, 3), 2)],
        rng.randint(-2 ** 63, 2 ** 63 - 1, size=11, dtype=np.int64)])
    counters = rng.randint(0, 2 ** 31 - 1, size=seeds.shape, dtype=np.int64)
    for lane in (0, ACCEPT_LANE + 3):
        got = uniform_words(torch.from_numpy(seeds),
                            torch.from_numpy(counters), lane, 257)
        want = _np_words(seeds, counters, lane, 257)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
        u = uniforms(torch.from_numpy(seeds), torch.from_numpy(counters),
                     lane, 257).numpy()
        u_ref = (((want >> np.uint64(9)).astype(np.float32)
                  + np.float32(0.5)) * np.float32(2.0 ** -23))
        np.testing.assert_array_equal(u, u_ref)
        assert u.min() > 0.0 and u.max() < 1.0
    # a lane tensor broadcasts like the int lanes it holds
    lanes = ACCEPT_LANE + torch.arange(4)
    got = uniform_words(torch.from_numpy(seeds)[:, None],
                        torch.from_numpy(counters)[:, None], lanes, 9)
    for j in range(4):
        np.testing.assert_array_equal(
            got[:, j].numpy().astype(np.uint64),
            _np_words(seeds, counters, ACCEPT_LANE + j, 9))


# chi-square critical value at p = 0.001 with 5 degrees of freedom
_CHI2_5_999 = 20.515


@pytest.mark.parametrize("over", ["rows", "steps"])
def test_gumbel_max_frequencies_match_the_softmax(over):
    """20000 draws of one 6-way distribution (temperature 0.7), over row
    seeds at one step or over one row's steps: the token frequencies pass
    a chi-square test against softmax(logits / 0.7) at p = 0.001 (the
    draws are fixed, so the statistic is too)."""
    n = 20000
    lg = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -1.5]])
    ar = torch.arange(n, dtype=torch.int64)
    seeds, counter = ((ar * 7919 + 1, torch.zeros(n, dtype=torch.int64))
                      if over == "rows" else
                      (torch.full((n,), row_seed(3, 0)), ar))
    tok = _sample_token_rows(lg.expand(n, 6), seeds, counter, 0.7, 1.0)
    p = torch.softmax(_filter_logits(lg, 0.7, 1.0)[0], -1).double().numpy()
    obs = np.bincount(tok.numpy(), minlength=6)
    chi2 = float(((obs - n * p) ** 2 / (n * p)).sum())
    assert chi2 < _CHI2_5_999, (obs, n * p, chi2)


# ---------------------------------------------------------------------
# the capture-side plumbing that runs on the CPU
# ---------------------------------------------------------------------

def test_launches_recorded_during_a_capture_go_to_its_tally():
    """On the capturing thread ``count_launch`` adds to the graph's tally,
    not to LAUNCHES; another thread's launches stay eager; each replay
    adds the whole tally."""
    before = dict(kernels.LAUNCHES)
    with kernels.recording() as tally:
        kernels.count_launch("paged_decode_attention")
        kernels.count_launch("paged_decode_attention")
        t = threading.Thread(
            target=kernels.count_launch, args=("transfer_cast",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert tally == {"paged_decode_attention": 2}
    assert kernels.LAUNCHES["paged_decode_attention"] == \
        before["paged_decode_attention"]
    assert kernels.LAUNCHES["transfer_cast"] == before["transfer_cast"] + 1
    for _ in range(3):
        kernels.add_launches(tally)
    assert kernels.LAUNCHES["paged_decode_attention"] == \
        before["paged_decode_attention"] + 6
    kernels.count_launch("spa_attention")          # recording has ended
    assert kernels.LAUNCHES["spa_attention"] == before["spa_attention"] + 1


def test_static_inputs_pack_every_array_each_upload():
    x = StaticInputs({"a": (2, 3), "b": (4,)}, torch.device("cpu"))
    a = np.arange(6).reshape(2, 3)
    x.upload({"a": a, "b": np.array([True, False, True, True])})
    assert torch.equal(x["a"], torch.from_numpy(a))
    assert x["b"].tolist() == [1, 0, 1, 1]
    with pytest.raises(ValueError, match="exactly"):
        x.upload({"a": a})


# ---------------------------------------------------------------------
# the pipeline and the train CLI
# ---------------------------------------------------------------------

def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_weights_stay_resident_once(gqa):
    """On the CPU the engine decodes with the caller's tree itself (no
    graph needs fixed addresses), and a store whose flip hook is the
    engine's ``set_params`` holds the tree the engine returns, not a
    second one."""
    from repro_torch.transfer.service import VersionedParamStore
    cfg, params = gqa[1], gqa[3]
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(1))
    assert eng.set_params(params) is params and eng.params is params
    held = {"embed": torch.zeros(2)}
    store = VersionedParamStore(on_flip=lambda p: held)
    store.install({"embed": torch.ones(2)}, 0)
    assert store.snapshot()[0] is held
    store = VersionedParamStore(on_flip=eng.set_params)
    other = {k: v for k, v in params.items()}
    store.install(other, 1)
    assert store.snapshot()[0] is other is eng.params


def test_engine_has_no_stream_on_the_cpu(gqa):
    """On the CPU there are no streams: the engine's stream is None, and
    ``set_params`` holds and returns the caller's tree (on the card the
    engines decode on the card's engine stream, tests/test_torch_cuda.py)."""
    from repro_torch.core.paged import engine_stream
    cfg, params = gqa[1], gqa[3]
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(1, drain_interval=4))
    assert eng.stream is None and engine_stream(torch.device("cpu")) is None
    assert eng.set_params(params) is params and eng.params is params
    other = {k: v for k, v in params.items()}
    assert eng.set_params(other) is other and eng.params is other


def _parity_reward(resp, answer) -> float:
    """A reward that varies with the tokens (a random model never answers
    right, so the task's reward would leave every advantage at zero and
    the parameters where they started)."""
    return float(np.mean(np.asarray(resp) % 2)) if len(resp) else 0.0


def test_pipeline_sync_equals_async_at_drain_interval_4(gqa):
    """Proposition 1 with paged rollouts at D 4: sampled rollouts depend
    only on (key, prompt, step), so sync and async train on the same
    groups and reach the same parameters up to f32 summation order (the
    bar of tests/test_torch_pipeline.py)."""
    cfg = gqa[1]

    def run(mode):
        rl = RLConfig(mode=mode, batch_prompts=2, group_size=3, micro_batch=3,
                      num_inference_instances=1, max_prompt_len=24,
                      max_response_len=6, learning_rate=1e-3, seed=0,
                      cbatch_slots=4, decode_drain_interval=4)
        sched, parts = build_pipeline(cfg, rl, seed=0, device="cpu")
        hist = sched.run(2)
        assert all(s.max_staleness == 0 and s.trained_tokens > 0
                   for s in hist)
        assert parts["pool"].instances[0].paged_engine.drain == 4
        assert all(s.metrics["decode_steps"] % 4 == 0 for s in hist)
        return parts["tri"].policy
    for a, b in zip(_leaves(run("sync")), _leaves(run("async"))):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_pipeline_sync_equals_async_at_drain_interval_8(gqa):
    """The same bar at D 8, where a row's responses span two blocks, with
    a reward that varies with the tokens, so the updates are not zero and
    the parameters move."""
    cfg = gqa[1]

    def run(mode):
        rl = RLConfig(mode=mode, batch_prompts=2, group_size=3, micro_batch=3,
                      num_inference_instances=1, max_prompt_len=24,
                      max_response_len=10, learning_rate=1e-3, seed=0,
                      cbatch_slots=4, decode_drain_interval=8)
        sched, parts = build_pipeline(cfg, rl, seed=0, device="cpu")
        parts["generator"].reward_fn = _parity_reward
        start = [t.clone() for t in _leaves(parts["tri"].policy)]
        hist = sched.run(2)
        assert all(s.max_staleness == 0 and s.trained_tokens > 0
                   for s in hist)
        assert any(s.reward_mean > 0 for s in hist)
        assert all(s.metrics["decode_steps"] % 8 == 0 for s in hist)
        policy = parts["tri"].policy
        assert not all(torch.equal(a, b)
                       for a, b in zip(start, _leaves(policy)))
        return policy
    for a, b in zip(_leaves(run("sync")), _leaves(run("async"))):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_train_cli_takes_drain_interval(capsys):
    train.main(["--device", "cpu", "--reduced", "--iterations", "2",
                "--batch-prompts", "2", "--group-size", "3", "--spa",
                "--max-prompt-len", "48", "--max-response-len", "8",
                "--drain-interval", "4"])
    text = capsys.readouterr().out
    assert "drain_interval=4" in text and "iter 1:" in text
    assert text.count("staleness=0") == 2

"""The sliding window on the port's paged plane, held to the JAX package.

Reduced llama3.2-3b (GQA) and reduced ``mla_dense`` (deepseek-v2-lite
with MoE off) with a window of 8 tokens on 4-token pages: the window
slides past prompt AND response pages mid-decode, so out-of-window pages
are reclaimed. The port's ``PagedGroupEngine`` and the JAX engine run the
same prompts on the same weights, greedy: tokens, ``reclaimed_pages``,
``peak_pages_used`` and ``decode_steps`` are equal, on the plain, spec
and D 3 / D 8 planes, and every page returns. On the radix plane the port
departs from the JAX engine, whose warm suffix prefill misses keys below
the response's first live page (``PagedGroupEngine._radix_match``): its
warm tokens are held to its cold ones and to the JAX engine's cold
ones. Sampled draws differ
from JAX's stream, so sampled runs are held by the D- and
slot-invariance properties. A pool of the windowed budget completes a
decode the full history would not fit. The page geometry
(``_row_budget``, ``_prompt_page_range``) and ``long_context_variant``
equal the JAX package's; a windowed grad step and a windowed pipeline
run are held to JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import long_context_variant as jax_lcv  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import RLConfig as JaxRL  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.launch.train import build_pipeline as jax_pipeline  # noqa: E402
from repro.rl import grpo as jgrpo  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 long_context_variant, reduced_config)
from repro_torch.configs.base import RLConfig, engine_support  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.rl import grpo  # noqa: E402
from test_torch_mla import mla_dense  # noqa: E402
from test_torch_pipeline import _leaves, _rl  # noqa: E402
from test_torch_pipeline import jax_scripted, scripted  # noqa: E402
from test_torch_train import (_assert_tree_close, _make,  # noqa: E402
                              _packed, port_rope_freqs)

WINDOW, PAGE, LP, T = 8, 4, 16, 16
_rng = np.random.RandomState(0)
# mixed lengths, one longer than max_prompt_len (kept to its tail): the
# first response query of the 14- and 16-token prompts cannot see their
# first prompt pages, which are never allocated
PROMPTS = [_rng.randint(3, 500, size=(n,)).astype(np.int32)
           for n in (3, 14, 9, 21)]
# the radix plane: four prompts of 13-16 tokens behind one 12-token
# system prompt, whose pages 1 and 2 stay in every first query's window
SHARED = [np.concatenate([PROMPTS[3][:12], p[:n]])
          for n, p in enumerate(PROMPTS, 1)]

FAMILIES = {"gqa": lambda get: get("llama3.2-3b"), "mla": mla_dense,
            "moe": lambda get: get("deepseek-v2-lite-16b")}
MODES = {"plain": {}, "spec": dict(spec_k=2), "d3": dict(drain_interval=3),
         "d8": dict(drain_interval=8), "radix": {}}


def _windowed(cfg, window=WINDOW):
    return dataclasses.replace(cfg, sliding_window=window)


def _pair(base):
    """(jcfg, cfg): a family's reduced config in each package, window 8."""
    return (_windowed(jax_reduced(base(jax_get_config))),
            _windowed(reduced_config(base(get_config))))


def _numpy_tree(cfg, seed):
    """Weights made by the port's ``init`` (seeded; far quicker than the
    JAX package's eager init), in the JAX package's layout as numpy."""
    return to_numpy(init(cfg, seed=seed, device="cpu"))


@pytest.fixture(scope="module")
def setups():
    """family -> (jcfg, cfg, JAX params, port params) on the same
    weights, window 8."""
    out = {}
    for name, base in FAMILIES.items():
        jcfg, cfg = _pair(base)
        tree = _numpy_tree(cfg, 0)
        out[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                     from_jax(tree, cfg, device="cpu"))
    return out


def _kw(**over):
    kw = dict(num_slots=3, page_size=PAGE, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=2, temperature=0.0)
    kw.update(over)
    return kw


def _drive(eng, submits):
    handles = [eng.submit(*a) for a in submits]
    while eng.step():
        pass
    return handles


def _rows(handles):
    return [r.tolist() for h in handles for r in h.host_rows()]


def _against_jax(setup, prompts=PROMPTS, **over):
    """Greedy runs of both engines at the same settings: tokens, captured
    logprobs, decode steps, reclaimed and peak pages equal; every page
    back to the freelist."""
    jcfg, cfg, jparams, params = setup
    jeng = JaxEngine(jcfg, **_kw(**over))
    jeng.set_params(jparams)
    # wait for each JAX block: its CPU call may alias the host page table
    # it rewrites at the next drain (tests/test_torch_device_loop.py)
    decode = jeng._decode
    jeng._decode = lambda *a: jax.block_until_ready(decode(*a))
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(**over))
    eng.set_params(params)
    jh = _drive(jeng, [(p, jax.random.PRNGKey(i))
                       for i, p in enumerate(prompts)])
    th = _drive(eng, [(p, i) for i, p in enumerate(prompts)])
    assert _rows(th) == _rows(jh)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b.result(0).response_logprobs.numpy(),
                                   np.asarray(a.result(0).response_logprobs),
                                   atol=1e-4, rtol=1e-4)
    assert eng.reclaimed_pages == jeng.reclaimed_pages > 0
    assert eng.peak_pages_used == jeng.peak_pages_used
    assert eng.decode_steps == jeng.decode_steps
    assert eng.generated_tokens == jeng.generated_tokens
    assert eng.alloc.num_live == jeng.alloc.num_live == 0
    assert eng.stats_snapshot()["reclaimed_pages"] == eng.reclaimed_pages
    return eng, jeng


def _warm_against_cold(setup, prompts, **over):
    """The port's radix engine greedy (warm) against its engine without
    the cache (cold) and the JAX engine without it: tokens and captured
    logprobs equal, the tree hit, only the tree's pages live after."""
    jcfg, cfg, jparams, params = setup
    jeng = JaxEngine(jcfg, **_kw(**over))
    jeng.set_params(jparams)
    jh = _drive(jeng, [(p, jax.random.PRNGKey(i))
                       for i, p in enumerate(prompts)])
    runs = []
    for prefix in (False, True):
        eng = PagedGroupEngine(cfg, device="cpu", prefix_cache=prefix,
                               **_kw(**over))
        eng.set_params(params)
        runs.append((eng, _drive(eng, [(p, i)
                                       for i, p in enumerate(prompts)])))
    (cold, ch), (warm, wh) = runs
    assert _rows(wh) == _rows(ch) == _rows(jh)
    for a, b in zip(ch, wh):
        np.testing.assert_allclose(b.result(0).response_logprobs.numpy(),
                                   a.result(0).response_logprobs.numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert warm.prefix_hit_pages > 0 and warm.warm_prefills > 0
    assert warm.alloc.num_live == warm.radix.cached_pages
    assert all(warm.alloc.refcount(p) == 1 for p in warm.radix.pages())
    assert cold.reclaimed_pages > 0 and cold.alloc.num_live == 0
    return warm


# ---------------------------------------------------------------------
# configs and page geometry
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_context_variant_matches_jax(arch):
    """Window 8192 by default, any window on request, and a no-op for a
    config that already has one; every field both configs share equal.
    The windowed config (and deepseek-v2-lite's MoE-off ``mla_dense``)
    runs on every plane, with the reclamation reason."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for c in (cfg, mla_dense(get_config)) if cfg.use_mla else (cfg,):
        windowed = long_context_variant(c)
        for plane in ("paged", "spec", "prefix", "train"):
            ok, reason = engine_support(windowed, plane)
            assert ok and "window" in reason, (plane, reason)
    for window in (8192, 512):
        got = long_context_variant(cfg, window)
        want = jax_lcv(jcfg, window)
        assert got.sliding_window == want.sliding_window == window
        shared = {f.name for f in dataclasses.fields(got)} & \
            {f.name for f in dataclasses.fields(want)}
        for f in sorted(shared):
            assert getattr(got, f) == getattr(want, f), f
        assert long_context_variant(got) is got
    assert long_context_variant(cfg).sliding_window == 8192


def test_window_geometry_matches_jax_engine():
    """``_row_budget`` and ``_prompt_page_range`` over a grid of window,
    page, spec k, D, max_new and prompt length (host functions only)."""
    jbase = jax_reduced(jax_get_config("llama3.2-3b"))
    base = reduced_config(get_config("llama3.2-3b"))
    n = 0
    for window in (None, 8, 32, 8192):
        jcfg = dataclasses.replace(jbase, sliding_window=window)
        cfg = dataclasses.replace(base, sliding_window=window)
        for page in (4, 16):
            for spec_k in (0, 2, 4):
                for drain in (1, 3, 8):
                    kw = dict(num_slots=2, page_size=page, num_pages=0,
                              max_prompt_len=32768, max_new_tokens=256,
                              group_size=2, spec_k=spec_k,
                              drain_interval=drain)
                    jeng = JaxEngine(jcfg, **kw)
                    eng = PagedGroupEngine(cfg, device="cpu", **kw)
                    assert eng.P == jeng.P
                    for max_new in (1, 7, 64, 256):
                        assert eng._row_budget(max_new) == \
                            jeng._row_budget(max_new)
                    for plen in (1, 5, 31, 33, 8191, 8193, 32768):
                        assert eng._prompt_page_range(plen) == \
                            jeng._prompt_page_range(plen)
                    n += 1
    assert n == 72


# ---------------------------------------------------------------------
# the windowed engine against the JAX engine, greedy
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_windowed_engine_matches_jax_engine(setups, family, mode):
    """G 2 rows a group on 3 slots, 16 new tokens behind prompts of 3-16
    tokens: rows are admitted out of lock-step and both prompt and
    response pages slide out of the window. Radix: the second and later
    prompts find the system prompt's pages in the tree, and the last one
    (16 tokens) prefills a suffix whose first query sees page 1, below
    its first live page: warm tokens equal cold ones."""
    over = MODES[mode]
    if mode == "radix":
        _warm_against_cold(setups[family], SHARED)
        return
    eng, jeng = _against_jax(setups[family], **over)
    if mode == "spec":
        assert eng.spec_steps > 0 and \
            eng.accepted_tokens == jeng.accepted_tokens


def test_windowed_moe_engine_matches_jax_engine(setups):
    """Reduced deepseek-v2-lite with MoE on, plain paged, at the JAX
    engine's slots and D (a MoE token depends on its forward's other
    tokens, so no invariance is assumed)."""
    _against_jax(setups["moe"])


@pytest.mark.parametrize("spec_k", [0, 2])
def test_windowed_budget_pool_completes(setups, spec_k):
    """The O(window) residency claim: a pool of the windowed admission
    budget (live prompt pages + G x ``_row_budget``), too small for the
    full history, completes a 32-token decode because out-of-window pages
    go back to the freelist mid-flight; peak occupancy stays within it.
    No token stops a row (eos_id -1), so every row decodes all 32. Both
    engines agree on tokens, reclaimed and peak pages."""
    jcfg, cfg, jparams, params = setups["gqa"]
    G, T_long = 4, 32
    prompt = np.asarray([1, 9, 4, 7, 3, 8, 2], np.int32)
    kw = dict(num_slots=G, page_size=PAGE, max_prompt_len=LP,
              max_new_tokens=T_long, group_size=G, temperature=0.0,
              eos_id=-1, spec_k=spec_k)
    budget = PagedGroupEngine(cfg, device="cpu", num_pages=0,
                              **kw)._row_budget(T_long)
    n_resp = T_long // PAGE
    assert budget < n_resp
    num_pages = FIRST_PAGE + 2 + G * budget
    assert num_pages < FIRST_PAGE + 2 + G * n_resp      # full history
    out = []
    for mk, p, key in ((PagedGroupEngine, params, 0),
                       (JaxEngine, jparams, jax.random.PRNGKey(0))):
        eng = mk(jcfg if mk is JaxEngine else cfg, num_pages=num_pages,
                 **kw, **({} if mk is JaxEngine else {"device": "cpu"}))
        eng.set_params(p)
        free0 = eng.alloc.num_free
        (h,) = _drive(eng, [(prompt, key)])
        assert [len(r) for r in h.host_rows()] == [T_long] * G
        assert eng.reclaimed_pages >= G * (n_resp - budget)
        assert eng.peak_pages_used <= 2 + G * budget
        assert eng.alloc.num_free == free0 and eng.idle
        out.append((_rows([h]), eng.reclaimed_pages, eng.peak_pages_used))
    assert out[0] == out[1]


def test_radix_tree_under_a_window(setups):
    """A 24-token prompt twice (window 8, page 4): the first response
    query sees pages 4 and 5 (j0 4), and the cold prefill caches one
    window more, pages 2..5; pages 0 and 1 stay placeholders in the tree.
    The second request matches page 4 and, for its suffix's first query
    (position 20, which sees keys 13..20), page 3 below j0: one live hit,
    warm tokens equal cold ones and the JAX engine's cold ones."""
    prompt = np.arange(3, 27, dtype=np.int32)
    warm = _warm_against_cold(setups["gqa"], [prompt, prompt],
                              group_size=1, max_prompt_len=32)
    assert warm.radix.cached_pages == 4 and warm.radix.num_nodes == 6
    assert warm.prefix_hit_pages == 1 and warm.prefills == 1
    assert warm._cold_first_page(len(prompt)) == 2
    assert warm._radix_match(prompt, 4)[:2] == (3, 5)


def test_sampled_windowed_tokens_do_not_depend_on_drain_or_slots(setups):
    """Sampled draws are a function of (key, row, step): D 1 == D 3 ==
    D 8, and one slot == three slots, with pages reclaimed in each run;
    another key draws other tokens."""
    _, cfg, _, params = setups["gqa"]
    runs = {}
    for slots, drain, key in ((3, 1, 5), (3, 3, 5), (3, 8, 5), (1, 3, 5),
                              (3, 3, 6)):
        eng = PagedGroupEngine(cfg, device="cpu", **_kw(
            num_slots=slots, temperature=1.0, drain_interval=drain))
        eng.set_params(params)
        runs[slots, drain, key] = _rows(_drive(
            eng, [(p, (key, i)) for i, p in enumerate(PROMPTS)]))
        assert eng.reclaimed_pages > 0 and eng.alloc.num_live == 0
    want = runs[3, 1, 5]
    assert runs[3, 3, 5] == runs[3, 8, 5] == runs[1, 3, 5] == want
    assert runs[3, 3, 6] != want


# ---------------------------------------------------------------------
# the training plane
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "mla_dense"])
def test_windowed_grad_step_matches_jax(arch, port_rope_freqs):
    """An SPA-packed recompute step with a window of 8: positions in the
    packed row reach 20, so the mask drops keys inside the row (the loss
    moves against the full-attention step), and the step still matches
    ``jax.value_and_grad`` at the bars of tests/test_torch_train.py."""
    jcfg, cfg, jtrees, ttrees = _make(arch, sliding_window=WINDOW)
    mb, jmb = _packed(spa=True, capture=False)
    tmb = grpo.to_device(mb, "cpu")
    grads, metrics = grpo.make_grad_step(cfg, RLConfig())(*ttrees, tmb)
    jgrads, jmetrics = jgrpo.make_grad_step(jcfg, JaxRL())(
        *jtrees, jgrpo.jaxify(jmb))
    atol = 1e-6 if cfg.use_mla else 1e-7      # MLA_LOSS_ATOL
    for k in ("loss", "kl", "ratio_mean", "n_tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=atol if k == "loss"
                                   else 1e-7, err_msg=k)
    _assert_tree_close(grads, jgrads)
    full = dataclasses.replace(cfg, sliding_window=None)
    _, m_full = grpo.make_grad_step(full, RLConfig())(*ttrees, tmb)
    assert abs(float(m_full["loss"]) - float(metrics["loss"])) > 1e-4


def test_windowed_pipeline_matches_jax_trajectory():
    """Two async iterations of the windowed reduced llama on scripted
    rollouts (SPA packing, window 8): strictly on-policy, and the
    parameters track the JAX ``build_pipeline``'s at the bar of
    tests/test_torch_pipeline.py."""
    jcfg, cfg = _pair(FAMILIES["gqa"])
    kw = dict(batch_prompts=2, shared_prompt_attention=True)
    jrl = JaxRL(mode="async", group_size=4, micro_batch=2,
                num_inference_instances=2, max_prompt_len=24,
                max_response_len=8, learning_rate=1e-3, seed=0, **kw)
    jsched, jparts = jax_pipeline(jcfg, jrl, seed=0, scripted_fn=jax_scripted)
    # the port starts from the weights the JAX pipeline made from the seed
    jparams = jax.device_get(jparts["tri"].policy)
    jsched.run(2)
    sched, parts = build_pipeline(
        cfg, _rl("async", **kw), seed=0, scripted_fn=scripted, device="cpu",
        params=from_jax(jparams, cfg, device="cpu"))
    hist = sched.run(2)
    assert all(s.max_staleness == 0 for s in hist)
    assert [s.trained_tokens for s in hist] == \
        [s.trained_tokens for s in jsched.history]
    want = jax.device_get(jparts["tri"].policy)
    got = to_numpy(parts["tri"].policy)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5,
                                   rtol=5e-4)

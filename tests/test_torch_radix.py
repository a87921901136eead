"""The port's radix prefix cache against the JAX package on the CPU.

The tree alone: the same sequence of ``lookup``, ``insert`` and ``evict``
calls on the port's and the JAX ``RadixCache`` gives the same results,
pages and refcounts. In the engine (reduced llama3.2-3b, and reduced
``mla_dense``, deepseek-v2-lite with MoE off, whose pages hold latent
rows; f32, page 4, the same weights through ``convert.py``): warm
(radix-served) tokens identical to cold with spec off and on;
``prefix_hit_pages`` equal to the JAX engine's on the same submit order;
a warm suffix prefill's last-token logits against the cold prefill's;
eviction under a tight pool; and ``serve_shared`` against the JAX
``serve_shared``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.paged import PageAllocator as JaxAllocator  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.core.radix import RadixCache as JaxRadix  # noqa: E402
from repro.launch.serve import serve_shared as jax_serve_shared  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import engine_support  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.paged import (FIRST_PAGE, PageAllocator,  # noqa: E402
                                    PagedGroupEngine)
from repro_torch.core.radix import RadixCache  # noqa: E402
from repro_torch.launch.serve import serve_shared  # noqa: E402
from test_torch_mla import mla_dense  # noqa: E402

K = 3
LP, T, PAGE = 24, 10, 4
SYSTEM = [1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 3, 4]      # three full pages


# ---------------------------------------------------------------------
# the tree against JAX's
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_cache_matches_jax_call_by_call(seed):
    """Random prompts over a small alphabet (so prefixes collide): rows
    allocate pages, insert them, finish (dropping their references) and
    the trees evict under pressure; every call's result, the tree's pages
    and every refcount agree after each step."""
    rng = np.random.RandomState(seed)
    ours_a, theirs_a = PageAllocator(40), JaxAllocator(40)
    ours, theirs = RadixCache(PAGE, ours_a), JaxRadix(PAGE, theirs_a)
    live = []                                  # rows' page references
    for step in range(60):
        op = rng.choice(["admit", "finish", "evict"], p=[0.5, 0.3, 0.2])
        if op == "admit":
            n = rng.randint(2, 6) * PAGE + rng.randint(0, PAGE)
            prompt = rng.randint(3, 5, size=n).astype(np.int32)
            got, want = ours.lookup(prompt), theirs.lookup(prompt)
            assert got == want
            m, mpages = got
            n_pp = -(-n // PAGE)
            if ours_a.num_free < n_pp - m:
                continue
            new = ours_a.alloc(n_pp - m)
            assert new == theirs_a.alloc(n_pp - m)
            ours_a.retain(mpages)
            theirs_a.retain(mpages)
            pages = list(mpages) + new
            full = {j: pages[j] for j in range(n // PAGE)}
            assert ours.insert(prompt, full) == theirs.insert(prompt, full)
            live.append(pages)
        elif op == "finish" and live:
            pages = live.pop(rng.randint(len(live)))
            assert ours_a.release(pages) == theirs_a.release(pages)
        else:
            want_n = rng.randint(1, 4)
            protect = set(live[-1]) if live else set()
            assert ours.evict(want_n, protect) == theirs.evict(want_n,
                                                              protect)
        assert sorted(ours.pages()) == sorted(theirs.pages())
        assert ours.num_nodes == theirs.num_nodes
        assert ours.cached_pages == theirs.cached_pages
        assert all(ours_a.refcount(p) == theirs_a.refcount(p)
                   for p in range(40))
        assert ours_a.num_free == theirs_a.num_free


def test_radix_rejects_partial_page_insert_and_dead_retain():
    a = PageAllocator(8)
    tree = RadixCache(PAGE, a)
    pages = a.alloc(2)
    with pytest.raises(AssertionError, match="COMPLETE"):
        tree.insert(np.arange(6, dtype=np.int32), {0: pages[0],
                                                   1: pages[1]})
    with pytest.raises(RuntimeError, match="dead page"):
        a.retain([7])
    a.retain(pages, n=2)
    assert a.refcount(pages[0]) == 3 and a.refcount(7) == 0


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------

# the reduced configs of the two families with prefix pages, built by each
# package (tests/test_radix.py's "gqa" and "mla" variants)
ARCHS = {"llama": lambda get: get("llama3.2-3b"), "mla_dense": mla_dense}


@pytest.fixture(scope="module", params=list(ARCHS))
def setup(request):
    jcfg = jax_reduced(ARCHS[request.param](jax_get_config))
    cfg = reduced_config(ARCHS[request.param](get_config))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


def _prompts(n_reqs, tail=2):
    return [np.asarray(SYSTEM + [40 + tail * i + d for d in range(tail)],
                       np.int32) for i in range(n_reqs)]


def _kw(**over):
    kw = dict(num_slots=3, page_size=PAGE, num_pages=64, max_prompt_len=LP,
              max_new_tokens=T, group_size=1, temperature=0.0,
              capture_logprobs=False)
    kw.update(over)
    return kw


def _serve(eng, prompts, keys):
    hs = [eng.submit(p, k) for p, k in zip(prompts, keys)]
    while eng.step():
        pass
    return [h.host_rows()[0].tolist() for h in hs]


@pytest.mark.parametrize("spec_k", [0, K])
def test_warm_tokens_identical_to_cold(setup, spec_k):
    """Greedy radix-served tokens equal cold-cache tokens and the JAX
    engine's, with and without spec decode; prefix_hit_pages equals the
    JAX engine's on the same submit order; after the drain only the tree's
    pages stay live, one reference each."""
    jcfg, cfg, jparams, params = setup
    prompts = _prompts(4)
    cold = PagedGroupEngine(cfg, device="cpu", **_kw(spec_k=spec_k))
    cold.set_params(params)
    warm = PagedGroupEngine(cfg, device="cpu",
                            **_kw(spec_k=spec_k, prefix_cache=True))
    warm.set_params(params)
    jeng = JaxEngine(jcfg, **_kw(spec_k=spec_k, prefix_cache=True))
    jeng.set_params(jparams)
    want = _serve(cold, prompts, range(4))
    got = _serve(warm, prompts, range(4))
    jgot = _serve(jeng, prompts, [jax.random.PRNGKey(i) for i in range(4)])
    assert got == want == jgot
    assert warm.prefix_hit_pages == jeng.prefix_hit_pages > 0
    assert warm.prefix_miss_pages == jeng.prefix_miss_pages
    assert warm.prefix_inserted_pages == jeng.prefix_inserted_pages
    assert warm.warm_prefills > 0 and warm.prefills < cold.prefills
    assert warm.idle
    assert warm.alloc.num_free + warm.alloc.num_live == warm.P - FIRST_PAGE
    tree = warm.radix.pages()
    assert sorted(tree) == sorted(set(tree)) and len(tree) > 0
    assert warm.alloc.num_live == len(tree)
    assert all(warm.alloc.refcount(p) == 1 for p in tree)


def test_sampled_warm_tokens_identical_to_cold(setup):
    """Temperature 0.7: each request samples from its own generator, so
    the warm engine's different admission timing cannot perturb the
    draws."""
    _, cfg, _, params = setup
    prompts = _prompts(4, tail=5)
    out = []
    for prefix_cache in (False, True):
        eng = PagedGroupEngine(cfg, device="cpu",
                               **_kw(temperature=0.7, spec_k=K,
                                     prefix_cache=prefix_cache))
        eng.set_params(params)
        out.append(_serve(eng, prompts, [(3, i) for i in range(4)]))
    assert out[0] == out[1]


def test_warm_suffix_prefill_logits_match_cold(setup):
    """The suffix prefill through the paged route gives the last prompt
    token's logits of the cold dense prefill (CPU, f32)."""
    _, cfg, _, params = setup
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(prefix_cache=True))
    eng.set_params(params)
    first, second = _prompts(2, tail=7)
    (h1,) = [eng.submit(first, 0)]
    eng.step()                                  # cold admission
    cold_logits = h1._group.prompt_logits.clone()
    h2 = eng.submit(second, 1)
    eng.step()                                  # warm admission
    assert eng.warm_prefills == 1 and eng.prefix_hit_pages == 3
    warm_logits = h2._group.prompt_logits
    ref = PagedGroupEngine(cfg, device="cpu", **_kw())
    ref.set_params(params)
    h3 = ref.submit(second, 1)
    ref.step()
    err = float((warm_logits - h3._group.prompt_logits).abs().max())
    assert err < 1e-4, err
    assert not torch.equal(cold_logits, warm_logits)
    while eng.step():
        pass


def test_weight_flip_drops_the_tree(setup):
    """After ``set_params`` to new weights, an admission that shares the
    cached prefix gives the tokens and last-token logits of a cold
    prefill under the new weights: the tree's pages, written under the
    old weights, are released at the flip (the JAX engine keeps them).
    A later request then hits pages written under the new weights."""
    _, cfg, _, params = setup
    from repro_torch.models import init
    new_params = init(cfg, seed=1, device="cpu")
    first, second, third = _prompts(3, tail=3)
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(prefix_cache=True))
    eng.set_params(params)
    _serve(eng, [first], [0])
    assert eng.radix.cached_pages == 3 and eng.alloc.num_live == 3
    eng.set_params(new_params)
    assert eng.radix.cached_pages == 0 and eng.alloc.num_live == 0
    assert eng.prefix_evicted_pages == 3
    cold = PagedGroupEngine(cfg, device="cpu", **_kw())
    cold.set_params(new_params)
    logits = []
    for e in (eng, cold):
        h = e.submit(second, 1)
        e.step()                               # admission: the prefill
        logits.append(h._group.prompt_logits.clone())
        while e.step():
            pass
    err = float((logits[0] - logits[1]).abs().max())
    assert err < 1e-5, err
    assert eng.warm_prefills == 0 and eng.prefix_hit_pages == 0
    assert _serve(eng, [third], [2]) == _serve(cold, [third], [2])
    assert eng.warm_prefills == 1 and eng.prefix_hit_pages == 3


def test_tight_pool_evicts_idle_cached_pages(setup):
    """A pool too small to keep every cached prompt: the admission gate
    evicts idle cached pages on a deficit and every request still decodes
    the cold tokens."""
    _, cfg, _, params = setup
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, 200, size=12).astype(np.int32)
               for _ in range(4)]
    tight = _kw(num_slots=1, num_pages=FIRST_PAGE + 3 + 3, max_prompt_len=12,
                prefix_cache=True)
    eng = PagedGroupEngine(cfg, device="cpu", **tight)
    eng.set_params(params)
    cold = PagedGroupEngine(cfg, device="cpu",
                            **_kw(num_slots=1, max_prompt_len=12))
    cold.set_params(params)
    assert _serve(eng, prompts, range(4)) == _serve(cold, prompts, range(4))
    assert eng.prefix_evicted_pages > 0 and eng.idle


def test_serve_shared_matches_jax(setup):
    """serve_shared: suffix-only prefill of every request after the
    first; greedy tokens and the cache's stats equal the JAX serve_shared
    on the same weights (prompt_pages_saved = (N - 1) x system pages)."""
    jcfg, cfg, jparams, params = setup
    system = np.arange(1, 9, dtype=np.int32)               # two pages
    sufs = [np.asarray([10, 11], np.int32), np.asarray([20], np.int32),
            np.asarray([30, 31, 32], np.int32)]
    kw = dict(max_prompt_len=LP, max_new=10, page_size=PAGE,
              temperature=0.0, seed=0, spec_k=2)
    done, stats = serve_shared(cfg, system, sufs, device="cpu",
                               params=params, **kw)
    jdone, jstats = jax_serve_shared(jcfg, system, sufs, **kw)
    n_pp = len(system) // PAGE
    assert stats["prompt_pages_saved"] == jstats["prompt_pages_saved"] \
        == 2 * n_pp
    assert stats["prefix_hit_rate"] == jstats["prefix_hit_rate"]
    assert [c.response_ids.tolist() for c in done] == \
        [np.asarray(c.response_ids).tolist() for c in jdone]
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["acceptance_rate"] == pytest.approx(
        jstats["acceptance_rate"])


def test_prefix_plane_refuses_what_the_port_lacks():
    """A sliding-window config takes the radix cache (its window-dead
    leading pages are never cached); an SSM config is refused."""
    cfg = dataclasses.replace(reduced_config(get_config("llama3.2-3b")),
                              sliding_window=16)
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(prefix_cache=True))
    assert eng.radix is not None and eng.window == 16
    ok, reason = engine_support(cfg, "prefix")
    assert ok and "window-dead" in reason, reason
    cfg = dataclasses.replace(cfg, family="ssm", ssm_state_size=16)
    with pytest.raises(ValueError, match="SSM"):
        PagedGroupEngine(cfg, device="cpu", **_kw(prefix_cache=True))

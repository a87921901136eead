"""The port's paged engine against the JAX package's ``PagedGroupEngine``
on the same weights (reduced llama3.2-3b, f32, the JAX engine's default
pure-JAX path), greedy: tokens, decode steps and peak page occupancy must
be identical, and every page must return to the freelist."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import (engine_support,  # noqa: E402
                                     require_engine_support)
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.paged import PageAllocator, PagedGroupEngine  # noqa: E402

T, LP = 8, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


def _kw(G, **over):
    kw = dict(num_slots=3, page_size=4, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=G, temperature=0.0)
    kw.update(over)
    return kw


@pytest.mark.parametrize("G", [1, 3])
def test_greedy_engine_matches_jax_engine(setup, G):
    """Mixed prompt lengths (one longer than max_prompt_len, truncated to
    its tail) on 3 slots: slots are evicted and re-admitted mid-batch, and
    with G = 3 the rows of one group share its prompt pages."""
    jcfg, cfg, jparams, params = setup
    rng = np.random.RandomState(G)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (3, 10, 6, 21)]
    jeng = JaxEngine(jcfg, **_kw(G))
    jeng.set_params(jparams)
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(G))
    eng.set_params(params)
    free0 = eng.alloc.num_free
    jh = [jeng.submit(p, jax.random.PRNGKey(i)) for i, p in enumerate(prompts)]
    th = [eng.submit(p, i) for i, p in enumerate(prompts)]
    while jeng.step():
        pass
    while eng.step():
        pass
    for a, b in zip(jh, th):
        for ra, rb in zip(a.host_rows(), b.host_rows()):
            np.testing.assert_array_equal(rb, ra)
        ja, tb = a.result(0), b.result(0)
        np.testing.assert_array_equal(tb.response_ids.numpy(),
                                      np.asarray(ja.response_ids))
        np.testing.assert_array_equal(tb.response_len.numpy(),
                                      np.asarray(ja.response_len))
        # captured behavior logprobs (raw distribution) agree fp-close
        np.testing.assert_allclose(tb.response_logprobs.numpy(),
                                   np.asarray(ja.response_logprobs),
                                   atol=1e-4, rtol=1e-4)
    assert eng.decode_steps == jeng.decode_steps > T
    assert eng.peak_pages_used == jeng.peak_pages_used
    assert eng.generated_tokens == jeng.generated_tokens
    assert eng.alloc.num_free == free0 and eng.alloc.num_live == 0
    assert eng.idle and eng.stats_snapshot()["prefills"] == len(prompts)


def test_admission_waits_for_pages(setup):
    """A pool that holds one group at a time: the second group waits in
    the FIFO until the first frees its pages, and both complete."""
    _, cfg, _, params = setup
    eng = PagedGroupEngine(cfg, device="cpu",
                           **_kw(2, num_slots=4, num_pages=2 + 4 + 2 * 2))
    eng.set_params(params)
    h1 = eng.submit(np.arange(3, 19, dtype=np.int32), 0)
    h2 = eng.submit(np.arange(5, 21, dtype=np.int32), 1)
    eng.step()
    assert len(eng.sched.active_slots()) == 2      # only group 1 fits
    while eng.step():
        pass
    assert h1.done() and h2.done()
    assert eng.peak_pages_used == 8 and eng.alloc.num_free == 8


@pytest.mark.parametrize("change,match", [
    (("mla_window", dict(spec_k=2, prefix_cache=True)), "sliding-window"),
    (("window", dict(spec_k=2)), "sliding-window"),
    ("window", "sliding-window"),
    ("moe", "MoE"),
    ("ssm", "SSM"),
])
def test_engine_rejects_unported_configs(change, match):
    """Sliding-window configs (GQA and MLA, with spec decode and the radix
    cache riding along) and MoE configs build, each plane giving its
    reason (a window's is page reclamation); a windowed MoE config trains.
    An SSM config is still refused."""
    cfg = reduced_config(get_config("llama3.2-3b"))
    kw = _kw(1)
    if isinstance(change, tuple):
        change, extra = change
        kw.update(extra)
    if change in ("window", "mla_window"):
        cfg = dataclasses.replace(cfg, sliding_window=32,
                                  use_mla=change == "mla_window")
        eng = PagedGroupEngine(cfg, device="cpu", **kw)
        assert eng.window == 32 and eng.spec_k == kw.get("spec_k", 0)
        assert (eng.radix is not None) == kw.get("prefix_cache", False)
        ok, reason = engine_support(cfg, "paged")
        assert ok and match in reason and "reclaimed" in reason, reason
        for plane, word in (("spec", "reclamation"),
                            ("prefix", "window-dead")):
            ok, reason = engine_support(cfg, plane)
            assert ok and word in reason, reason
    elif change == "moe":
        # MoE is served and trained, with a sliding window too
        cfg = dataclasses.replace(cfg, num_experts=4, num_experts_per_tok=2,
                                  moe_d_ff=128)
        PagedGroupEngine(cfg, device="cpu", **kw)
        ok, reason = engine_support(cfg, "train")
        assert ok and match in reason and "aux" in reason, reason
        cfg = dataclasses.replace(cfg, sliding_window=32)
        require_engine_support(cfg, "train")
        ok, reason = engine_support(cfg, "train")
        assert ok and "32-token window" in reason, reason
    else:
        cfg = dataclasses.replace(cfg, family="ssm", ssm_state_size=16,
                                  sliding_window=32)
        with pytest.raises(ValueError, match=match):
            PagedGroupEngine(cfg, device="cpu", **kw)
        for plane in ("spec", "prefix", "train"):
            assert not engine_support(cfg, plane)[0]


def test_submit_rejects_a_group_that_never_fits(setup):
    _, cfg, _, params = setup
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(1, num_pages=2 + 5))
    eng.set_params(params)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(np.arange(3, 19, dtype=np.int32), 0)


def test_page_allocator_refcounts():
    a = PageAllocator(6)
    pages = a.alloc(2, refcount=2)
    assert a.num_free == 2 and a.alloc(3) is None
    assert a.release(pages) == 0           # one reference left each
    assert a.release(pages) == 2 and a.num_free == 4 and a.num_live == 0
    with pytest.raises(RuntimeError, match="dead page"):
        a.release(pages[:1])

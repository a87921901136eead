"""The port's spec-decode plane against the JAX package on the CPU.

The verify kernel's plain version against the JAX Pallas kernel in
interpret mode; the verify core (``verify_block`` greedy, the commit walk,
``truncate_commit``, the prompt-lookup draft) against JAX's on the same
inputs; the paged spec engine against the JAX spec engine on the same
weights (reduced llama3.2-3b, f32, page 4, k = 3), greedy; the sampled
path by property (the first committed token's marginal is the target
softmax, a rejected draft is never re-committed, tokens do not depend on
the slot count); the pipeline with spec decode and the prefix cache at
staleness 0; and the serve and train CLIs with the new flags.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.kernels import decode_attention as jax_da  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.spec import draft as jax_draft  # noqa: E402
from repro.spec import sampler as jax_sampler  # noqa: E402
from repro.spec import verify as jax_verify  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, paged_verify_attention, paged_verify_attention_plain,
    verify_attention)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.spec import (PromptLookupDraft, assemble_commit,  # noqa: E402
                              commit_block, make_draft_provider,
                              truncate_commit, verify_block)

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
G, T, LP, K = 4, 10, 16, 3
INVALID = 2 ** 30


# ---------------------------------------------------------------------
# the verify kernel's plain version against the JAX kernel (interpret)
# ---------------------------------------------------------------------

def _verify_pool(seed, S, H, Hkv, D):
    """Three rows over a pool of page 4: rows 0 and 1 hold 7 and 10
    tokens whose last S are the verify block, row 2 is fresh (its block's
    last slot masked at pos 2^30, which sees every slot, null page
    included). Contexts stay under the JAX kernel's 256-key block, so JAX
    pads no keys a 2^30 query could see."""
    rng = np.random.RandomState(seed)
    page = 4
    lens = (max(7, S), max(10, S + 1), max(5, S))
    P = 2 + sum(-(-n // page) for n in lens)
    k_pages = rng.randn(P, page, Hkv, D).astype(np.float32)
    v_pages = rng.randn(P, page, Hkv, D).astype(np.float32)
    pos = np.full((P, page), INVALID, np.int32)
    table = np.zeros((3, 6), np.int32)
    nxt = 2
    for b, n in enumerate(lens):
        for j in range(-(-n // page)):
            table[b, j] = nxt
            p = np.arange(j * page, (j + 1) * page)
            pos[nxt] = np.where(p < n, p, INVALID)
            nxt += 1
    q_pos = np.stack([np.arange(n - S, n) for n in lens]).astype(np.int32)
    q_pos[2, -1] = INVALID
    q = rng.randn(3, S, H, D).astype(np.float32)
    return q, k_pages, v_pages, pos, table, q_pos


def _both(dtype, *arrays):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 4, 9])
@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 64), (6, 2, 128), (24, 8, 128)])
def test_paged_verify_plain_matches_jax_kernel(dtype, S, H, Hkv, D):
    q, kp, vp, pos, table, q_pos = _verify_pool(S + H, S, H, Hkv, D)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, kp, vp)
    want = jax_da.paged_verify_attention(jq, jk, jv, pos, table, q_pos,
                                         interpret=True)
    t = torch.from_numpy
    n0 = dict(LAUNCHES)
    got = paged_verify_attention(tq, tk, tv, t(pos), t(table), t(q_pos))
    assert LAUNCHES == n0                     # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("window", [3, 6])
def test_paged_verify_plain_window_matches_jax_kernel(window):
    q, kp, vp, pos, table, q_pos = _verify_pool(1, 4, 6, 2, 64)
    q_pos[2, -1] = q_pos[2, -2] + 1           # every row sees a window key
    want = jax_da.paged_verify_attention(q, kp, vp, pos, table, q_pos,
                                         window=window, interpret=True)
    t = torch.from_numpy
    got = paged_verify_attention(t(q), t(kp), t(vp), t(pos), t(table),
                                 t(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_wrappers_match_jax_kernels(dtype):
    """decode_attention / verify_attention over a contiguous (B, L, Hkv, D)
    cache against JAX's (interpret mode)."""
    rng = np.random.RandomState(7)
    B, L, S, H, Hkv, D = 3, 24, 4, 6, 2, 64
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    lens = np.asarray([24, 9, 15])
    kv_pos = np.where(np.arange(L)[None] < lens[:, None], np.arange(L)[None],
                      INVALID).astype(np.int32)
    q_pos = (lens[:, None] - S + np.arange(S)[None]).astype(np.int32)
    q = rng.randn(B, S, H, D).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    t = torch.from_numpy
    want_v = jax_da.verify_attention(jq, jk, jv, kv_pos, q_pos,
                                     interpret=True)
    got_v = verify_attention(tq, tk, tv, t(kv_pos), t(q_pos))
    np.testing.assert_allclose(got_v.float().numpy(),
                               np.asarray(want_v, np.float32), **TOL[dtype])
    want_d = jax_da.decode_attention(jq[:, 0], jk, jv, kv_pos, q_pos[:, 0],
                                     interpret=True)
    got_d = decode_attention(tq[:, 0], tk, tv, t(kv_pos), t(q_pos[:, 0]))
    np.testing.assert_allclose(got_d.float().numpy(),
                               np.asarray(want_d, np.float32), **TOL[dtype])


def test_verify_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros((1, 2, 4, 64), device="meta")
    p = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_verify_attention(q, q, q, p, p, p[:, :2])
    with pytest.raises(ValueError, match="no kernel"):
        verify_attention(q, q, q, p, p[:, :2])
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q[:, 0], q, q, p, p[:, 0])


# ---------------------------------------------------------------------
# the verify core against JAX's
# ---------------------------------------------------------------------

def _logits_and_drafts(seed, B=5, k=4, V=64, hit=0.6):
    """Logits with a clear argmax and drafts that are the argmax with
    probability ``hit`` (so runs of accepts of every length occur)."""
    rng = np.random.RandomState(seed)
    lg = (rng.randn(B, k + 1, V) * 3).astype(np.float32)
    arg = lg.argmax(-1)
    draft = np.where(rng.rand(B, k) < hit, arg[:, :k],
                     rng.randint(0, V, (B, k))).astype(np.int32)
    return lg, draft


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_verify_block_bitwise_equal_to_jax(seed):
    lg, draft = _logits_and_drafts(seed)
    B = lg.shape[0]
    want = jax_verify.verify_block(
        jnp.asarray(lg), jnp.asarray(draft), jnp.zeros((B, 2), jnp.uint32),
        jnp.zeros((B,), jnp.int32), temperature=0.0, top_p=1.0)
    got = verify_block(torch.from_numpy(lg), torch.from_numpy(draft),
                       None, None, temperature=0.0, top_p=1.0)
    for g, w in zip(got[:2], want[:2]):       # accept, alt: bitwise
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):       # raw logprobs
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_commit_walk_equal_to_jax(seed):
    rng = np.random.RandomState(seed)
    B, k = 6, 4
    accept = rng.rand(B, k) < 0.6
    accept[0] = True                          # a clean sweep: bonus token
    accept[1] = False                         # rejected at once
    alt = rng.randint(0, 100, (B, k + 1)).astype(np.int32)
    draft = rng.randint(0, 100, (B, k)).astype(np.int32)
    lp_d = -rng.rand(B, k).astype(np.float32)
    lp_a = -rng.rand(B, k + 1).astype(np.float32)
    want = jax_verify.commit_block(*map(jnp.asarray,
                                        (accept, alt, draft, lp_d, lp_a)))
    got = commit_block(*map(torch.from_numpy, (accept, alt, draft, lp_d,
                                               lp_a)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(B):
        assert assemble_commit(accept[b], alt[b], draft[b], lp_d[b],
                               lp_a[b]) == jax_verify.assemble_commit(
            accept[b], alt[b], draft[b], lp_d[b], lp_a[b])


@pytest.mark.parametrize("ct,remaining", [
    ([5, 6, 7], 10), ([5, 2, 7], 10), ([5, 6, 7, 8], 2), ([2], 1), ([9], 3)])
def test_truncate_commit_equal_to_jax(ct, remaining):
    cl = [-0.5 * (i + 1) for i in range(len(ct))]
    assert truncate_commit(list(ct), list(cl), remaining, 2) == \
        jax_sampler.truncate_commit(list(ct), list(cl), remaining, 2)


def test_prompt_lookup_draft_equal_to_jax():
    rng = np.random.RandomState(0)
    contexts = [rng.randint(3, 9, size=n).astype(np.int32)
                for n in (1, 2, 5, 12, 30)]
    contexts.append(np.asarray([4, 5, 6, 4, 5, 6, 4, 5], np.int32))
    ours, theirs = PromptLookupDraft(len(contexts)), \
        jax_draft.PromptLookupDraft(len(contexts))
    for s, c in enumerate(contexts):
        ours.start(s, c)
        theirs.start(s, c)
    for step in range(4):
        slots = list(range(len(contexts)))
        a, b = ours.propose(slots, 4), theirs.propose(slots, 4)
        np.testing.assert_array_equal(a, b)
        for s in slots:
            ours.commit(s, a[s, : step + 1])
            theirs.commit(s, b[s, : step + 1])
    ours.stop(0)
    assert ours._ctx[0] is None


def test_model_draft_is_refused():
    """``"model"`` builds the resident draft model (half the target's
    depth, its own weights); an unknown kind is still refused."""
    from repro_torch.spec import ModelDraft
    cfg = reduced_config(get_config("llama3.2-3b"))
    kw = dict(spec_k=2, max_prompt_len=8, max_new_tokens=4, device="cpu")
    draft = make_draft_provider("model", cfg, 2, **kw)
    assert isinstance(draft, ModelDraft)
    assert draft.cfg.num_layers == cfg.num_layers // 2
    assert draft.L == 8 + 4 + 2 + 2
    with pytest.raises(KeyError, match="unknown draft"):
        make_draft_provider("oracle", cfg, 2, **kw)
    assert isinstance(make_draft_provider("prompt_lookup", cfg, 2, **kw),
                      PromptLookupDraft)


# ---------------------------------------------------------------------
# the paged spec engine against the JAX spec engine (greedy)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


PROMPTS = [np.asarray([1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 3, 4], np.int32),
           np.asarray([1, 9, 4, 7, 9, 4, 7, 9], np.int32),
           np.asarray([1, 2, 3], np.int32)]


def _kw(group, **over):
    kw = dict(num_slots=3, page_size=4, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=group, temperature=0.0)
    kw.update(over)
    return kw


def _drive(eng, submits):
    handles = [eng.submit(*a) for a in submits]
    while eng.step():
        pass
    return handles


@pytest.mark.parametrize("group", [1, 4])
def test_paged_spec_greedy_matches_jax_engine(setup, group):
    """Tokens identical to the JAX spec engine and to the port's own
    non-spec engine; decode_steps and rolled_back_pages equal to JAX's
    (some pages roll back); every page free at the end; captured
    logprobs within 1e-5 of JAX's."""
    jcfg, cfg, jparams, params = setup
    jeng = JaxEngine(jcfg, **_kw(group, spec_k=K))
    jeng.set_params(jparams)
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(group, spec_k=K))
    eng.set_params(params)
    plain = PagedGroupEngine(cfg, device="cpu", **_kw(group))
    plain.set_params(params)
    free0 = eng.alloc.num_free
    n0 = dict(LAUNCHES)
    jh = _drive(jeng, [(p, jax.random.PRNGKey(i))
                       for i, p in enumerate(PROMPTS)])
    th = _drive(eng, [(p, i) for i, p in enumerate(PROMPTS)])
    ph = _drive(plain, [(p, i) for i, p in enumerate(PROMPTS)])
    assert LAUNCHES == n0
    for a, b, c in zip(jh, th, ph):
        ja, tb, pc = a.result(0), b.result(0), c.result(0)
        np.testing.assert_array_equal(tb.response_ids.numpy(),
                                      np.asarray(ja.response_ids))
        np.testing.assert_array_equal(tb.response_len.numpy(),
                                      np.asarray(ja.response_len))
        np.testing.assert_array_equal(tb.response_ids.numpy(),
                                      pc.response_ids.numpy())
        np.testing.assert_allclose(tb.response_logprobs.numpy(),
                                   np.asarray(ja.response_logprobs),
                                   atol=1e-5, rtol=0)
    assert eng.decode_steps == jeng.decode_steps < plain.decode_steps
    assert eng.rolled_back_pages == jeng.rolled_back_pages > 0
    assert eng.spec_steps == jeng.spec_steps
    assert eng.accepted_tokens == jeng.accepted_tokens
    assert eng.alloc.num_free == free0 and eng.alloc.num_live == 0
    assert 0.0 < eng.acceptance_rate < 1.0 and eng.idle


def test_paged_spec_tight_pool_keeps_credits_symmetric(setup):
    """A pool that holds barely more than one group: rows trickle in as
    pages free, speculative pages never outrun the credits, and every
    page returns."""
    _, cfg, _, params = setup
    eng = PagedGroupEngine(cfg, device="cpu",
                           **_kw(G, num_slots=8, num_pages=2 + 13,
                                 max_new_tokens=8, spec_k=K))
    eng.set_params(params)
    ref = PagedGroupEngine(cfg, device="cpu",
                           **_kw(G, num_slots=8, max_new_tokens=8))
    ref.set_params(params)
    subs = [(p, i) for i, p in enumerate(PROMPTS)]
    for a, b in zip(_drive(eng, subs), _drive(ref, subs)):
        np.testing.assert_array_equal(a.result(0).response_ids.numpy(),
                                      b.result(0).response_ids.numpy())
    assert eng.alloc.num_free == 13 and eng._outstanding == 0


# ---------------------------------------------------------------------
# the sampled path
# ---------------------------------------------------------------------

from conftest import optional_hypothesis  # noqa: E402

_hyp = optional_hypothesis()
N_MC = 4096            # row seeds per example; TV error ~ sqrt(V / N)


def _first_committed(lg, draft_tok, temperature, top_p, seed):
    V = len(lg)
    logits = torch.tensor(lg, dtype=torch.float32)[None, None].expand(
        N_MC, 2, V).contiguous()
    draft = torch.full((N_MC, 1), draft_tok, dtype=torch.int32)
    seeds = torch.arange(N_MC, dtype=torch.int64) + seed * N_MC
    accept, alt, _, _ = verify_block(logits, draft, seeds,
                                     torch.zeros(N_MC, dtype=torch.int64),
                                     temperature=temperature, top_p=top_p)
    return accept[:, 0].numpy(), alt[:, 0].numpy()


if _hyp is not None:
    given, settings, st = _hyp
    _SETTINGS = settings(max_examples=8, deadline=None, derandomize=True)
    _vectors = st.lists(st.floats(-4.0, 4.0), min_size=4, max_size=6)

    @_SETTINGS
    @given(_vectors, st.integers(0, 3),
           st.sampled_from([(1.0, 1.0), (0.7, 1.0), (1.0, 0.9)]),
           st.integers(0, 2 ** 20))
    def test_first_committed_token_matches_target_softmax(lg, draft_tok, tt,
                                                          seed):
        from repro_torch.rl.rollout import _filter_logits
        temperature, top_p = tt
        accept, alt = _first_committed(lg, draft_tok, temperature, top_p,
                                       seed)
        toks = np.where(accept, draft_tok, alt)
        target = torch.softmax(_filter_logits(
            torch.tensor([lg], dtype=torch.float32), temperature, top_p)[0],
            dim=-1).numpy()
        emp = np.bincount(toks, minlength=len(lg)) / N_MC
        assert 0.5 * np.abs(emp - target).sum() < 0.06

    @_SETTINGS
    @given(_vectors, st.integers(0, 3), st.integers(0, 2 ** 20))
    def test_rejected_draft_never_recommitted(lg, draft_tok, seed):
        accept, alt = _first_committed(lg, draft_tok, 1.0, 1.0, seed)
        assert (alt[~accept] != draft_tok).all()


def test_sampled_verify_draws_a_fixed_count_per_row():
    """A verify step's draws are a pure function of (row seed, committed
    length rc, lane): every live row draws its k+1 accept uniforms and
    k+1 Gumbel vectors from its own streams, whatever it accepts and
    whichever rows share the batch. The same rows verified alone, in
    another order, give the same outputs; another rc gives other draws."""
    lg, draft = _logits_and_drafts(5, B=3, k=3, V=32)
    lg, draft = torch.from_numpy(lg), torch.from_numpy(draft)
    seeds = torch.tensor([11, -7, 2 ** 40 + 3], dtype=torch.int64)
    rc = torch.tensor([0, 5, 9], dtype=torch.int64)
    kw = dict(temperature=0.8, top_p=1.0)
    batch = verify_block(lg, draft, seeds, rc, **kw)
    for b in (2, 0, 1):
        alone = verify_block(lg[b:b + 1], draft[b:b + 1], seeds[b:b + 1],
                             rc[b:b + 1], **kw)
        for x, y in zip(batch, alone):
            assert torch.equal(x[b], y[0])
    # a uniform logit row: the accept uniforms decide, so rc must matter
    flat = torch.zeros_like(lg)
    runs = [verify_block(flat, draft, seeds, rc + d, **kw) for d in (0, 1)]
    assert not (torch.equal(runs[0][0], runs[1][0])
                and torch.equal(runs[0][1], runs[1][1]))


def test_sampled_spec_tokens_do_not_depend_on_slot_count(setup):
    """Temperature 0.7 with spec: the same requests through 1 slot and
    through 3 slots give identical tokens per request, and the seed
    matters."""
    _, cfg, _, params = setup
    rng = np.random.RandomState(3)
    prompts = [rng.randint(3, 40, size=(rng.randint(3, 14),)).astype(np.int32)
               for _ in range(5)]
    out = {}
    for slots in (1, 3):
        reqs, _, stats = serve_requests(
            cfg, prompts, max_prompt_len=16, max_new=8, num_slots=slots,
            page_size=4, temperature=0.7, seed=5, params=params,
            device="cpu", spec_k=K)
        out[slots] = [r.tokens for r in reqs]
        assert stats["spec_k"] == K
    assert out[1] == out[3]
    reqs, _, _ = serve_requests(cfg, prompts, max_prompt_len=16, max_new=8,
                                num_slots=3, page_size=4, temperature=0.7,
                                seed=6, params=params, device="cpu",
                                spec_k=K)
    assert [r.tokens for r in reqs] != out[1]


def test_sampled_spec_group_rows_differ_and_pages_return(setup):
    _, cfg, _, params = setup
    eng = PagedGroupEngine(cfg, device="cpu",
                           **_kw(G, num_slots=2, max_new_tokens=12,
                                 temperature=1.0, top_p=0.9, spec_k=K))
    eng.set_params(params)
    free0 = eng.alloc.num_free
    (h,) = _drive(eng, [(PROMPTS[0], 7)])
    out = h.result(0)
    ids = out.response_ids.numpy()
    assert (out.response_len.numpy() >= 1).all()
    assert np.isfinite(out.response_logprobs.numpy()).all()
    assert not all(np.array_equal(ids[0], ids[i]) for i in range(1, G))
    assert eng.alloc.num_free == free0 and eng.idle


# ---------------------------------------------------------------------
# the pipeline and the CLIs
# ---------------------------------------------------------------------

def _rl(mode, **kw):
    base = dict(mode=mode, batch_prompts=2, group_size=3, micro_batch=3,
                num_inference_instances=1, max_prompt_len=24,
                max_response_len=6, learning_rate=1e-3,
                rollout_engine="paged", cbatch_slots=4, kv_page_size=8,
                temperature=0.0, spec_decode=True, spec_k=2,
                prefix_cache=True, seed=0)
    base.update(kw)
    return RLConfig(**base)


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_pipeline_with_spec_and_prefix_cache(setup):
    """Async with spec decode and the radix cache: staleness 0 on every
    iteration, the engine reports spec and prefix counters, and sync ==
    async greedy. Each group's tokens and captured logprobs, matched by
    (version, uid), are bitwise equal; the parameters after two iterations
    are held at Proposition 1's bar, because async sums the gradients in
    completion order and sync in uid order, and f32 addition is not
    associative (``GradAccumulator.add``)."""
    _, cfg, _, params = setup
    runs, groups = {}, {}
    for mode in ("sync", "async"):
        sched, parts = build_pipeline(cfg, _rl(mode), seed=0, device="cpu",
                                      params=params)
        seen = groups[mode] = {}

        def record(g, acc, seen=seen, train_group=sched._train_group):
            seen[(g.weight_version, g.uid)] = (g.response_ids.copy(),
                                               g.response_logprobs.copy())
            return train_group(g, acc)
        sched._train_group = record
        hist = sched.run(2)
        assert all(s.max_staleness == 0 and s.trained_tokens > 0
                   for s in hist)
        eng = parts["pool"].instances[0].paged_engine
        assert eng.spec_k == 2 and eng.radix is not None and eng.idle
        stats = parts["pool"].engine_stats()
        assert stats["spec_steps"] > 0 and stats["drafted_tokens"] > 0
        assert stats["prefix_hit_pages"] + stats["prefix_miss_pages"] > 0
        runs[mode] = [t.clone() for t in _leaves(parts["tri"].policy)]
    assert sorted(groups["sync"]) == sorted(groups["async"])
    assert len(groups["sync"]) == 4
    for key, (ids, lps) in groups["sync"].items():
        np.testing.assert_array_equal(groups["async"][key][0], ids)
        np.testing.assert_array_equal(groups["async"][key][1], lps)
    for a, b in zip(runs["sync"], runs["async"]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_serve_cli_with_spec_and_prefix_cache(capsys):
    serve.main(["--device", "cpu", "--reduced", "--spec", "--prefix-cache",
                "--shared-system", "8", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "shared-system x8" in out and "prefix hit rate" in out
    assert "accept=" in out
    serve.main(["--device", "cpu", "--reduced", "--spec", "--prefix-cache",
                "--num-requests", "3", "--max-new", "5", "--slots", "2"])
    out = capsys.readouterr().out
    assert "spec k=4" in out and "tok/forward" in out


def test_train_cli_with_spec_and_prefix_cache(capsys):
    train.main(["--device", "cpu", "--reduced", "--iterations", "2",
                "--batch-prompts", "2", "--group-size", "3", "--spec",
                "--spec-k", "2", "--prefix-cache", "--max-prompt-len", "48",
                "--max-response-len", "6"])
    text = capsys.readouterr().out
    assert "iter 1:" in text and "staleness=0" in text
    assert "accept=" in text

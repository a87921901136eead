"""The port's dense spec engines against the JAX package on the CPU: the
group-at-a-time ``SpecSampler``, the resident draft model
(``ModelDraft``, ``draft_config``) on every spec engine, and the
contiguous MLA verify route.

On reduced llama3.2-3b, the same with a window of 8, reduced
``mla_dense`` and reduced deepseek-v2-lite with MoE on, f32, on the same
weights (``convert.from_jax``): the SpecSampler's greedy tokens, lengths
and every spec stat equal to JAX's, its captured logprobs within 1e-4 of
JAX's and within JAX's 5e-5 of the port's Sampler; the draft model's
proposals equal to JAX's call by call on the same draft tree, and the
SpecSampler and the paged engine with ``spec_draft="model"`` equal to the
JAX engines; ``mla_verify_attention``'s plain version against JAX's
absorbed attention over the same latent cache; ``build_pipeline`` on the
SpecSampler (one an instance; sync == async, and its rollouts and
parameters against the JAX pipeline's); the CLIs with ``--spec-draft
model``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RLConfig as JaxRL  # noqa: E402
from repro.core.paged import PagedGroupEngine as JaxPaged  # noqa: E402
from repro.launch.train import build_pipeline as jax_pipeline  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models.attention import \
    chunked_attention as jax_attention  # noqa: E402
from repro.spec import draft as jax_draft  # noqa: E402
from repro.spec.sampler import SpecSampler as JaxSpec  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    mla_verify_attention, mla_verify_attention_plain)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.rl.rollout import Sampler  # noqa: E402
from repro_torch.spec import (ModelDraft, SpecSampler,  # noqa: E402
                              draft_config)
from test_torch_pipeline import _at, _parity_reward  # noqa: E402
from test_torch_sampler import FAMILIES, LP_TOL, _pair, setups  # noqa: E402
from test_torch_train import port_rope_freqs  # noqa: E402,F401

LP, T, K = 16, 12, 2
PROMPT = np.asarray([1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 3, 4], np.int32)
_rng = np.random.RandomState(4)
# a repetitive prompt (drafts accepted), its head, two random ones (one
# longer than LP: it keeps its last LP)
PROMPTS = [PROMPT, PROMPT[:5]] + [_rng.randint(3, 500, size=(n,))
                                  .astype(np.int32) for n in (14, 21)]


@pytest.fixture
def blocking_jax_draft(monkeypatch):
    """Each JAX ``ModelDraft`` built in the test waits for every jitted
    call: ``propose`` adds the fed counts to its host frontier array
    right after dispatching a feed that may still read it (the JAX
    reference race on the CPU, ROADMAP fact E)."""
    init = jax_draft.ModelDraft.__init__

    def blocking(self, *a, **kw):
        init(self, *a, **kw)
        for name in ("_prefill_j", "_feed_j", "_kstep_j"):
            fn = getattr(self, name)
            setattr(self, name, lambda *a, fn=fn, **kw:
                    jax.block_until_ready(fn(*a, **kw)))
    monkeypatch.setattr(jax_draft.ModelDraft, "__init__", blocking)


def _draft_trees(jcfg, cfg, seed=3):
    """One draft model's weights in each package (JAX ``init`` of the
    JAX ``draft_config``)."""
    jtree = jax_init(jax.random.PRNGKey(seed), jax_draft.draft_config(jcfg))
    return jtree, from_jax(jax.device_get(jtree), draft_config(cfg),
                           device="cpu")


def _spec_pair(setup, eos=None, **kw):
    """The same greedy SpecSampler call in each package; ``kw`` goes to
    both constructors, ``draft_params`` as each package's tree."""
    jcfg, cfg, jp, p = setup
    jkw, pkw = dict(kw), dict(kw)
    if "draft_params" in kw:
        jkw["draft_params"], pkw["draft_params"] = kw["draft_params"]
    if eos is not None:
        jkw["eos_id"] = pkw["eos_id"] = eos
    jeng = JaxSpec(jcfg, LP, T, spec_k=K, temperature=0.0, **jkw)
    want = jax.device_get(jeng.generate(jp, PROMPTS, jax.random.PRNGKey(0)))
    eng = SpecSampler(cfg, LP, T, spec_k=K, temperature=0.0, device="cpu",
                      **pkw)
    return eng.generate(p, PROMPTS, 0), want, eng, jeng


def _stats(eng):
    return (eng.spec_steps, eng.drafted_tokens, eng.accepted_tokens,
            eng.committed_tokens)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_spec_sampler_greedy_matches_jax(setups, family,
                                         port_rope_freqs):  # noqa: F811
    """Greedy, twice (as drawn, then with EOS set to a token drawn
    mid-response): tokens, lengths and spec stats equal to the JAX
    SpecSampler's, captured logprobs within 1e-4 of JAX's; tokens equal
    to the port's Sampler and logprobs within JAX's 5e-5 of it (MoE off:
    a verify step routes B x (k + 1) tokens, a decode step B)."""
    got, want, eng, jeng = _spec_pair(setups[family])
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids)
    eos = int(want.response_ids[0, 5])
    got, want, eng, jeng = _spec_pair(setups[family], eos=eos)
    lens = want.response_len
    assert (lens < T).any()
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids)
    np.testing.assert_array_equal(got.response_len.numpy(), lens)
    np.testing.assert_allclose(got.response_logprobs.numpy(),
                               want.response_logprobs, **LP_TOL)
    assert _stats(eng) == _stats(jeng)
    assert eng.accepted_tokens > 0 and eng.acceptance_rate == \
        jeng.acceptance_rate
    assert eng.committed_tokens == int(lens.sum())
    if setups[family][1].is_moe:
        return
    _, cfg, _, p = setups[family]
    ref = Sampler(cfg, LP, T, temperature=0.0, eos_id=eos,
                  device="cpu").generate(p, PROMPTS, 0)
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  ref.response_ids.numpy())
    np.testing.assert_allclose(got.response_logprobs.numpy(),
                               ref.response_logprobs.numpy(), atol=5e-5,
                               rtol=0)


def test_draft_config_matches_jax():
    for family in FAMILIES:
        jcfg, cfg = _pair(family)
        jd, d = jax_draft.draft_config(jcfg), draft_config(cfg)
        assert (d.name, d.num_layers, d.vocab_size, d.d_model) == \
            (jd.name, jd.num_layers, jd.vocab_size, jd.d_model)
        assert d.num_layers == max(1, cfg.num_layers // 2)


@pytest.mark.parametrize("family", ["llama", "window", "mla_dense"])
def test_model_draft_proposals_match_jax_call_by_call(family,
                                                     blocking_jax_draft):
    """Start three slots, then propose / commit (1 or 3 tokens, one slot
    none) / stop / restart in turn: every (B, k) proposal and the
    committed frontiers equal to the JAX ``ModelDraft``'s on the same
    draft tree (its cache is never a ring, window or not)."""
    jcfg, cfg = _pair(family)
    jtree, tree = _draft_trees(jcfg, cfg)
    kw = dict(max_prompt_len=LP, max_ctx=LP + T + K + 2)
    ours = ModelDraft(draft_config(cfg), tree, 3, device="cpu", **kw)
    theirs = jax_draft.ModelDraft(jax_draft.draft_config(jcfg), jtree, 3,
                                  **kw)
    for s, p in enumerate(PROMPTS[:3]):
        ours.start(s, p)
        theirs.start(s, p)
    rng = np.random.RandomState(7)
    slots = [0, 1, 2]
    for step in range(4):
        a, b = ours.propose(slots, 3), theirs.propose(slots, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.off, theirs.off)
        for s in slots:
            n = 0 if (s == 1 and step == 1) else 1 + 2 * rng.randint(2)
            ct = list(a[s, :n])
            ours.commit(s, ct)
            theirs.commit(s, ct)
        if step == 1:
            ours.stop(2)
            theirs.stop(2)
            slots = [0, 1]
        if step == 2:
            ours.start(2, PROMPTS[3])
            theirs.start(2, PROMPTS[3])
            slots = [0, 1, 2]


@pytest.mark.parametrize("family", ["llama", "mla_dense"])
def test_model_draft_engines_match_jax(setups, family, blocking_jax_draft):
    """``draft="model"`` on the same draft tree: the SpecSampler's tokens
    and stats equal to JAX's; the paged engine with
    ``spec_draft="model"`` (its draft's weights handed over as JAX made
    them) gives JAX's tokens and ``decode_steps``, and the port's
    prompt-lookup engine's tokens (greedy spec is exact)."""
    jcfg, cfg, jp, p = setups[family]
    trees = _draft_trees(jcfg, cfg)
    got, want, eng, jeng = _spec_pair(setups[family], draft="model",
                                      draft_params=trees)
    np.testing.assert_array_equal(got.response_ids.numpy(),
                                  want.response_ids)
    np.testing.assert_array_equal(got.response_len.numpy(),
                                  want.response_len)
    assert _stats(eng) == _stats(jeng)
    kw = dict(num_slots=3, page_size=4, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=1, temperature=0.0, spec_k=K)
    jpg = JaxPaged(jcfg, spec_draft="model", **kw)
    jpg.set_params(jp)
    pg = PagedGroupEngine(cfg, spec_draft="model", device="cpu", **kw)
    pg._draft.params = from_jax(jax.device_get(jpg._draft.params),
                                draft_config(cfg), device="cpu")
    plain = PagedGroupEngine(cfg, device="cpu", **kw)
    prompts = [q[-LP:] for q in PROMPTS]
    n0 = dict(LAUNCHES)
    done = pg.serve(p, prompts, 0)
    assert LAUNCHES == n0
    jh = [jpg.submit(q, jax.random.PRNGKey(i)) for i, q in enumerate(prompts)]
    while jpg.step():
        pass
    ref = {c.request_id: c.response_ids.tolist()
           for c in plain.serve(p, prompts, 0)}
    for c in done:
        j = jh[c.request_id].result(0)
        assert c.response_ids.tolist() == np.asarray(
            j.response_ids)[0, : int(j.response_len[0])].tolist()
        assert c.response_ids.tolist() == ref[c.request_id]
    assert pg.decode_steps == jpg.decode_steps
    assert pg.accepted_tokens == jpg.accepted_tokens


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ring", [False, True])
def test_mla_verify_plain_matches_jax_absorbed_attention(window, ring):
    """S 3 latent-space queries a row at their own positions (one pad at
    2^30, which sees every slot) over a contiguous latent cache with
    unwritten slots at 2^30, in position order or rotated like a ring:
    the plain version equals JAX's absorbed attention (its
    ``chunked_attention`` over [ckv | kr] keys and ckv values) in f32."""
    rng = np.random.RandomState(2)
    B, L, S, H, r, rd = 3, 14, 3, 4, 64, 16
    ckv = rng.randn(B, L, r).astype(np.float32)
    kr = rng.randn(B, L, rd).astype(np.float32)
    lens = np.array([9, 14, 5])
    kv_pos = np.where(np.arange(L)[None] < lens[:, None],
                      np.arange(L)[None], 2 ** 30).astype(np.int32)
    if ring:
        shift = rng.randint(1, L)
        ckv, kr, kv_pos = (np.roll(a, shift, axis=1)
                           for a in (ckv, kr, kv_pos))
    q_pos = (lens[:, None] - S + np.arange(S)[None]).astype(np.int32)
    q_pos[2, -1] = 2 ** 30
    q = rng.randn(B, S, H, r + rd).astype(np.float32)
    scale = 0.125
    got = mla_verify_attention(*map(torch.from_numpy, (q, ckv, kr)),
                               torch.from_numpy(kv_pos),
                               torch.from_numpy(q_pos), scale=scale,
                               window=window)
    k_cat = np.concatenate([ckv, kr], -1)[:, :, None]
    want = jax_attention(jnp.asarray(q), jnp.asarray(k_cat),
                         jnp.asarray(ckv[:, :, None]), jnp.asarray(q_pos),
                         jnp.asarray(kv_pos),
                         jnp.zeros((B, S), jnp.int32),
                         jnp.zeros((B, L), jnp.int32), window=window,
                         scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    plain = mla_verify_attention_plain(
        *map(torch.from_numpy, (q, ckv, kr, kv_pos, q_pos)), scale=scale,
        window=window)
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------
# the pipeline on the SpecSampler, and the CLIs
# ---------------------------------------------------------------------

def _rl(pkg, mode, **kw):
    base = dict(mode=mode, batch_prompts=2, group_size=3, micro_batch=3,
                num_inference_instances=1, max_prompt_len=24,
                max_response_len=6, learning_rate=1e-3,
                rollout_engine="group", spec_decode=True, spec_k=K, seed=0)
    return pkg(**{**base, **kw})


def _recorded(sched):
    seen = {}
    train_group = sched._train_group

    def record(g, acc):
        seen[(g.weight_version, g.uid)] = (g.response_ids.copy(),
                                           g.response_logprobs.copy())
        return train_group(g, acc)
    sched._train_group = record
    return seen


def _port_run(cfg, jparams, mode, **kw):
    sched, parts = build_pipeline(cfg, _rl(RLConfig, mode, **kw), seed=0,
                                  device="cpu",
                                  params=from_jax(jparams, cfg, device="cpu"))
    assert isinstance(parts["sampler"], SpecSampler)
    parts["generator"].reward_fn = _parity_reward
    groups = _recorded(sched)
    hist = sched.run(2)
    assert all(s.max_staleness == 0 and s.trained_tokens > 0 for s in hist)
    assert parts["sampler"].spec_steps > 0
    return groups, to_numpy(parts["tri"].policy)


def test_pipeline_on_the_spec_sampler(setups):
    """``build_pipeline(rollout_engine="group", spec_decode=True)``, two
    iterations at staleness 0. Sampled (temperature 1, a token-parity
    reward, so the groups carry advantages): sync == async, each group's
    tokens and captured logprobs bitwise, the parameters at Proposition
    1's bar. Greedy, against the JAX pipeline on the same weights: the
    same groups and tokens, logprobs within 1e-4, and the parameters at
    the pipeline tests' bar; greedy groups carry no advantage (their rows
    are one row), so with ``kl_coef`` 0 both packages' updates are the
    optimizer's weight decay alone, and the check holds the rollouts and
    the update schedule, not a learning signal."""
    jcfg, cfg, _, _ = setups["llama"]
    jparams = jax.device_get(jax_init(jax.random.PRNGKey(0), jcfg))
    runs = {mode: _port_run(cfg, jparams, mode, temperature=1.0)
            for mode in ("sync", "async")}
    (g_sync, p_sync), (g_async, p_async) = runs["sync"], runs["async"]
    assert sorted(g_sync) == sorted(g_async)
    assert any(len(set(map(tuple, ids))) > 1 for ids, _ in g_sync.values())
    for key, (ids, lps) in g_sync.items():
        np.testing.assert_array_equal(g_async[key][0], ids)
        np.testing.assert_array_equal(g_async[key][1], lps)
    for a, b in zip(jax.tree_util.tree_leaves(p_sync),
                    jax.tree_util.tree_leaves(p_async)):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-4)
    greedy = dict(temperature=0.0, kl_coef=0.0)
    groups, policy = _port_run(cfg, jparams, "sync", **greedy)
    jsched, jparts = jax_pipeline(jcfg, _rl(JaxRL, "sync", **greedy), seed=0)
    jparts["generator"].reward_fn = _parity_reward
    jgroups = _recorded(jsched)
    jsched.run(2)
    assert sorted(jgroups) == sorted(groups)
    for key, (ids, lps) in groups.items():
        np.testing.assert_array_equal(np.asarray(jgroups[key][0]), ids)
        np.testing.assert_allclose(np.asarray(jgroups[key][1]), lps,
                                   **LP_TOL)
    want = jax.device_get(jparts["tri"].policy)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(_at(policy, path), np.asarray(w),
                                   atol=5e-5, rtol=5e-4, err_msg=str(path))


@pytest.mark.parametrize("draft", ["prompt_lookup", "model"])
def test_each_instance_has_its_own_spec_sampler(setups, draft):
    """Two inference instances on the SpecSampler, whose calls the
    generator's workers run at once: each instance holds its own (a
    SpecSampler keeps its draft providers and stats between calls), with
    the prompt-lookup draft and with the draft model. Both instances'
    samplers called from two threads at once give, call by call, a lone
    SpecSampler's tokens, lengths and logprobs, bitwise. Sampled sync ==
    async: the same groups and tokens, version 0's logprobs bitwise and
    version 1's within the logprob bar (the two runs' trainers sum the
    groups in arrival order, so the version-1 weights may differ in the
    last bits). ``rollout_engine="cbatch"`` refuses spec decode."""
    import threading
    jcfg, cfg, _, _ = setups["llama"]
    jparams = jax.device_get(jax_init(jax.random.PRNGKey(0), jcfg))
    kw = dict(temperature=1.0, num_inference_instances=2, spec_draft=draft)
    _, parts = build_pipeline(cfg, _rl(RLConfig, "async", **kw),
                              device="cpu")
    pair = [i.sampler for i in parts["pool"].instances]
    assert all(isinstance(x, SpecSampler) for x in pair)
    assert pair[0] is not pair[1] and parts["sampler"] is pair[0]
    weights = from_jax(jparams, cfg, device="cpu")
    calls = [[(PROMPTS[c % 2: c % 2 + 3], (w, c)) for c in range(8)]
             for w in range(2)]
    got = [[], []]
    start = threading.Barrier(2)

    def worker(w):
        start.wait()
        for prompts, key in calls[w]:
            got[w].append(pair[w].generate(weights, prompts, key))
    threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lone = SpecSampler(cfg, 24, 6, spec_k=K, draft=draft, temperature=1.0,
                       device="cpu")
    for w in (0, 1):
        assert len(got[w]) == len(calls[w])
        for (prompts, key), out in zip(calls[w], got[w]):
            want = lone.generate(weights, prompts, key)
            for a, b in zip(out, want):
                assert torch.equal(a, b), (w, key)
    runs = {mode: _port_run(cfg, jparams, mode, **kw)
            for mode in ("sync", "async")}
    (g_sync, _), (g_async, _) = runs["sync"], runs["async"]
    assert sorted(g_sync) == sorted(g_async) and len(g_sync) == 4
    for key, (ids, lps) in g_sync.items():
        np.testing.assert_array_equal(g_async[key][0], ids)
        if key[0] == 0:
            np.testing.assert_array_equal(g_async[key][1], lps)
        else:
            np.testing.assert_allclose(g_async[key][1], lps, **LP_TOL)
    with pytest.raises(ValueError, match="cbatch"):
        build_pipeline(cfg, _rl(RLConfig, "async", rollout_engine="cbatch"),
                       device="cpu")


def test_train_cli_with_a_model_draft(capsys):
    for engine in ("group", "paged"):
        train.main(["--device", "cpu", "--reduced", "--iterations", "2",
                    "--batch-prompts", "2", "--group-size", "3", "--spec",
                    "--spec-k", "2", "--spec-draft", "model",
                    "--rollout-engine", engine, "--max-prompt-len", "48",
                    "--max-response-len", "6"])
        text = capsys.readouterr().out
        assert "iter 1:" in text and "staleness=0" in text
        assert f"engine={engine}" in text and "(model draft)" in text


def test_serve_cli_with_a_model_draft(capsys):
    serve.main(["--device", "cpu", "--reduced", "--spec", "--spec-k", "2",
                "--spec-draft", "model", "--num-requests", "3",
                "--max-new", "5", "--slots", "2"])
    out = capsys.readouterr().out
    assert "spec k=2" in out and "tok/forward" in out
    serve.main(["--device", "cpu", "--reduced", "--spec", "--spec-draft",
                "model", "--shared-system", "3", "--max-new", "4"])
    assert "shared-system x3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--engine", "fixed", "--device", "cpu", "--reduced",
                    "--spec", "--spec-draft", "model"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--reduced", "--spec",
                    "--spec-draft", "oracle"])


def test_spec_engines_refuse_what_jax_refuses():
    """SSM refuses the SpecSampler; spec_k below 1 is refused."""
    _, cfg = _pair("llama")
    ssm = dataclasses.replace(cfg, family="ssm", ssm_state_size=16)
    with pytest.raises(ValueError, match="not ported"):
        SpecSampler(ssm, LP, T, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        SpecSampler(cfg, LP, T, spec_k=0, device="cpu")

"""The port's MLA serving path against the JAX package on the CPU.

``mla_dense`` is deepseek-v2-lite with MoE off, as
``benchmarks/table6_cbatch.py`` and ``tests/test_spec.py`` build it;
reduced, it has 2 layers, d 256, H 4, r 64, rd 16, nd 32, vd 32, f32.

The MLA kernel's plain versions against the JAX Pallas kernels in
interpret mode, at reduced and at full-width heads (H 16, r 512, rd 64),
with MLA's scale; ``mla_attention`` (expanded prefill, absorbed paged
decode and verify) and whole-model hidden states against JAX's on the
same weights (``convert.from_jax``); the port's paged engine against the
JAX ``PagedGroupEngine`` (its default pure-JAX path) with and without
spec decode: greedy tokens and ``decode_steps`` equal, never a step-count
inequality (with random weights prompt-lookup drafts are nearly always
rejected); MoE served but its training refused, and the radix cache and
training building on MLA.
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
from repro.core.paged import PagedGroupEngine as JaxEngine  # noqa: E402
from repro.kernels import decode_attention as jax_da  # noqa: E402
from repro.models import forward_hidden as jax_forward_hidden  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models.attention import PagedCacheBackend as JaxBackend  # noqa: E402
from repro.models.attention import attention as jax_attention  # noqa: E402
from repro.models.attention import init_attention  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.models import forward_hidden, init  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.attention import PagedCacheBackend  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

# the kernel bars of tests/test_torch_spec.py, the model bars of
# tests/test_torch_model.py
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MTOL = dict(atol=2e-4, rtol=2e-4)
INVALID = 2 ** 30
G, T, LP, K = 4, 10, 16, 3
# (H, r, rd, nd): reduced and full-width deepseek-v2-lite heads
HEADS = {"reduced": (4, 64, 16, 32), "full": (16, 512, 64, 128)}


def mla_dense(get):
    return dataclasses.replace(get("deepseek-v2-lite-16b"), num_experts=0,
                               num_experts_per_tok=0, num_shared_experts=0,
                               moe_d_ff=0, first_k_dense=0, dense_d_ff=0)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(mla_dense(jax_get_config))
    cfg = reduced_config(mla_dense(get_config))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


# ---------------------------------------------------------------------
# the kernel's plain versions against the JAX kernels (interpret)
# ---------------------------------------------------------------------

def _latent_pool(seed, S, H, r, rd):
    """Three rows over a latent pool of page 4: rows 0 and 1 hold 7 and
    10 tokens whose last S are the queries, row 2's last query is masked
    at pos 2^30 (it sees every slot, null page included). Contexts stay
    under the JAX kernel's 256-key block, so JAX pads no keys a 2^30
    query could see."""
    rng = np.random.RandomState(seed)
    page = 4
    lens = (max(7, S), max(10, S + 1), max(5, S))
    P = 2 + sum(-(-n // page) for n in lens)
    ckv = rng.randn(P, page, r).astype(np.float32)
    kr = rng.randn(P, page, rd).astype(np.float32)
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
    q = rng.randn(3, S, H, r + rd).astype(np.float32)
    return q, ckv, kr, pos, table, q_pos


def _both(dtype, *arrays):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("heads", ["reduced", "full"])
def test_paged_mla_plain_matches_jax_kernel(dtype, S, heads):
    """S == 1 through the decode pair, S > 1 through the verify pair; the
    scale is MLA's (nd + rd)^-0.5, not the wrappers' D^-0.5."""
    H, r, rd, nd = HEADS[heads]
    scale = (nd + rd) ** -0.5
    q, ckv, kr, pos, table, q_pos = _latent_pool(S + H, S, H, r, rd)
    (jq, jc, jk), (tq, tc, tk) = _both(dtype, q, ckv, kr)
    t = torch.from_numpy
    n0 = dict(LAUNCHES)
    if S == 1:
        want = jax_da.paged_mla_decode_attention(
            jq[:, 0], jc, jk, pos, table, q_pos[:, 0], scale=scale,
            interpret=True)[:, None]
        got = da.paged_mla_decode_attention(
            tq[:, 0], tc, tk, t(pos), t(table), t(q_pos[:, 0]),
            scale=scale)[:, None]
    else:
        want = jax_da.paged_mla_verify_attention(
            jq, jc, jk, pos, table, q_pos, scale=scale, interpret=True)
        got = da.paged_mla_verify_attention(tq, tc, tk, t(pos), t(table),
                                            t(q_pos), scale=scale)
    assert LAUNCHES == n0                     # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (3, S, H, r)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("window", [3, 6])
def test_paged_mla_plain_window_matches_jax_kernel(window):
    H, r, rd, nd = HEADS["reduced"]
    q, ckv, kr, pos, table, q_pos = _latent_pool(1, 4, H, r, rd)
    q_pos[2, -1] = q_pos[2, -2] + 1           # every row sees a window key
    want = jax_da.paged_mla_verify_attention(
        q, ckv, kr, pos, table, q_pos, scale=0.3, window=window,
        interpret=True)
    t = torch.from_numpy
    got = da.paged_mla_verify_attention(t(q), t(ckv), t(kr), t(pos),
                                        t(table), t(q_pos), scale=0.3,
                                        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_mla_wrappers_refuse_what_the_kernel_lacks():
    """Devices without a kernel raise; the kernel's contract (checked
    before any launch) refuses an (r, rd) it was not built for, a dtype
    it does not take and mismatched pools; ``scale`` has no default."""
    q = torch.zeros((1, 2, 4, 80), device="meta")
    c = torch.zeros((3, 4, 64), device="meta")
    k = torch.zeros((3, 4, 16), device="meta")
    p = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    tab = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        da.paged_mla_verify_attention(q, c, k, p, tab, tab, scale=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        da.paged_mla_decode_attention(q[:, 0], c, k, p, tab, tab[:, 0],
                                      scale=0.1)
    with pytest.raises(TypeError, match="scale"):
        da.paged_mla_decode_attention(q[:, 0], c, k, p, tab, tab[:, 0])
    name = "paged_mla_verify_attention"
    q, ckv, kr, pos, table, q_pos = _latent_pool(0, 2, 4, 64, 16)
    args = [torch.from_numpy(a) for a in (q, ckv, kr, pos, table, q_pos)]
    da._check_mla_cuda(name, *args, None)     # the built shape passes
    bad_r = [args[0][..., :72], args[1][..., :56]] + args[2:]
    with pytest.raises(ValueError, match="built for"):
        da._check_mla_cuda(name, *bad_r, None)
    half = [a.half() if a.is_floating_point() else a for a in args]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da._check_mla_cuda(name, *half, None)
    with pytest.raises(ValueError, match="latent pages"):
        da._check_mla_cuda(name, args[0], args[1], args[2][:2], *args[3:],
                           None)
    with pytest.raises(ValueError, match="window"):
        da._check_mla_cuda(name, *args, 0)


# ---------------------------------------------------------------------
# configs, weights, mla_attention and the whole model against JAX
# ---------------------------------------------------------------------

def test_reduced_mla_dense_config_matches_jax():
    """Every field the two ModelConfigs share, reduced and full width."""
    for reduce_t, reduce_j in ((reduced_config, jax_reduced),
                               (lambda c: c, lambda c: c)):
        cfg = reduce_t(mla_dense(get_config))
        jcfg = reduce_j(mla_dense(jax_get_config))
        shared = ({f.name for f in dataclasses.fields(cfg)}
                  & {f.name for f in dataclasses.fields(jcfg)})
        assert {"kv_lora_rank", "qk_rope_head_dim", "num_experts",
                "dense_d_ff", "attn_chunk_size"} <= shared
        for f in sorted(shared):
            assert getattr(cfg, f) == getattr(jcfg, f), f
    full = get_config("deepseek-v2-lite-16b")
    assert full == dataclasses.replace(
        full, **{f: getattr(jax_get_config("deepseek-v2-lite-16b"), f)
                 for f in ("num_experts", "first_k_dense", "dense_d_ff",
                           "num_shared_experts", "moe_d_ff")})


def test_convert_round_trips_the_mla_tree(setup):
    """from_jax carries the MLA leaves with no code of its own, and
    init makes the same tree (norms, ckv_norm included, are ones)."""
    _, cfg, jparams, params = setup
    jtree = jax.device_get(jparams)
    back = to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert set(jtree["layers"]["attn"]) == {
        "wq", "w_dkv", "w_kr", "ckv_norm", "w_uk", "w_uv", "wo"}
    mine = init(cfg, seed=0, device="cpu")
    shapes = param_shapes(cfg)
    for name, shape in shapes["layers"]["attn"].items():
        assert tuple(mine["layers"]["attn"][name].shape) == shape, name
    assert torch.equal(mine["layers"]["attn"]["ckv_norm"],
                       torch.ones(shapes["layers"]["attn"]["ckv_norm"]))


def test_forward_hidden_matches_jax_expanded_prefill(setup):
    jcfg, cfg, jparams, params = setup
    toks = np.random.RandomState(1).randint(3, cfg.vocab_size, size=(2, 24))
    want, _, _, _ = jax_forward_hidden(jparams, jcfg, jnp.asarray(toks))
    got, _ = forward_hidden(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MTOL)


@pytest.mark.parametrize("S", [1, 3])
def test_paged_mla_step_matches_jax_attention(setup, S):
    """S tokens per row through ``mla_attention`` against the paged latent
    pool (S == 1 decode, S == 3 a verify block): the same output, and the
    tokens' latents and positions land in the same slots."""
    jcfg, cfg, _, _ = setup
    rng = np.random.RandomState(7 + S)
    jp = jax.device_get(init_attention(jax.random.PRNGKey(11), jcfg,
                                       jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    P, page, B = 8, 4, 2
    jcache = JaxBackend(jcfg, page).init(P, jnp.float32)
    lat = {k: rng.randn(*v.shape).astype(np.float32)
           for k, v in jcache.items() if k != "pos_pages"}
    pos = np.full((P, page), INVALID, np.int32)
    for j, p0 in ((2, 0), (3, 4), (4, 0), (5, 4)):
        pos[j] = np.arange(p0, p0 + page)
    jcache = {**{k: jnp.asarray(v) for k, v in lat.items()},
              "pos_pages": jnp.asarray(pos)}
    tcache = PagedCacheBackend(cfg, page).init(P, torch.float32, "cpu")
    assert set(tcache) == set(jcache) == {"ckv_pages", "kr_pages",
                                          "pos_pages"}
    for k, v in lat.items():
        tcache[k].copy_(torch.from_numpy(v))
    tcache["pos_pages"].copy_(torch.from_numpy(pos))
    table = np.asarray([[2, 3, 6, 0], [4, 5, 7, 0]], np.int32)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    positions = (8 + np.arange(S))[None].repeat(B, 0).astype(np.int32)
    wslot = np.stack([6 * page + np.arange(S),
                      7 * page + np.arange(S)]).astype(np.int32)
    o_j, c_j = jax_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(positions),
                             jnp.zeros((B, S), jnp.int32), cache=jcache,
                             cache_offset=jnp.asarray(wslot),
                             page_table=jnp.asarray(table))
    t = torch.from_numpy
    o_t, c_t = attn_mod.attention(tp, cfg, t(x), t(positions),
                                  torch.zeros((B, S), dtype=torch.int32),
                                  cache=tcache, cache_offset=t(wslot),
                                  page_table=t(table))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **MTOL)
    for k in c_j:
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                   atol=1e-6)


# ---------------------------------------------------------------------
# the paged engine against the JAX engine (greedy)
# ---------------------------------------------------------------------

PROMPTS = [np.asarray([1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 3, 4], np.int32),
           np.asarray([1, 9, 4, 7, 9, 4, 7, 9], np.int32),
           np.asarray([1, 2, 3], np.int32),
           np.arange(3, 24, dtype=np.int32)]   # longer than LP: its tail


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


def _run_both(setup, group, **over):
    jcfg, cfg, jparams, params = setup
    jeng = JaxEngine(jcfg, **_kw(group, **over))
    jeng.set_params(jparams)
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(group, **over))
    eng.set_params(params)
    free0 = eng.alloc.num_free
    jh = _drive(jeng, [(p, jax.random.PRNGKey(i))
                       for i, p in enumerate(PROMPTS)])
    th = _drive(eng, [(p, i) for i, p in enumerate(PROMPTS)])
    for a, b in zip(jh, th):
        ja, tb = a.result(0), b.result(0)
        np.testing.assert_array_equal(tb.response_ids.numpy(),
                                      np.asarray(ja.response_ids))
        np.testing.assert_array_equal(tb.response_len.numpy(),
                                      np.asarray(ja.response_len))
        np.testing.assert_allclose(tb.response_logprobs.numpy(),
                                   np.asarray(ja.response_logprobs),
                                   atol=1e-5, rtol=0)
    assert eng.decode_steps == jeng.decode_steps
    assert eng.alloc.num_free == free0 and eng.alloc.num_live == 0
    assert eng.idle
    return jeng, eng, th


@pytest.mark.parametrize("group", [1, 3])
def test_greedy_engine_matches_jax_engine(setup, group):
    """Tokens, captured logprobs (within 1e-5), decode_steps and peak page
    occupancy equal to the JAX engine's; slots are evicted and re-admitted
    mid-batch, and with G = 3 a group's rows share its latent prompt
    pages."""
    jeng, eng, _ = _run_both(setup, group)
    assert eng.peak_pages_used == jeng.peak_pages_used > 0
    assert eng.prefills == len(PROMPTS)


@pytest.mark.parametrize("group", [1, 4])
def test_spec_engine_matches_jax_spec_engine(setup, group):
    """Spec decode (prompt lookup, k = 3): tokens and decode_steps equal
    to the JAX spec engine, the verify counters equal, every page back;
    the tokens also equal the port's non-spec engine's. No step-count
    inequality: random weights make the drafts mostly wrong."""
    jeng, eng, th = _run_both(setup, group, spec_k=K)
    assert eng.spec_steps == jeng.spec_steps > 0
    assert eng.accepted_tokens == jeng.accepted_tokens
    assert eng.drafted_tokens == jeng.drafted_tokens
    assert eng.rolled_back_pages == jeng.rolled_back_pages
    _, cfg, _, params = setup
    plain = PagedGroupEngine(cfg, device="cpu", **_kw(group))
    plain.set_params(params)
    ph = _drive(plain, [(p, i) for i, p in enumerate(PROMPTS)])
    for a, b in zip(th, ph):
        np.testing.assert_array_equal(a.result(0).response_ids.numpy(),
                                      b.result(0).response_ids.numpy())


@pytest.mark.parametrize("spec_k", [0, K])
def test_engine_routes_mla_through_its_wrappers(setup, spec_k, monkeypatch):
    """Every decode step calls the MLA decode wrapper once per layer and
    every verify forward the verify wrapper once per layer; neither GQA
    paged wrapper runs (the counts chip_smoke.py checks on the card)."""
    _, cfg, _, params = setup
    calls = {"decode": 0, "verify": 0, "gqa": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(attn_mod, "paged_mla_decode_attention",
                        counting("decode", da.paged_mla_decode_attention))
    monkeypatch.setattr(attn_mod, "paged_mla_verify_attention",
                        counting("verify", da.paged_mla_verify_attention))
    for gqa in ("paged_decode_attention", "paged_verify_attention"):
        monkeypatch.setattr(attn_mod, gqa,
                            counting("gqa", getattr(da, gqa)))
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(2, spec_k=spec_k))
    eng.set_params(params)
    _drive(eng, [(p, i) for i, p in enumerate(PROMPTS[:2])])
    L = cfg.num_layers
    assert calls["gqa"] == 0 and eng.decode_steps > 0
    if spec_k:
        assert calls == {"decode": 0, "verify": L * eng.decode_steps,
                         "gqa": 0}
    else:
        assert calls == {"decode": L * eng.decode_steps, "verify": 0,
                         "gqa": 0}


def test_serving_driver_spec_tokens_equal_plain(setup):
    """The RequestDriver over the MLA engine: greedy tokens with spec on
    equal those with spec off, request by request."""
    _, cfg, _, params = setup
    rng = np.random.RandomState(3)
    prompts = [rng.randint(3, 40, size=(rng.randint(3, 14),)).astype(np.int32)
               for _ in range(4)]
    out = {}
    for spec_k in (0, K):
        reqs, m, stats = serve_requests(
            cfg, prompts, max_prompt_len=16, max_new=8, num_slots=2,
            page_size=4, temperature=0.0, params=params, device="cpu",
            spec_k=spec_k)
        out[spec_k] = [r.tokens for r in reqs]
        assert m["generated_tokens"] == 4 * 8
    assert out[0] == out[K]


# ---------------------------------------------------------------------
# what the slice leaves out
# ---------------------------------------------------------------------

def test_refusals():
    """MoE on (the published config, reduced) is served: the engine builds
    with spec decode and the radix cache, and the serve CLI runs
    --arch deepseek-v2-lite-16b --reduced. It trains too: build_pipeline
    builds it and the train CLI runs an iteration. With MoE off the radix
    cache on latent pages and training build."""
    moe = reduced_config(get_config("deepseek-v2-lite-16b"))
    dense = reduced_config(mla_dense(get_config))
    rl = RLConfig(batch_prompts=1, group_size=2)
    eng = PagedGroupEngine(moe, device="cpu",
                           **_kw(1, spec_k=K, prefix_cache=True))
    assert eng.radix is not None and eng.spec_k == K
    serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                "--device", "cpu", "--num-requests", "1", "--max-new", "2"])
    sched, parts = build_pipeline(moe, rl, device="cpu")
    assert parts["pool"].instances[0].paged_engine.cfg is moe
    eng = PagedGroupEngine(dense, device="cpu", **_kw(1, prefix_cache=True))
    assert eng.radix is not None
    sched, parts = build_pipeline(dense, rl, device="cpu")
    assert parts["pool"].instances[0].paged_engine.cfg is dense
    train.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                "--device", "cpu", "--iterations", "1", "--batch-prompts",
                "1", "--group-size", "2", "--max-response-len", "4"])

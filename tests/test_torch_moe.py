"""The port's MoE feed-forward and its serving path against the JAX package
on the CPU.

``moe_ffn`` against the JAX ``_moe_ffn_local`` on the same weights and
tokens: outputs, the auxiliary loss, the dispatch slots and the keep mask,
in f32 and bf16, at reduced and at deepseek-v2-lite's expert shapes (E 64,
K 6, d 2048, ff 1408, 2 shared), with a router skewed so that experts
overflow and with a zero router (every row a tie). The parameter trees of
reduced deepseek-v2-lite (MLA, 1 dense prelude layer + 1 MoE layer, 4
experts top-2, 1 shared) and reduced qwen3-moe (GQA, 2 MoE layers, 4
experts top-2, no shared) round-trip through ``convert.py``;
``forward_hidden`` matches JAX's; and the paged engine (plain, spec k 2,
D 3, radix warm) gives the JAX paged engine's greedy tokens, captured
logprobs and ``decode_steps`` at the same settings. A short prompt under
a skewed router shows the prefill routing over the JAX engine's padded
length, as its capacity demands.
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
from repro.models import forward_hidden as jax_forward_hidden  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import engine_support  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine  # noqa: E402
from repro_torch.models import forward_hidden, init  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
# f32 at 1e-5. bf16: both sides round each expert product once, but in
# different f32 summation orders, so a product may land one bf16 ulp apart
# and carry that into the sum over experts, where terms cancel; the bar is
# 2 bf16 ulps of each token's largest output
FTOL = dict(atol=1e-5, rtol=1e-5)
MTOL = dict(atol=1e-4, rtol=1e-4)
T, LP, PAGE = 8, 16, 4


def _configs(arch, **over):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **over),
            dataclasses.replace(reduced_config(get_config(arch)), **over))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, cfg = _configs(request.param)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_jax(jax.device_get(jparams), cfg,
                                        device="cpu")


# ---------------------------------------------------------------------
# moe_ffn against _moe_ffn_local
# ---------------------------------------------------------------------

def _full_width_cfgs():
    """deepseek-v2-lite's expert shapes: E 64, K 6, d 2048, ff 1408, 2
    shared experts."""
    return jax_get_config(ARCHS[0]), get_config(ARCHS[0])


def _moe_params(jcfg, seed, dtype, router=None):
    """One layer's MoE leaves, uniform with fan-in variance (drawn in f32,
    rounded to ``dtype``; the router stays f32): (jax tree, torch tree)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    d, E, ff = jcfg.d_model, jcfg.num_experts, jcfg.moe_d_ff
    shapes = {"w_gate": (E, d, ff), "w_up": (E, d, ff), "w_down": (E, ff, d)}
    if jcfg.num_shared_experts:
        sff = jcfg.num_shared_experts * ff
        shapes["shared"] = {"w_gate": (d, sff), "w_up": (d, sff),
                            "w_down": (sff, d)}
    rng = np.random.default_rng(seed)

    def draw(shape):
        a = rng.random(shape, dtype=np.float32)
        a -= 0.5
        a *= np.float32(12.0 ** 0.5 * shape[-2] ** -0.5)
        return a
    r = draw((d, E)) if router is None else router
    jp, tp = {"router": jnp.asarray(r)}, {"router": torch.from_numpy(r)}

    def fill(shp, jdst, tdst):
        for k, v in shp.items():
            if isinstance(v, dict):
                jdst[k], tdst[k] = {}, {}
                fill(v, jdst[k], tdst[k])
                continue
            a = draw(v)
            jdst[k] = jnp.asarray(a, jdt)
            tdst[k] = torch.from_numpy(a).to(tdt)
    fill(shapes, jp, tp)
    return jp, tp


def _moe_both(jcfg, cfg, jp, tp, x, dtype):
    """Run both sides on the same tokens; returns their (y, aux, slot,
    keep) as numpy."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    y_j, aux_j = jax_moe._moe_ffn_local(jp, jcfg, jx)
    xf = jx.reshape(-1, x.shape[-1])
    top_p, top_i, _ = jax_moe._route(jp, jcfg, xf)
    C = jax_moe.capacity(xf.shape[0], jcfg)
    slot_j, keep_j = jax_moe._dispatch_slots(top_i, jcfg.num_experts, C)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y_t, aux_t = moe.moe_ffn(tp, cfg, tx, want_aux=True)
    _, ti, _ = moe._route(tp, cfg, tx.reshape(-1, x.shape[-1]), False)
    slot_t, keep_t = moe._dispatch_slots(ti, cfg.num_experts,
                                         moe.capacity(xf.shape[0], cfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(top_i))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert y_t.dtype == tx.dtype and y_t.shape == tx.shape
    got, want = y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FTOL)
    else:
        # a qwen3 token whose every choice is dropped outputs exact zeros
        scale = np.abs(want).max(axis=-1, keepdims=True)
        ulp = np.where(scale > 0, 2.0 ** (np.floor(np.log2(
            np.maximum(scale, 1e-30))) - 7), 0.0)
        assert (np.abs(got - want) <= 2 * ulp).all()
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    return np.asarray(keep_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_moe_ffn_matches_jax(width, dtype):
    """Random router, 2 x 5 tokens at full width (C 8), 3 x 16 at reduced
    width (C 32)."""
    if width == "full":
        jcfg, cfg = _full_width_cfgs()
        B, S = 2, 5
    else:
        jcfg, cfg = _configs(ARCHS[0])
        B, S = 3, 16
    rng = np.random.RandomState(0)
    jp, tp = _moe_params(jcfg, 0, dtype)
    x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    _moe_both(jcfg, cfg, jp, tp, x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_drops_like_jax_on_a_skewed_router(dtype):
    """Tokens share a positive component that the router maps to experts
    0 and 1 first (reduced qwen3-moe, no shared experts, so a token whose
    every choice is dropped outputs zeros): both overflow, and the same
    (token, choice) pairs are dropped on both sides (the later tokens, in
    row-major order)."""
    jcfg, cfg = _configs(ARCHS[1])
    d, E = jcfg.d_model, jcfg.num_experts
    rng = np.random.RandomState(1)
    router = (rng.randn(d, E) * d ** -0.5 * 0.1).astype(np.float32)
    router[0, :] = -1.0
    router[0, :jcfg.num_experts_per_tok] = np.linspace(
        2.0, 1.0, jcfg.num_experts_per_tok)
    jp, tp = _moe_params(jcfg, 1, dtype, router=router)
    x = rng.randn(2, 24, d).astype(np.float32) * 0.1
    x[..., 0] = 3.0
    keep = _moe_both(jcfg, cfg, jp, tp, x, dtype)
    C = moe.capacity(48, cfg)
    assert C < 48 and (~keep).sum() == jcfg.num_experts_per_tok * (48 - C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_zero_router_ties_like_lax_top_k(dtype):
    """A zero router gives every expert probability 1/E: each row picks
    experts 0..K-1 (lax.top_k's lower index first), so they overflow."""
    jcfg, cfg = _configs(ARCHS[0])
    rng = np.random.RandomState(2)
    zero = np.zeros((jcfg.d_model, jcfg.num_experts), np.float32)
    jp, tp = _moe_params(jcfg, 2, dtype, router=zero)
    x = rng.randn(1, 40, jcfg.d_model).astype(np.float32)
    keep = _moe_both(jcfg, cfg, jp, tp, x, dtype)
    _, ti, _ = moe._route(tp, cfg, torch.from_numpy(x)[0], False)
    assert (ti.numpy() == np.arange(cfg.num_experts_per_tok)).all()
    assert (~keep).any()


def test_capacity_and_aux_only_when_asked():
    jcfg, cfg = _full_width_cfgs()
    for n in (1, 4, 20, 137, 1024, 4096):
        assert moe.capacity(n, cfg) == jax_moe.capacity(n, jcfg)
    _, rcfg = _configs(ARCHS[1])
    rng = np.random.RandomState(3)
    _, tp = _moe_params(jax_reduced(jax_get_config(ARCHS[1])), 3,
                        "float32")
    x = torch.from_numpy(rng.randn(1, 4, rcfg.d_model).astype(np.float32))
    y, aux = moe.moe_ffn(tp, rcfg, x)
    y_big, _ = moe.moe_ffn(tp, rcfg, x, capacity_tokens=4096)
    assert aux is None and torch.equal(y, y_big)   # nothing dropped at 4


# ---------------------------------------------------------------------
# the parameter tree and the model
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """Every field both configs have agrees, full and reduced, and the
    support matrix serves MoE on the paged engine and both planes and
    trains it, naming the router's aux loss."""
    for jcfg, cfg in ((jax_get_config(arch), get_config(arch)),
                      _configs(arch)):
        shared = ({f.name for f in dataclasses.fields(cfg)}
                  & {f.name for f in dataclasses.fields(jcfg)})
        assert {"capacity_factor", "router_aux_coef", "num_experts",
                "first_k_dense", "dense_d_ff"} <= shared
        for f in sorted(shared):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        for plane in ("paged", "spec", "prefix"):
            ok, reason = engine_support(cfg, plane)
            assert ok and "MoE" in reason, (plane, reason)
        ok, reason = engine_support(cfg, "train")
        assert ok and "aux" in reason, reason


def test_convert_round_trips_the_moe_trees(setup):
    """JAX -> port -> JAX is exact, the prelude (a JAX list of layers)
    stacked in between; ``init`` makes the same keys, shapes and dtypes."""
    jcfg, cfg, jparams, params = setup
    jtree = jax.device_get(jparams)
    back = to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert ("prelude" in params) == bool(cfg.first_k_dense)
    assert "mlp" not in params["layers"] and "moe" in params["layers"]
    mine = init(cfg, seed=0, device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    assert shapes(mine) == shapes(params) == {
        k: v for k, v in param_shapes(cfg).items()}


def test_bf16_tree_keeps_the_router_in_f32():
    jcfg, cfg = _configs(ARCHS[0], param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    jtree = jax.device_get(jax_init(jax.random.PRNGKey(1), jcfg))
    params = from_jax(jtree, cfg, device="cpu")
    mine = init(cfg, seed=1, device="cpu")
    for tree in (params, mine):
        assert tree["layers"]["moe"]["router"].dtype == torch.float32
        assert tree["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
        assert tree["prelude"]["mlp"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers"]["moe"]["router"].numpy(),
        np.asarray(jtree["layers"]["moe"]["router"]))


def test_forward_hidden_matches_jax(setup):
    jcfg, cfg, jparams, params = setup
    toks = np.random.RandomState(4).randint(3, cfg.vocab_size, size=(2, 24))
    want, _, _, _ = jax_forward_hidden(jparams, jcfg, jnp.asarray(toks))
    got, _ = forward_hidden(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MTOL)


# ---------------------------------------------------------------------
# the paged engine against the JAX engine (greedy)
# ---------------------------------------------------------------------

_rng = np.random.RandomState(5)
PROMPTS = [_rng.randint(3, 500, size=(n,)).astype(np.int32)
           for n in (3, 10, 6, 21)]
SYSTEM = [1, 5, 6, 7, 8, 9, 10, 11]                    # two full pages


def _kw(**over):
    kw = dict(num_slots=3, page_size=PAGE, num_pages=0, max_prompt_len=LP,
              max_new_tokens=T, group_size=1, temperature=0.0)
    kw.update(over)
    return kw


def _drive(eng, prompts):
    keys = [jax.random.PRNGKey(i) if isinstance(eng, JaxEngine) else i
            for i in range(len(prompts))]
    hs = [eng.submit(p, k) for p, k in zip(prompts, keys)]
    while eng.step():
        pass
    return hs


def _against_jax(jcfg, cfg, jparams, params, prompts, **over):
    """Both engines' greedy runs of ``prompts`` at the same settings:
    tokens, captured logprobs, decode steps and peak pages equal; every
    page back (or held once by the radix tree)."""
    jeng = JaxEngine(jcfg, **_kw(**over))
    jeng.set_params(jparams)
    # the JAX engine's D > 1 host-array race (tests/test_torch_device_loop)
    decode = jeng._decode
    jeng._decode = lambda *a: jax.block_until_ready(decode(*a))
    eng = PagedGroupEngine(cfg, device="cpu", **_kw(**over))
    eng.set_params(params)
    jh, th = _drive(jeng, prompts), _drive(eng, prompts)
    for a, b in zip(jh, th):
        ja, tb = a.result(0), b.result(0)
        np.testing.assert_array_equal(tb.response_ids.numpy(),
                                      np.asarray(ja.response_ids))
        np.testing.assert_array_equal(tb.response_len.numpy(),
                                      np.asarray(ja.response_len))
        np.testing.assert_allclose(tb.response_logprobs.numpy(),
                                   np.asarray(ja.response_logprobs),
                                   atol=1e-4, rtol=1e-4)
    assert eng.decode_steps == jeng.decode_steps > 0
    assert eng.generated_tokens == jeng.generated_tokens
    assert eng.peak_pages_used == jeng.peak_pages_used
    tree = eng.radix.pages() if eng.radix is not None else []
    assert eng.idle and eng.alloc.num_live == len(tree)
    assert eng.alloc.num_free + eng.alloc.num_live == eng.P - FIRST_PAGE
    return jeng, eng


@pytest.mark.parametrize("over", [
    {}, {"group_size": 3}, {"spec_k": 2}, {"drain_interval": 3},
], ids=["plain", "group3", "spec2", "drain3"])
def test_engine_matches_jax_engine(setup, over):
    jcfg, cfg, jparams, params = setup
    jeng, eng = _against_jax(jcfg, cfg, jparams, params, PROMPTS, **over)
    if "spec_k" in over:
        assert eng.spec_steps == jeng.spec_steps > 0
        assert eng.accepted_tokens == jeng.accepted_tokens
        assert eng.rolled_back_pages == jeng.rolled_back_pages


def test_radix_warm_engine_matches_jax_engine(setup):
    """Prompts sharing a two-page system prefix through the radix cache:
    the warm suffix prefills route their bucketed blocks as the JAX
    engine's do; tokens, logprobs and the cache's counters equal."""
    jcfg, cfg, jparams, params = setup
    prompts = [np.asarray(SYSTEM + [40 + 3 * i, 41 + 3 * i, 7][: 1 + i % 3],
                          np.int32) for i in range(4)]
    jeng, eng = _against_jax(jcfg, cfg, jparams, params, prompts,
                             prefix_cache=True, num_slots=1)
    assert eng.warm_prefills == 3 and eng.prefills == 1
    assert eng.prefix_hit_pages == jeng.prefix_hit_pages == 3 * 2
    assert eng.prefix_miss_pages == jeng.prefix_miss_pages


def _skewed(jparams, jcfg):
    """A copy of the JAX tree whose MoE routers send every token to
    experts 0 and 1 first: the embedding gets a large positive first
    coordinate and each router's first row favours those experts."""
    tree = jax.tree.map(np.array, jax.device_get(jparams))
    tree["embed"]["embedding"][:, 0] += 10.0
    router = tree["layers"]["moe"]["router"]          # (L, d, E)
    router[:, 0, :] = 0.0
    router[:, 0, 0], router[:, 0, 1] = 1.0, 0.5
    return tree


def test_short_prompt_routes_over_the_jax_engines_length(setup,
                                                         monkeypatch):
    """max_prompt_len 64 (page 4): the JAX engine prefills 64 tokens, so
    each expert keeps 40 choices. Under the skewed router a 44-token
    prompt drops 4 choices of each of experts 0 and 1 per MoE layer and a
    20-token prompt drops none, though the prompt's own 20 tokens would
    keep only 16. The port's tokens and logprobs equal the JAX engine's,
    and its prefills drop exactly those choices."""
    jcfg, cfg, jparams, _ = setup
    jtree = _skewed(jparams, jcfg)
    params = from_jax(jtree, cfg, device="cpu")
    n_moe = cfg.num_layers - cfg.first_k_dense
    drops = []
    dispatch = moe._dispatch_slots

    def counting(top_i, E, C):
        slot, keep = dispatch(top_i, E, C)
        if top_i.shape[0] > 3:                       # prefills only
            drops.append((C, int((~keep).sum())))
        return slot, keep
    monkeypatch.setattr(moe, "_dispatch_slots", counting)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (44, 20)]
    _against_jax(jcfg, cfg, jtree, params, prompts, max_prompt_len=64,
                 max_new_tokens=4, num_slots=2)
    assert moe.capacity(20, cfg) == 16 < moe.capacity(64, cfg) == 40
    assert drops == [(40, 2 * 4)] * n_moe + [(40, 0)] * n_moe

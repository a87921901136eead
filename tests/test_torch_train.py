"""The port's training step against the JAX package's.

Reduced llama3.2-3b, reduced ``mla_dense`` (deepseek-v2-lite with MoE
off; 2 layers, d 256, f32; MLA's expanded attention trains through
autograd in both packages), reduced deepseek-v2-lite with MoE on (one
dense prelude layer + one MoE layer of 4 experts top-2 and 1 shared) and
reduced qwen3-moe (GQA, 2 MoE layers): the JAX parameter tree is
converted with ``repro_torch.convert`` and both packages run the same
numpy-packed ``MicroBatch`` (plain rows and SPA-packed rows). Bars: loss
and metrics (the MoE load-balance loss ``aux`` included) within 1e-5
relative (MLA's loss within MLA_LOSS_ATOL, of JAX's and of the f64
loss), and every gradient leaf within 2e-4 of that leaf's largest JAX
entry (f32 sums run in another order). Old and reference weights differ
from the policy so the ratio, the clip and the KL term all carry
gradient. The MoE cases also run with a skewed router whose packed
micro-batch drops (token, choice) pairs, and with ``router_aux_coef`` 1.
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
from repro.configs.base import RLConfig as JaxRL  # noqa: E402
from repro.core.queue import RolloutGroup as JaxGroup  # noqa: E402
from repro.core.spa import pack_plain as jax_pack_plain  # noqa: E402
from repro.core.spa import pack_spa as jax_pack_spa  # noqa: E402
from repro.models import forward_hidden as jax_forward_hidden  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.models import token_logprobs as jax_token_logprobs  # noqa: E402
from repro.optim.adam import adam_init as jax_adam_init  # noqa: E402
from repro.optim.adam import adam_update as jax_adam_update  # noqa: E402
from repro.rl import grpo as jgrpo  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.queue import RolloutGroup  # noqa: E402
from repro_torch.core.spa import pack_plain, pack_spa  # noqa: E402
from repro_torch.models import forward_hidden, layers  # noqa: E402
from repro_torch.models import token_logprobs  # noqa: E402
from repro_torch.optim.accumulate import GradAccumulator  # noqa: E402
from repro_torch.optim.adam import adam_init, adam_update  # noqa: E402
from repro_torch.rl import grpo  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_mla import mla_dense  # noqa: E402
from test_torch_moe import _skewed  # noqa: E402

G, LP, T = 4, 16, 8


# the reduced configs of the trained families, built by each package
ARCHS = {"llama": lambda get: get("llama3.2-3b"), "mla_dense": mla_dense,
         "deepseek_moe": lambda get: get("deepseek-v2-lite-16b"),
         "qwen3_moe": lambda get: get("qwen3-moe-235b-a22b")}
MOE_ARCHS = ("deepseek_moe", "qwen3_moe")
# the absolute bar of mla_dense's loss. Its recomputed loss here (0.0319)
# is a sum of per-token terms near 1 that cancel (a group's advantages sum
# to zero), so f32 rounds it by a few 1e-7 in either package: with SPA
# rows the port's f32 loss lies 4.0e-7 and JAX's 1.3e-7 from the port's
# step run in f64, so the two differ by 5.4e-7 (1.7e-5 relative). Both are
# held to the f64 loss and to each other at this bar; kl, ratio_mean and
# n_tokens, and llama's loss, keep atol 1e-7.
MLA_LOSS_ATOL = 1e-6


def _f64_loss(monkeypatch, cfg, ttrees, mb, captured):
    """The port's loss with the same weights and batch in float64."""
    monkeypatch.setitem(layers._DTYPES, "float64", torch.float64)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")

    def f64(x):
        if isinstance(x, dict):
            return {k: f64(v) for k, v in x.items()}
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x
    mb = grpo.to_device(mb, "cpu")
    mb = mb._replace(**{f: f64(getattr(mb, f)) for f in mb._fields})
    make = grpo.make_grad_step_captured if captured else grpo.make_grad_step
    _, metrics = make(cfg64, RLConfig())(*[f64(t) for t in ttrees], mb)
    return float(metrics["loss"])


def _make(arch, skew=False, **over):
    """(jcfg, cfg, JAX trees, port trees) of policy, old and ref; ``skew``
    routes every token of the policy to experts 0 and 1 first
    (``test_torch_moe._skewed``), and old and ref with it."""
    jcfg = dataclasses.replace(jax_reduced(ARCHS[arch](jax_get_config)),
                               **over)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch](get_config)), **over)
    trees = []
    for seed in (0, 1, 2):           # policy, old, ref
        trees.append(jax.device_get(jax_init(jax.random.PRNGKey(seed), jcfg)))
    # old and ref near the policy, so ratios sit inside and outside the clip
    policy = _skewed(trees[0], jcfg) if skew else trees[0]
    old = jax.tree.map(lambda a, b: a + 0.05 * b, policy, trees[1])
    ref = jax.tree.map(lambda a, b: a + 0.05 * b, policy, trees[2])
    jtrees = [jax.tree.map(jnp.asarray, t) for t in (policy, old, ref)]
    ttrees = [from_jax(t, cfg, device="cpu") for t in (policy, old, ref)]
    return jcfg, cfg, jtrees, ttrees


@pytest.fixture(scope="module", params=list(ARCHS))
def setup(request):
    return _make(request.param)


@pytest.fixture
def port_rope_freqs(monkeypatch):
    """Hands the JAX package the port's rotary frequencies as constants.
    Eager JAX computes the same f32 values, but a jitted step folds
    theta ** x with another pow, an ulp away in some entries; an SPA
    padding token sits at position 2^30 - 1, where that ulp turns its
    angle by O(1). Padding carries no loss, but a MoE layer routes it: its
    router probabilities enter the aux loss and its pairs take capacity."""
    from repro.models import layers as jax_layers

    def freqs(head_dim, theta):
        return jnp.asarray(layers.rope_freqs(head_dim, theta, "cpu").numpy())
    monkeypatch.setattr(jax_layers, "rope_freqs", freqs)


def _no_drop(cfg, **over):
    """A MoE config whose capacity holds every pair: with
    ``capacity_factor`` E / K, C >= T, so no (token, choice) pair is
    dropped and a token's output is its own whatever else its forward
    routes. The properties below hold for MoE only then: a packed
    micro-batch that drops gives another loss than per-sample rows, as
    in the JAX package (held to JAX by ``test_moe_grad_step_*``)."""
    if not cfg.is_moe:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok,
        **over)


def _groups(capture: bool):
    rng = np.random.RandomState(0)
    prompt = rng.randint(3, 500, size=(12,)).astype(np.int32)
    lens = np.asarray([5, 8, 3, 8], np.int32)
    resp = np.zeros((G, T), np.int32)
    for g in range(G):
        resp[g, :lens[g]] = rng.randint(3, 500, size=(lens[g],))
    rewards = np.asarray([1.0, 0.0, 0.5, 1.0], np.float32)
    lps = (-rng.rand(G, T) * 3).astype(np.float32) if capture else None
    kw = dict(uid=0, prompt_ids=prompt, response_ids=resp, response_len=lens,
              rewards=rewards, weight_version=0, response_logprobs=lps)
    return RolloutGroup(**kw), JaxGroup(**kw)


def _packed(spa: bool, capture: bool):
    g, jg = _groups(capture)
    adv = np.asarray(jgrpo.group_advantages(jnp.asarray(g.rewards)))
    if spa:
        return (pack_spa(g, adv, LP, T, responses_per_row=G),
                jax_pack_spa(jg, adv, LP, T, responses_per_row=G))
    return (pack_plain([g], [adv], LP, T),
            jax_pack_plain([jg], [adv], LP, T))


def _key(p):
    return p.key if hasattr(p, "key") else p.idx


def _leaves_by_path(jtree):
    return {tuple(_key(p) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}


def _assert_tree_close(got: dict, jtree, rel=2e-4):
    """Every leaf of the port's tree ``got`` (taken to the JAX layout, the
    prelude a list of layers) within ``rel`` of its JAX leaf's largest
    entry."""
    got = to_numpy(got)
    want = _leaves_by_path(jtree)
    for path, w in want.items():
        node = got
        for p in path:
            node = node[p]
        assert node.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(node - w).max())
        assert err <= rel * scale, (path, err, scale)
    assert len(want) == len(jax.tree_util.tree_leaves(got))


def _flat(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_flat(v) if isinstance(v, (dict, list)) else (v,))


def test_packers_match_jax():
    for spa in (False, True):
        for capture in (False, True):
            mb, jmb = _packed(spa, capture)
            for f in ("tokens", "labels", "positions", "segments",
                      "loss_mask", "advantages", "n_samples",
                      "logp_behavior"):
                a, b = getattr(mb, f), getattr(jmb, f)
                if b is None:
                    assert a is None, f
                else:
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b), err_msg=f)


@pytest.mark.parametrize("rewards", [[1.0, 0.0, 0.5, 1.0], [0.0] * 4,
                                     [1.0] * 8, [0.2, -3.0, 7.5]])
def test_group_advantages_match_jax(rewards):
    got = grpo.group_advantages(np.asarray(rewards, np.float32)).numpy()
    want = np.asarray(jgrpo.group_advantages(jnp.asarray(rewards,
                                                         jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("captured", [False, True], ids=["recompute",
                                                         "captured"])
@pytest.mark.parametrize("spa", [False, True], ids=["plain", "spa"])
def test_grad_step_matches_jax_value_and_grad(setup, spa, captured,
                                              monkeypatch, port_rope_freqs):
    jcfg, cfg, jtrees, ttrees = setup
    mb, jmb = _packed(spa, capture=captured)
    rl, jrl = RLConfig(), JaxRL()
    make = grpo.make_grad_step_captured if captured else grpo.make_grad_step
    jmake = (jgrpo.make_grad_step_captured if captured
             else jgrpo.make_grad_step)
    grads, metrics = make(cfg, rl)(*ttrees, grpo.to_device(mb, "cpu"))
    jgrads, jmetrics = jmake(jcfg, jrl)(*jtrees, jgrpo.jaxify(jmb))
    for k in ("loss", "aux", "kl", "ratio_mean", "n_tokens"):
        atol = MLA_LOSS_ATOL if cfg.use_mla and k == "loss" else 1e-7
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)
    if cfg.use_mla:
        loss64 = _f64_loss(monkeypatch, cfg, ttrees, mb, captured)
        for k, m in (("port", metrics), ("jax", jmetrics)):
            np.testing.assert_allclose(float(m["loss"]), loss64, rtol=1e-5,
                                       atol=MLA_LOSS_ATOL, err_msg=k)
    _assert_tree_close(grads, jgrads)
    assert (float(metrics["aux"]) > 0) == cfg.is_moe


def _drops(monkeypatch, run_port, run_jax):
    """Pairs each MoE call drops in a port forward and in a JAX forward
    (counted where each package's ``_dispatch_slots`` returns)."""
    counts = {"port": [], "jax": []}
    dispatch, jdispatch = moe._dispatch_slots, jax_moe._dispatch_slots

    def port(top_i, E, C):
        slot, keep = dispatch(top_i, E, C)
        counts["port"].append(int((~keep).sum()))
        return slot, keep

    def jax_side(top_i, E, C):
        slot, keep = jdispatch(top_i, E, C)
        jax.debug.callback(lambda n: counts["jax"].append(int(n)),
                           (~keep).sum())
        return slot, keep
    with monkeypatch.context() as m:
        m.setattr(moe, "_dispatch_slots", port)
        m.setattr(jax_moe, "_dispatch_slots", jax_side)
        run_port()
        run_jax()
        jax.effects_barrier()
    return counts["port"], counts["jax"]


@pytest.mark.parametrize("case", ["skewed", "aux_coef_1"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grad_step_matches_jax_with_drops_and_aux(arch, case,
                                                      monkeypatch,
                                                      port_rope_freqs):
    """SPA-packed recompute step. ``skewed``: every token routes to
    experts 0 and 1 first, so the packed row's 48 tokens overflow C = 32
    and both packages drop the same 2 x 16 pairs in each MoE layer of the
    policy forward. ``aux_coef_1``: with ``router_aux_coef`` 1 the aux
    loss moves each router's gradient by more than the bar, and the step
    still matches JAX."""
    skew = case == "skewed"
    over = {} if skew else {"router_aux_coef": 1.0}
    jcfg, cfg, jtrees, ttrees = _make(arch, skew=skew, **over)
    mb, jmb = _packed(spa=True, capture=False)
    tmb = grpo.to_device(mb, "cpu")
    grads, metrics = grpo.make_grad_step(cfg, RLConfig())(*ttrees, tmb)
    jgrads, jmetrics = jgrpo.make_grad_step(jcfg, JaxRL())(
        *jtrees, jgrpo.jaxify(jmb))
    for k in ("loss", "aux", "kl", "ratio_mean", "n_tokens"):
        atol = MLA_LOSS_ATOL if cfg.use_mla and k == "loss" else 1e-7
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)
    _assert_tree_close(grads, jgrads)
    n_moe = cfg.num_layers - cfg.first_k_dense
    with torch.no_grad():
        port, jx = _drops(
            monkeypatch,
            lambda: grpo._model_logprobs(ttrees[0], cfg, tmb),
            lambda: jax_forward_hidden(jtrees[0], jcfg,
                                       jnp.asarray(mb.tokens),
                                       positions=jnp.asarray(mb.positions),
                                       segments=jnp.asarray(mb.segments)))
    assert port == jx and len(port) == n_moe
    if skew:
        C = moe.capacity(mb.tokens.size, cfg)
        assert C == 32 and port == [2 * (mb.tokens.size - C)] * n_moe
        return
    _, cfg0, _, _ = _make(arch, router_aux_coef=0.0)
    free, _ = grpo.make_grad_step(cfg0, RLConfig())(*ttrees, tmb)
    want = _leaves_by_path(jgrads)
    for path in want:
        if path[-1] != "router":
            continue
        a, b = to_numpy(grads), to_numpy(free)
        for p in path:
            a, b = a[p], b[p]
        bar = 2e-4 * float(np.abs(want[path]).max())
        assert float(np.abs(a - b).max()) > bar, path


def test_token_logprobs_and_backward_match_jax(setup):
    jcfg, cfg, jtrees, ttrees = setup
    rng = np.random.RandomState(3)
    tokens = rng.randint(3, 500, size=(2, 150)).astype(np.int32)
    labels = rng.randint(0, 512, size=(2, 150)).astype(np.int32)
    cot = rng.randn(2, 150).astype(np.float32)   # 150: chunks 64, 64, 22

    def jax_fn(params):
        h, _, _, _ = jax_forward_hidden(params, jcfg, jnp.asarray(tokens))
        lp = jax_token_logprobs(params, jcfg, h, jnp.asarray(labels))
        return (lp * cot).sum(), lp
    (_, jlp), jg = jax.value_and_grad(jax_fn, has_aux=True)(jtrees[0])

    leaves = grpo._per_layer_leaves(ttrees[0], cfg)
    with torch.enable_grad():
        h, _ = forward_hidden(leaves, cfg, torch.from_numpy(tokens))
        lp = token_logprobs(leaves, cfg, h, torch.from_numpy(labels))
        flat = list(grpo._flat(leaves))
        g = torch.autograd.grad((lp * torch.from_numpy(cot)).sum(), flat)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp),
                               rtol=1e-5, atol=2e-5)
    _assert_tree_close(grpo._stacked_grads(leaves, list(g)), jg)


def test_remat_changes_no_gradient(setup):
    _, cfg, _, ttrees = setup
    mb, _ = _packed(spa=True, capture=False)
    mb = grpo.to_device(mb, "cpu")
    on, _ = grpo.make_grad_step(cfg, RLConfig())(*ttrees, mb)
    off, _ = grpo.make_grad_step(dataclasses.replace(cfg, remat=False),
                                 RLConfig())(*ttrees, mb)
    for a, b in zip(_flat(on), _flat(off)):
        assert torch.equal(a, b)


def test_spa_packed_gradient_equals_per_sample(setup):
    """grad(SPA-packed row) == grad(per-sample rows): the paper's exactness
    claim (tests/test_spa.py), here for the port at f32. A MoE config runs
    with nothing dropped (``_no_drop``) and without the aux loss: its load
    statistics average over the forward's tokens, which packing changes
    (a per-sample row repeats the prompt), so the aux term is not
    packing-invariant in either package."""
    _, cfg, _, ttrees = setup
    cfg = _no_drop(cfg, router_aux_coef=0.0)
    p = ttrees[0]
    step = grpo.make_grad_step(cfg, RLConfig())
    g_plain, m_plain = step(p, p, p, grpo.to_device(_packed(False, False)[0],
                                                    "cpu"))
    g_spa, m_spa = step(p, p, p, grpo.to_device(_packed(True, False)[0],
                                                "cpu"))
    for a, b in zip(_flat(g_plain), _flat(g_spa)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)
    torch.testing.assert_close(m_plain["loss"], m_spa["loss"], rtol=1e-4,
                               atol=1e-6)


def test_captured_step_equals_recompute(setup):
    """With captured logprobs equal to the old policy's (Proposition 1:
    rollout weights == old weights), the captured step's single reference
    forward gives the recompute step's gradient (tests/test_capture.py).
    A MoE config runs with nothing dropped (``_no_drop``): a rollout's
    captured logprobs come from decode steps that drop nothing, so they
    equal the old-policy recompute only where the packed forward drops
    nothing either."""
    _, cfg, _, (policy, old, ref) = setup
    cfg = _no_drop(cfg)
    mb = grpo.to_device(_packed(spa=True, capture=False)[0], "cpu")
    with torch.no_grad():
        lp_old = grpo._model_logprobs(old, cfg, mb)
    captured = mb._replace(logp_behavior=lp_old * (mb.loss_mask > 0))
    rl = RLConfig()
    g_cap, m_cap = grpo.make_grad_step_captured(cfg, rl)(policy, None, ref,
                                                         captured)
    g_rec, m_rec = grpo.make_grad_step(cfg, rl)(policy, old, ref, mb)
    for a, b in zip(_flat(g_cap), _flat(g_rec)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(m_cap["ratio_mean"], m_rec["ratio_mean"],
                               atol=1e-6, rtol=1e-6)


def test_adam_matches_jax_over_three_steps(setup):
    _, cfg, jtrees, ttrees = setup
    rng = np.random.RandomState(7)
    params, jparams = ttrees[0], jtrees[0]
    state, jstate = adam_init(params), jax_adam_init(jparams)
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, weight_decay=0.01, grad_clip=1.0)
    for step in range(3):
        gscale = 0.3 if step < 2 else 30.0      # the last step clips
        jg = jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32) * gscale), jparams)
        g = from_jax(jax.device_get(jg), cfg, device="cpu")
        params, state, m = adam_update(params, g, state, **kw)
        jparams, jstate, jm = jax_adam_update(jparams, jg, jstate, **kw)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _assert_tree_close(params, jparams, rel=1e-6)
    assert state.step == 3


def test_adam_leaves_an_aliased_tree_untouched(setup):
    """``refresh_old`` aliases old to policy; the update must not move old."""
    _, _, _, ttrees = setup
    params = ttrees[0]
    old = params
    snapshot = to_numpy(old)

    def ones(tree):
        return {k: ones(v) if isinstance(v, dict) else torch.ones_like(v)
                for k, v in tree.items()}
    new, _, _ = adam_update(params, ones(params), adam_init(params), lr=1e-2)
    for a, b in zip(_flat(snapshot), _flat(to_numpy(old))):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in
               zip(_flat(snapshot), _flat(to_numpy(new))))


def test_grad_accumulator_weighted_mean_is_order_free():
    rng = np.random.RandomState(0)
    grads = [{"w": torch.from_numpy(rng.randn(16, 16).astype(np.float32)),
              "b": {"c": torch.from_numpy(rng.randn(5).astype(np.float32))}}
             for _ in range(6)]
    weights = [1.0, 2.0, 1.0, 3.0, 1.0, 2.0]

    def accumulate(order):
        acc = GradAccumulator()
        for i in order:
            acc.add(grads[i], weights[i])
        return acc.mean()
    a, b = accumulate(range(6)), accumulate([5, 3, 1, 0, 4, 2])
    want = sum(w * g["w"] for w, g in zip(weights, grads)) / sum(weights)
    torch.testing.assert_close(a["w"], want, rtol=1e-6, atol=1e-6)
    for x, y in zip(_flat(a), _flat(b)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 140])
def test_lr_schedules_match_jax(step):
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule
    np.testing.assert_allclose(schedule.constant(1e-6)(step),
                               float(jsched.constant(1e-6)(step)), rtol=1e-6)
    np.testing.assert_allclose(
        schedule.warmup_cosine(1e-3, 10, 100)(step),
        float(jsched.warmup_cosine(1e-3, 10, 100)(step)), rtol=1e-6)

"""The port's periodic-async pipeline (paper Algorithm 1) on the CPU.

Scripted rollouts (deterministic in the prompt, as tests/test_onpolicy.py
uses) make runs comparable: Proposition 1 (sync == async parameters), the
weight-plane's overlap-on == overlap-off trajectory (bitwise within
torch), strict on-policy consumption, and the parameter trajectory of the
JAX ``build_pipeline`` on the same weights and rollouts. A paged-engine
run (with spec decode and the radix cache riding along for MLA) and the
train CLI complete on the reduced model. On the real group engine (the
Sampler) sync reaches async's parameters, and the off-policy baseline
runs at eta 1 with staleness 1 made deterministic and each group's
version checked against a recompute of its captured logprobs. The model-level tests run on
reduced llama3.2-3b, reduced ``mla_dense`` (deepseek-v2-lite with MoE
off) and reduced deepseek-v2-lite with MoE on (a dense prelude layer and
a MoE layer whose router the aux loss trains); the train CLI also trains
both reduced MoE arches.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import RLConfig as JaxRL  # noqa: E402
from repro.launch.train import build_pipeline as jax_pipeline  # noqa: E402
from repro.models import init as jax_init  # noqa: E402
from repro.rl.rollout import RolloutBatch as JaxBatch  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import RLConfig  # noqa: E402
from repro_torch.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.core.onpolicy import (OnPolicyMonitor,  # noqa: E402
                                       OnPolicyViolation)
from repro_torch.core.queue import RolloutGroup  # noqa: E402
from repro_torch.data.tokenizer import Tokenizer  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import build_pipeline  # noqa: E402
from repro_torch.rl.rollout import RolloutBatch  # noqa: E402
from test_torch_mla import mla_dense  # noqa: E402

T = 8


TOK = Tokenizer(512)


def _echo(prompts):
    """Responses derived from the prompt alone: every run, and both
    packages, see the same rollouts. Odd rows start with the task's answer
    (parsed from the prompt), so rewards vary within a group."""
    G = len(prompts)
    resp = np.zeros((G, T), np.int32)
    lens = np.zeros((G,), np.int32)
    rng = np.random.RandomState(int(np.asarray(prompts[0]).sum()) % 1000)
    expr = TOK.decode(prompts[0]).rsplit(": ", 1)[1].split(" =")[0]
    answer = TOK.encode(f"{eval(expr)} ", bos=False)  # the task's own text
    for g in range(G):
        n = rng.randint(3, T)
        resp[g, :n] = rng.randint(3, 200, size=(n,))
        if g % 2 and len(answer) < T:
            resp[g, :len(answer)] = answer
            n = max(n, len(answer) + 1)
        resp[g, n - 1] = Tokenizer.EOS
        lens[g] = n
    return resp, lens


def scripted(prompts, key):
    resp, lens = _echo(prompts)
    return RolloutBatch(response_ids=torch.from_numpy(resp),
                        response_len=torch.from_numpy(lens))


def jax_scripted(prompts, key):
    resp, lens = _echo(prompts)
    return JaxBatch(response_ids=jnp.asarray(resp),
                    response_len=jnp.asarray(lens))


def _rl(mode: str, **kw) -> RLConfig:
    base = dict(mode=mode, batch_prompts=3, group_size=4, micro_batch=2,
                num_inference_instances=2, max_prompt_len=24,
                max_response_len=T, learning_rate=1e-3, seed=0)
    base.update(kw)
    return RLConfig(**base)


# the reduced configs of the trained families, built by each package
ARCHS = {"llama": lambda get: get("llama3.2-3b"), "mla_dense": mla_dense,
         "deepseek_moe": lambda get: get("deepseek-v2-lite-16b")}


# Adam's step lr * g / (|g| + 1e-8) is eps-dominated where a gradient is
# within f32 rounding of zero, and there the two packages' steps may differ
# by up to lr: one w_gate element of reduced mla_dense has a first
# gradient of 2.2e-8 in the port and 3.7e-8 in JAX (its leaf's largest is
# 0.099; the leaf's two gradients differ by at most 6e-8) and steps
# 1.17e-4 against 1.81e-4. For mla_dense the trajectory bar therefore holds
# an element whose two gradients differ and both lie below NEAR_ZERO of
# their leaf's largest JAX gradient in some step to lr instead, and such
# elements must be at most MAX_NEAR_ZERO of the tree (515 of 1.29 M here).
# The rule follows MLA attention, so reduced deepseek-v2-lite with MoE on
# takes it too; llama keeps the bar on every element.
NEAR_ZERO = 1e-6
MAX_NEAR_ZERO = 1e-3


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def jcfg(arch):
    return jax_reduced(ARCHS[arch](jax_get_config))


@pytest.fixture(scope="module")
def cfg(arch):
    return reduced_config(ARCHS[arch](get_config))


@pytest.fixture(scope="module")
def jparams(jcfg):
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jcfg))


def _build(cfg, jparams, mode, **kw):
    return build_pipeline(
        cfg, _rl(mode, **kw), seed=0, scripted_fn=scripted, device="cpu",
        params=from_jax(jparams, cfg, device="cpu"))


def _run(cfg, jparams, mode, iterations=3, **kw):
    sched, parts = _build(cfg, jparams, mode, **kw)
    hist = sched.run(iterations)
    return sched, parts, hist


def _record_grads(sched, to_np):
    """Wraps a scheduler's ``apply_update`` (either package's) so that
    each update's mean gradient is kept, as a numpy tree."""
    grads, update = [], sched.apply_update

    def apply_update(params, opt, g):
        grads.append(to_np(g))
        return update(params, opt, g)
    sched.apply_update = apply_update
    return grads


def _at(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return np.asarray(tree)


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_sync_and_async_reach_the_same_parameters(cfg, jparams):
    """Proposition 1: periodic asynchrony changes only the consumption
    order, so the trajectory matches the synchronous baseline up to f32
    summation order."""
    _, p_sync, _ = _run(cfg, jparams, "sync")
    _, p_async, h = _run(cfg, jparams, "async")
    assert any(s.reward_mean > 0 for s in h)     # non-constant rewards
    for a, b in zip(_leaves(p_sync["tri"].policy),
                    _leaves(p_async["tri"].policy)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("mode,n_prompts", [("sync", 2), ("async", 1)])
def test_overlap_trajectory_bitwise_equal_to_eager(cfg, jparams, mode,
                                                   n_prompts):
    """With overlap the bucket stream runs in the background; rollouts are
    version-gated, so the trajectory is bitwise the eager one (async with
    one group per iteration keeps the accumulation order fixed)."""
    def run(overlap):
        sched, parts, hist = _run(cfg, jparams, mode, batch_prompts=n_prompts,
                                  transfer_overlap=overlap,
                                  transfer_bucket_bytes=8 << 10)
        assert all(s.max_staleness == 0 for s in hist)
        modes = {g["mode"] for g in parts["transfer"].gaps[1:]}
        assert modes <= ({"overlap", "noop"} if overlap else {"eager"})
        return parts["tri"].policy
    for a, b in zip(_leaves(run(True)), _leaves(run(False))):
        assert torch.equal(a, b)


def test_async_is_strictly_on_policy(cfg, jparams):
    sched, parts, hist = _run(cfg, jparams, "async")
    assert all(s.max_staleness == 0 for s in hist)
    assert sched.monitor.checked == 3 * 3        # iterations x prompts
    assert parts["tri"].version == 3
    assert all(s.trained_tokens > 0 and s.train_time > 0 for s in hist)
    monitor = OnPolicyMonitor(strict=True)
    stale = RolloutGroup(uid=7, prompt_ids=np.zeros(3, np.int32),
                         response_ids=np.zeros((1, 2), np.int32),
                         response_len=np.ones(1, np.int32),
                         rewards=np.zeros(1, np.float32), weight_version=0)
    assert monitor.check(stale, 0) == 0
    with pytest.raises(OnPolicyViolation, match="Proposition 1"):
        monitor.check(stale, 1)


def test_offpolicy_baseline_is_stale(cfg, jparams):
    _, _, hist = _run(cfg, jparams, "async_offpolicy", staleness_eta=1)
    assert max(s.max_staleness for s in hist) >= 1


def test_trajectory_matches_jax_pipeline(cfg, jcfg, jparams):
    """Two sync iterations on the same weights and scripted rollouts: the
    port's parameters track the JAX package's (f32, Adam at lr 1e-3); for
    mla_dense, all but the few elements whose gradient is rounding."""
    jrl = JaxRL(mode="sync", batch_prompts=3, group_size=4, micro_batch=2,
                num_inference_instances=2, max_prompt_len=24,
                max_response_len=T, learning_rate=1e-3, seed=0)
    jsched, jparts = jax_pipeline(jcfg, jrl, seed=0, scripted_fn=jax_scripted)
    jgrads = _record_grads(jsched, jax.device_get)
    jsched.run(2)
    sched, parts = _build(cfg, jparams, "sync")
    grads = _record_grads(sched, to_numpy)
    hist = sched.run(2)
    assert [s.trained_tokens for s in hist] == \
        [s.trained_tokens for s in jsched.history]
    assert len(grads) == len(jgrads) == 2
    want = jax.device_get(jparts["tri"].policy)
    got = to_numpy(parts["tri"].policy)
    near_zero = total = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g, w = _at(got, path), np.asarray(w)
        near = np.zeros(w.shape, bool)
        for step, jstep in zip(grads, jgrads) if cfg.use_mla else ():
            a, b = _at(step, path), _at(jstep, path)
            tiny = NEAR_ZERO * max(float(np.abs(b).max()), 1e-30)
            near |= (a != b) & (np.abs(a) < tiny) & (np.abs(b) < tiny)
        near_zero, total = near_zero + int(near.sum()), total + near.size
        np.testing.assert_allclose(g[~near], w[~near], atol=5e-5, rtol=5e-4,
                                   err_msg=str(path))
        np.testing.assert_allclose(g[near], w[near], atol=jrl.learning_rate,
                                   rtol=0, err_msg=str(path))
    assert near_zero <= MAX_NEAR_ZERO * total, (near_zero, total)


def test_paged_engine_pipeline_on_cpu(cfg):
    """Two async iterations with the paged engine on the CPU, SPA packing,
    captured logprobs and a bf16 wire (for MLA with spec decode, k 2, and
    the radix cache riding along): on-policy, and after every flip the
    pool holds the bf16-rounded policy of that version."""
    planes = dict(spec_decode=True, spec_k=2, prefix_cache=True) \
        if cfg.use_mla else {}
    rl = _rl("async", batch_prompts=2, group_size=4, num_inference_instances=1,
             max_prompt_len=48, cbatch_slots=8, shared_prompt_attention=True,
             transfer_wire_dtype="bfloat16", learning_rate=1e-2, **planes)
    sched, parts = build_pipeline(cfg, rl, seed=0, device="cpu")
    flips = []
    ensure = sched.transfer.ensure

    def probe(params, version):
        v = ensure(params, version)
        pool = parts["pool"].instances[0].store.snapshot()[0]
        # every leaf lands in its storage dtype (the MoE router f32)
        flips.append(all(p.dtype == q.dtype and
                         torch.equal(p, q.to(torch.bfloat16).float())
                         for p, q in zip(_leaves(pool), _leaves(params))))
        return v
    sched.transfer.ensure = probe
    hist = sched.run(2)
    assert all(s.max_staleness == 0 and s.trained_tokens > 0 for s in hist)
    assert flips == [True, True]
    assert parts["tri"].version == 2
    assert sched.captured_micro_steps == 4 and \
        sched.recomputed_micro_steps == 0
    assert all(s.metrics["prefills"] == 2 and s.metrics["decode_steps"] > 0
               for s in hist)
    if cfg.use_mla:     # the spec verify steps and the radix walk ran
        assert all(s.metrics["spec_steps"] > 0 and
                   s.metrics["prefix_miss_pages"] > 0 for s in hist)
    inst = parts["pool"].instances[0]
    assert inst.store.version == 1 and inst.store.staged_version == 2
    staged = inst.store.staged_params()
    assert all(torch.equal(p, q.to(torch.bfloat16).float()) for p, q in
               zip(_leaves(staged), _leaves(parts["tri"].policy)))


def _parity_reward(resp, answer) -> float:
    """A reward that varies with the tokens, so real rollouts of a random
    model give non-zero advantages (it never answers right)."""
    return float(np.mean(np.asarray(resp) % 2)) if len(resp) else 0.0


def _group_run(cfg, jparams, mode, iterations=3, **kw):
    """A run on the real group engine (the Sampler, sampled at
    temperature 1) on the JAX weights, with the parity reward."""
    sched, parts = build_pipeline(
        cfg, _rl(mode, rollout_engine="group", **kw), seed=0, device="cpu",
        params=from_jax(jparams, cfg, device="cpu"))
    parts["generator"].reward_fn = _parity_reward
    return sched, parts


def test_group_engine_is_built(cfg):
    """``rollout_engine="group"`` builds one Sampler, shared by every
    instance, for GQA and MLA (dense or MoE feed-forward)."""
    from repro_torch.rl.rollout import Sampler
    _, parts = build_pipeline(cfg, _rl("async", rollout_engine="group"),
                              device="cpu")
    insts = parts["pool"].instances
    assert isinstance(parts["sampler"], Sampler) and len(insts) == 2
    assert all(i.sampler is parts["sampler"] and i.paged_engine is None
               and not i.store.defer_flip for i in insts)


def test_group_engine_refusals(cfg):
    """SSM stays refused on the group engine (with spec decode too), the
    radix cache rides the paged engine only, and the off-policy baseline
    stays refused on the paged engine (it needs quiescence at a flip).
    Spec decode on the group engine builds the SpecSampler."""
    import dataclasses
    from repro_torch.spec.sampler import SpecSampler
    ssm = dataclasses.replace(cfg, family="ssm", ssm_state_size=16)
    with pytest.raises(ValueError, match="not ported"):
        build_pipeline(ssm, _rl("async", rollout_engine="group"),
                       device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        build_pipeline(ssm, _rl("async", rollout_engine="group",
                                spec_decode=True), device="cpu")
    _, parts = build_pipeline(cfg, _rl("async", rollout_engine="group",
                                       spec_decode=True), device="cpu")
    assert isinstance(parts["sampler"], SpecSampler)
    with pytest.raises(ValueError, match="paged pool"):
        build_pipeline(cfg, _rl("async", rollout_engine="group",
                                prefix_cache=True), device="cpu")
    with pytest.raises(ValueError, match="quiescent"):
        build_pipeline(cfg, _rl("async_offpolicy"), device="cpu")


def test_group_engine_sync_and_async_reach_the_same_parameters(cfg,
                                                               jparams):
    """Proposition 1 on the real group engine: the same keys draw the same
    rollouts in either mode, so async training reaches sync's parameters
    up to f32 summation order (the scripted test's bars)."""
    policies = []
    for mode in ("sync", "async"):
        sched, parts = _group_run(cfg, jparams, mode, iterations=2)
        hist = sched.run(2)
        assert all(s.max_staleness == 0 and s.trained_tokens > 0
                   for s in hist)
        assert sched.captured_micro_steps > 0
        policies.append(parts["tri"].policy)
    assert not all(torch.equal(a, b) for a, b in zip(
        _leaves(policies[0]), _leaves(from_jax(jparams, cfg, device="cpu"))))
    for a, b in zip(*map(_leaves, policies)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def _recomputed_logprobs(params, cfg, group):
    """Each row's response logprobs recomputed by one forward of prompt +
    response under ``params`` (rows of their own lengths)."""
    from repro_torch.models import forward_hidden, token_logprobs
    P = len(group.prompt_ids)
    out = np.zeros(group.response_ids.shape, np.float32)
    for g, n in enumerate(group.response_len):
        seq = np.concatenate([group.prompt_ids, group.response_ids[g, :n]])
        with torch.no_grad():
            h, _ = forward_hidden(params, cfg,
                                  torch.from_numpy(seq.astype(np.int64))[None])
            out[g, :n] = token_logprobs(
                params, cfg, h[:, P - 1:P - 1 + n],
                torch.from_numpy(group.response_ids[g, :n])[None])[0].numpy()
    return out


def test_offpolicy_baseline_on_the_group_engine(cfg, jparams):
    """``async_offpolicy`` at eta 1 on the real group engine (3
    iterations). The trainer is held at iteration 0's end until batch 1's
    groups are queued, so they are generated under version 0 and consumed
    at version 1: staleness 1 occurs, deterministically. Every consumed
    group's staleness lies in [0, 1], and its ``weight_version`` is the
    version that produced it: its captured logprobs equal a recompute
    under that version's tree, and sit closer to it than to any other
    version's. A MoE model runs without capacity drops here, where a
    token's logprob is its own whatever its forward routes."""
    import dataclasses
    import threading
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.num_experts_per_tok)
    sched, parts = _group_run(cfg, jparams, "async_offpolicy",
                              staleness_eta=1)
    queue, trees, seen = parts["queue"], {}, []
    for name in ("ensure", "publish_async"):
        def record(params, version, _f=getattr(sched.transfer, name)):
            trees[version] = params
            return _f(params, version)
        setattr(sched.transfer, name, record)
    queued = threading.Condition()
    put, get, check = queue.put, queue.get, sched.monitor.check

    def put_notify(item):
        put(item)
        with queued:
            queued.notify_all()
    queue.put = put_notify

    def get_record(timeout=None):
        seen.append([get(timeout)])
        return seen[-1][0]
    queue.get = get_record

    def check_record(group, version):
        seen[-1].append(check(group, version))
        return seen[-1][-1]
    sched.monitor.check = check_record
    finish = sched._finish_iteration

    def hold_then_finish(acc):
        if len(trees) == 1:     # iteration 0: batch 1's groups queue first
            with queued:
                assert queued.wait_for(lambda: queue.qsize() >= 3,
                                       timeout=120)
        finish(acc)
    sched._finish_iteration = hold_then_finish
    hist = sched.run(3)
    assert len(seen) == 9 and {st for _, st in seen} <= {0, 1}
    # iteration 1 consumes the last 3 of batches 0 and 1, all version 0
    assert [st for _, st in seen[3:6]] == [1, 1, 1]
    assert [s.max_staleness for s in hist][:2] == [0, 1]
    assert parts["tri"].version == 3 and sorted(trees) == [0, 1, 2, 3]
    for g, _ in seen:
        errs = {v: float(np.abs(_recomputed_logprobs(trees[v], cfg, g)
                                - g.response_logprobs).max())
                for v in range(3)}
        assert errs[g.weight_version] < 1e-4, errs
        assert errs[g.weight_version] == min(errs.values()), errs


def test_train_cli_on_cpu(capsys, tmp_path):
    out = tmp_path / "hist.json"
    train.main(["--device", "cpu", "--reduced", "--iterations", "2",
                "--batch-prompts", "2", "--group-size", "4", "--spa",
                "--wire-dtype", "bfloat16", "--max-prompt-len", "48",
                "--max-response-len", "8", "--json-out", str(out)])
    text = capsys.readouterr().out
    assert "iter 1:" in text and "staleness=0" in text
    hist = json.loads(out.read_text())
    assert [h["iteration"] for h in hist] == [0, 1]


def test_train_cli_offpolicy_on_the_group_engine(capsys):
    """``--rollout-engine group --mode async_offpolicy``: the off-policy
    baseline through the CLI; ``--rollout-engine paged`` refuses it."""
    train.main(["--device", "cpu", "--reduced", "--iterations", "2",
                "--batch-prompts", "2", "--group-size", "4",
                "--rollout-engine", "group", "--mode", "async_offpolicy",
                "--max-prompt-len", "48", "--max-response-len", "8"])
    text = capsys.readouterr().out
    assert "engine=group" in text and text.count("  iter ") == 2
    with pytest.raises(ValueError, match="quiescent"):
        train.main(["--device", "cpu", "--reduced", "--mode",
                    "async_offpolicy"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_train_cli_trains_moe_on_cpu(arch, capsys):
    """The published MoE arches, reduced, through the train CLI: SPA rows,
    captured logprobs and a bf16 wire, strictly on-policy."""
    train.main(["--arch", arch, "--device", "cpu", "--reduced",
                "--iterations", "2", "--batch-prompts", "2",
                "--group-size", "4", "--spa", "--wire-dtype", "bfloat16",
                "--max-prompt-len", "48", "--max-response-len", "8"])
    text = capsys.readouterr().out
    assert f"{arch}-smoke (2 layers" in text
    assert text.count("staleness=0") == 2

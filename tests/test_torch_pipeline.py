"""The port's periodic-async pipeline (paper Algorithm 1) on the CPU.

Scripted rollouts (deterministic in the prompt, as tests/test_onpolicy.py
uses) make runs comparable: Proposition 1 (sync == async parameters), the
weight-plane's overlap-on == overlap-off trajectory (bitwise within
torch), strict on-policy consumption, and the parameter trajectory of the
JAX ``build_pipeline`` on the same weights and rollouts. A paged-engine
run and the train CLI complete on the reduced model.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.fixture(scope="module")
def cfg():
    return reduced_config(get_config("llama3.2-3b"))


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0),
                                   jax_reduced(jax_get_config("llama3.2-3b"))))


def _run(cfg, jparams, mode, iterations=3, **kw):
    sched, parts = build_pipeline(
        cfg, _rl(mode, **kw), seed=0, scripted_fn=scripted, device="cpu",
        params=from_jax(jparams, cfg, device="cpu"))
    hist = sched.run(iterations)
    return sched, parts, hist


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


def test_trajectory_matches_jax_pipeline(cfg, jparams):
    """Two sync iterations on the same weights and scripted rollouts: the
    port's parameters track the JAX package's (f32, Adam at lr 1e-3)."""
    jrl = JaxRL(mode="sync", batch_prompts=3, group_size=4, micro_batch=2,
                num_inference_instances=2, max_prompt_len=24,
                max_response_len=T, learning_rate=1e-3, seed=0)
    jcfg = jax_reduced(jax_get_config("llama3.2-3b"))
    jsched, jparts = jax_pipeline(jcfg, jrl, seed=0, scripted_fn=jax_scripted)
    jsched.run(2)
    _, parts, hist = _run(cfg, jparams, "sync", iterations=2)
    assert [s.trained_tokens for s in hist] == \
        [s.trained_tokens for s in jsched.history]
    want = jax.device_get(jparts["tri"].policy)
    got = to_numpy(parts["tri"].policy)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-5, rtol=5e-4,
                                   err_msg=str(path))


def test_paged_engine_pipeline_on_cpu(cfg):
    """Two async iterations with the paged engine on the CPU, SPA packing,
    captured logprobs and a bf16 wire: on-policy, and after the last flip
    the pool holds the bf16-rounded policy of that version."""
    rl = _rl("async", batch_prompts=2, group_size=4, num_inference_instances=1,
             max_prompt_len=48, cbatch_slots=8, shared_prompt_attention=True,
             transfer_wire_dtype="bfloat16", learning_rate=1e-2)
    sched, parts = build_pipeline(cfg, rl, seed=0, device="cpu")
    flips = []
    ensure = sched.transfer.ensure

    def probe(params, version):
        v = ensure(params, version)
        pool = parts["pool"].instances[0].store.snapshot()[0]
        flips.append(all(torch.equal(p, q.to(torch.bfloat16).float())
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
    inst = parts["pool"].instances[0]
    assert inst.store.version == 1 and inst.store.staged_version == 2
    staged = inst.store.staged_params()
    assert all(torch.equal(p, q.to(torch.bfloat16).float()) for p, q in
               zip(_leaves(staged), _leaves(parts["tri"].policy)))


def test_group_engine_is_refused(cfg):
    with pytest.raises(ValueError, match="not ported"):
        build_pipeline(cfg, _rl("async", rollout_engine="group"),
                       device="cpu")
    with pytest.raises(ValueError, match="quiescent"):
        build_pipeline(cfg, _rl("async_offpolicy"), device="cpu")


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

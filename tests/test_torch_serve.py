"""The port's serving tier: request driver on a virtual clock, latency
metrics and arrivals against the JAX package's, sampling filters against
JAX's, sampled order-invariance, and the CLI end to end on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jax_serve  # noqa: E402
from repro.rl.rollout import _filter_logits as jax_filter_logits  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.paged import PagedGroupEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (RequestDriver, ServedRequest,  # noqa: E402
                                      build_paged_engine,
                                      compute_latency_metrics,
                                      poisson_arrivals, serve_paged,
                                      serve_requests)
from repro_torch.models import init  # noqa: E402
from repro_torch.rl.rollout import _filter_logits  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("llama3.2-3b"))
    return cfg, init(cfg, seed=0, device="cpu")


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        assert seconds >= 0
        self.t += seconds


class SteppedEngine:
    """The real engine with each step costing ``dt`` on a virtual clock
    (charged before the step's tokens are delivered)."""

    def __init__(self, eng, clock, dt):
        self.eng, self.clock, self.dt = eng, clock, dt
        self.G = eng.G

    @property
    def idle(self):
        return self.eng.idle

    def submit(self, *a, **kw):
        return self.eng.submit(*a, **kw)

    def step(self):
        if not self.eng.idle:
            self.clock.t += self.dt
        return self.eng.step()


def _prompts(n, seed=0, lo=3, hi=14):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 500, size=(rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


def test_driver_on_virtual_clock_streams_the_final_tokens(setup):
    """Single slot, 0.5 s per step, one late arrival: tokens stream at
    step boundaries (queueing shows in TTFT), the driver sleeps to the
    late arrival, and each request's stream equals its final response
    (``run`` checks stream == host_rows) and the batch-served tokens."""
    cfg, params = setup
    clock = VirtualClock()
    eng = build_paged_engine(cfg, max_prompt_len=16, max_new=4, num_slots=1,
                             page_size=4, temperature=0.0, device="cpu")
    eng.set_params(params)
    prompts = _prompts(3)
    reqs = [ServedRequest(rid=i, prompt=p, arrival=a, max_new=4)
            for i, (p, a) in enumerate(zip(prompts, [0.0, 0.1, 10.0]))]
    out = RequestDriver(SteppedEngine(eng, clock, 0.5), clock=clock).run(
        reqs, seed=1)
    lens = [len(r.tokens) for r in out]
    assert all(1 <= n <= 4 for n in lens)
    t0 = [0.5 * (k + 1) for k in range(lens[0])]
    t1 = [t0[-1] + 0.5 * (k + 1) for k in range(lens[1])]
    assert out[0].token_t == t0 and out[1].token_t == t1
    assert out[2].token_t[0] == pytest.approx(10.5)      # slept to arrival
    assert out[1].ttft == pytest.approx(t1[0] - 0.1)       # queueing included
    done, _ = serve_paged(cfg, prompts, max_prompt_len=16, max_new=4,
                          num_slots=1, page_size=4, temperature=0.0, seed=0,
                          device="cpu", params=params)
    by_rid = {c.request_id: c.response_ids.tolist() for c in done}
    assert [r.tokens for r in out] == [by_rid[i] for i in range(3)]


def test_latency_metrics_and_arrivals_match_jax():
    """The same scripted timestamp trace through both packages."""
    trace = [(0.0, [0.30, 0.40, 0.55, 0.60]), (0.2, [0.90, 1.00]),
             (0.5, [0.80, 1.10, 1.25]), (1.0, [1.70]), (2.0, [])]

    def reqs(cls):
        return [cls(rid=i, prompt=np.zeros(4, np.int32), arrival=a,
                    tokens=list(range(len(tt))), token_t=list(tt),
                    done_t=tt[-1] if tt else None)
                for i, (a, tt) in enumerate(trace)]
    got = compute_latency_metrics(reqs(ServedRequest))
    want = jax_serve.compute_latency_metrics(reqs(jax_serve.ServedRequest))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(poisson_arrivals(16, 4.0, seed=7),
                                  jax_serve.poisson_arrivals(16, 4.0, seed=7))
    assert compute_latency_metrics([])["tok_per_s"] == 0.0


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 1.0),
                                               (0.7, 0.9), (1.3, 0.5)])
def test_filter_logits_matches_jax(temperature, top_p):
    logits = np.random.RandomState(0).randn(5, 64).astype(np.float32) * 3
    want = np.asarray(jax_filter_logits(jnp.asarray(logits), temperature,
                                        top_p))
    got = _filter_logits(torch.from_numpy(logits), temperature, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6)


def test_sampled_tokens_do_not_depend_on_slot_count(setup):
    """Temperature 0.7: the same requests served through 1 slot and
    through 3 slots (different batch mates, different slots, different
    engine steps) give identical tokens per request."""
    cfg, params = setup
    prompts = _prompts(5, seed=3)
    out = {}
    for slots in (1, 3):
        reqs, metrics, _ = serve_requests(
            cfg, prompts, max_prompt_len=16, max_new=6, num_slots=slots,
            page_size=4, temperature=0.7, seed=5, params=params,
            device="cpu")
        out[slots] = [r.tokens for r in reqs]
        assert metrics["generated_tokens"] == sum(map(len, out[slots]))
    assert out[1] == out[3]
    reqs, _, _ = serve_requests(cfg, prompts, max_prompt_len=16, max_new=6,
                                num_slots=3, page_size=4, temperature=0.7,
                                seed=6, params=params, device="cpu")
    assert [r.tokens for r in reqs] != out[1]      # the seed does matter


@pytest.mark.parametrize("extra", [[], ["--rate", "200"]])
def test_cli_runs_end_to_end_on_cpu(capsys, extra):
    serve.main(["--device", "cpu", "--reduced", "--num-requests", "3",
                "--max-new", "4", "--slots", "2", *extra])
    out = capsys.readouterr().out
    assert "llama3.2-3b-smoke on cpu" in out
    assert ("TTFT" in out) == bool(extra)


def test_driver_rejects_grouped_engine(setup):
    cfg, _ = setup
    grouped = PagedGroupEngine(cfg, num_slots=2, page_size=4, num_pages=0,
                               max_prompt_len=8, max_new_tokens=4,
                               group_size=2, device="cpu")
    with pytest.raises(ValueError, match="1-row groups"):
        RequestDriver(grouped)

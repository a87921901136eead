"""Request-driven serving tier of the port: the paged engine behind a
request driver, runnable standalone.

The ``RequestDriver`` submits requests as they ARRIVE (Poisson or an
explicit trace), steps the engine, and records every streamed token's
time, from which the latency metrics serving systems quote are computed —
time-to-first-token (TTFT) and time-per-output-token (TPOT), p50/p99.

Usage (full-width llama3.2-3b on the GPU; ``--device cpu --reduced`` for
the 2-layer f32 variant on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
        --num-requests 8 --max-new 24 --slots 4 [--rate 4.0]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.models import init


@dataclasses.dataclass
class ServedRequest:
    """One request through the driver: its schedule, its streamed tokens,
    and the timestamps the latency metrics are computed from (seconds on
    the driver's clock, origin at ``run`` start)."""
    rid: int
    prompt: np.ndarray
    arrival: float                     # scheduled arrival offset
    max_new: Optional[int] = None
    submit_t: Optional[float] = None   # when the engine accepted it
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_t: List[float] = dataclasses.field(default_factory=list)
    done_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, measured from ARRIVAL (queueing included)."""
        return self.token_t[0] - self.arrival if self.token_t else None

    @property
    def tpot(self) -> Optional[float]:
        """Mean inter-token time after the first token."""
        if len(self.token_t) < 2:
            return None
        return (self.token_t[-1] - self.token_t[0]) / (len(self.token_t) - 1)


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds) for an open-loop Poisson process of
    ``rate`` requests/second; ``rate <= 0`` means all arrive at t=0."""
    if rate <= 0:
        return np.zeros(n)
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def compute_latency_metrics(reqs: List[ServedRequest]) -> Dict[str, float]:
    """p50/p99 TTFT and TPOT + throughput over a finished request set."""
    ttft = np.asarray([r.ttft for r in reqs if r.ttft is not None])
    tpot = np.asarray([r.tpot for r in reqs if r.tpot is not None])

    def pct(xs, q):
        return float(np.percentile(xs, q)) if len(xs) else 0.0

    done = [r.done_t for r in reqs if r.done_t is not None]
    toks = sum(len(r.tokens) for r in reqs)
    makespan = max(done) if done else 0.0
    return {
        "n_requests": len(reqs),
        "generated_tokens": toks,
        "makespan_s": makespan,
        "tok_per_s": toks / makespan if makespan > 0 else 0.0,
        "ttft_mean_s": float(ttft.mean()) if len(ttft) else 0.0,
        "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
        "tpot_mean_s": float(tpot.mean()) if len(tpot) else 0.0,
        "tpot_p50_s": pct(tpot, 50), "tpot_p99_s": pct(tpot, 99),
    }


class _WallClock:
    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class RequestDriver:
    """Open-loop request-queue driver over a paged engine built with
    ``group_size=1``: submits each request when its arrival time comes due,
    steps the engine, and records per-token delivery times through the
    engine's ``on_token`` hook. Request ``rid`` samples under the key
    ``(seed, rid)``, so its tokens do not depend on scheduling order.

    ``clock`` is injectable (``time``/``sleep``) so tests drive a virtual
    clock; the default is the wall clock."""

    def __init__(self, engine, *, clock=None):
        if engine.G != 1:
            raise ValueError("RequestDriver serves 1-row groups")
        self.eng = engine
        self.clock = clock if clock is not None else _WallClock()

    def run(self, requests: List[ServedRequest], seed: int
            ) -> List[ServedRequest]:
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        pending = deque(reqs)
        handles: Dict[int, object] = {}
        t0 = self.clock.time()

        def now() -> float:
            return self.clock.time() - t0

        def sink(r: ServedRequest):
            def deliver(row_idx: int, token_id: int) -> None:
                r.tokens.append(int(token_id))
                r.token_t.append(now())
            return deliver

        while pending or not self.eng.idle:
            while pending and pending[0].arrival <= now():
                r = pending.popleft()
                r.submit_t = now()
                handles[r.rid] = self.eng.submit(
                    r.prompt, (seed, r.rid), max_new=r.max_new,
                    on_token=sink(r))
            if not self.eng.step() and pending:
                # engine drained before the next arrival: sleep up to it
                self.clock.sleep(max(0.0, pending[0].arrival - now()))
        t_end = now()
        for r in reqs:
            h = handles[r.rid]
            h.result(timeout=0)       # completion check (raises if not)
            r.done_t = r.token_t[-1] if r.token_t else t_end
            final = list(map(int, h.host_rows()[0]))
            if final != r.tokens:
                raise RuntimeError(f"streaming delivery diverged from the "
                                   f"final response for request {r.rid}")
        return reqs


def build_paged_engine(cfg, *, max_prompt_len: int, max_new: int,
                       num_slots: int = 4, page_size: int = 16,
                       temperature: float = 0.7, device="cuda"):
    """One serving-shaped paged engine (group_size=1, no logprob capture):
    enough pages for every slot to hold a full prompt + response."""
    if num_slots < 1 or page_size < 1:
        raise ValueError(f"serving needs num_slots >= 1 and "
                         f"page_size >= 1, got {num_slots}/{page_size}")
    n_pp = -(-max_prompt_len // page_size)
    n_rp = -(-max_new // page_size)
    return PagedGroupEngine(cfg, num_slots=num_slots, page_size=page_size,
                            num_pages=FIRST_PAGE + num_slots * (n_pp + n_rp),
                            max_prompt_len=max_prompt_len,
                            max_new_tokens=max_new, group_size=1,
                            temperature=temperature,
                            capture_logprobs=False,   # serving: no consumer
                            device=device)


def serve_paged(cfg, prompts, *, max_prompt_len: int, max_new: int,
                num_slots: int = 4, page_size: int = 16,
                temperature: float = 0.7, seed: int = 0, device="cuda",
                params=None):
    """Serve independent requests through the paged engine as one batch
    (each request its own 1-row group); returns (completions in completion
    order, stats)."""
    eng = build_paged_engine(cfg, max_prompt_len=max_prompt_len,
                             max_new=max_new, num_slots=num_slots,
                             page_size=page_size, temperature=temperature,
                             device=device)
    if params is None:
        params = init(cfg, seed=seed, device=eng.device)
    t0 = time.time()
    done = eng.serve(params, prompts, seed + 1)
    wall = time.time() - t0
    toks = sum(len(c.response_ids) for c in done)
    return done, {"wall_s": wall, "generated_tokens": toks,
                  "tok_per_s": toks / wall, "decode_steps": eng.decode_steps,
                  "peak_pages": eng.peak_pages_used}


def serve_requests(cfg, prompts, *, max_prompt_len: int, max_new: int,
                   num_slots: int = 4, page_size: int = 16,
                   temperature: float = 0.7, seed: int = 0, rate: float = 0.0,
                   arrivals: Optional[np.ndarray] = None, params=None,
                   engine=None, device="cuda"):
    """Serve ``prompts`` as a TIMED request stream through the
    ``RequestDriver`` (Poisson arrivals at ``rate`` req/s, or an explicit
    ``arrivals`` trace); returns (requests with per-token timestamps,
    latency metrics, engine stats)."""
    if engine is None:
        engine = build_paged_engine(
            cfg, max_prompt_len=max_prompt_len, max_new=max_new,
            num_slots=num_slots, page_size=page_size,
            temperature=temperature, device=device)
    if params is None:
        params = init(cfg, seed=seed, device=engine.device)
    engine.set_params(params)
    if arrivals is None:
        arrivals = poisson_arrivals(len(prompts), rate, seed=seed)
    reqs = [ServedRequest(rid=i, prompt=np.asarray(p, np.int32),
                          arrival=float(t), max_new=max_new)
            for i, (p, t) in enumerate(zip(prompts, arrivals))]
    RequestDriver(engine).run(reqs, seed + 1)
    stats = {"decode_steps": engine.decode_steps,
             "peak_pages": engine.peak_pages_used}
    return reqs, compute_latency_metrics(reqs), stats


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve requests through the port's paged engine.")
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--engine", default="paged", choices=["paged"])
    ap.add_argument("--reduced", action="store_true",
                    help="serve the 2-layer f32 variant of --arch instead of "
                         "its full width")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4, help="decode slots")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s): run the request "
                         "driver and report TTFT/TPOT p50/p99 (0 = all "
                         "requests arrive at once, batch mode)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tok = Tokenizer(cfg.vocab_size)
    problems = ArithmeticTask(seed=args.seed).batch(args.num_requests)
    prompts = [np.asarray(tok.encode(p.prompt)[: args.max_prompt_len],
                          np.int32) for p in problems]
    kw = dict(max_prompt_len=args.max_prompt_len, max_new=args.max_new,
              num_slots=args.slots, page_size=args.page_size,
              temperature=args.temperature, seed=args.seed,
              device=args.device)

    if args.rate > 0:
        reqs, m, _ = serve_requests(cfg, prompts, rate=args.rate, **kw)
        print(f"{cfg.name} on {args.device} (driver x{args.slots} @ "
              f"{args.rate} req/s): {m['generated_tokens']} tokens, "
              f"TTFT p50={m['ttft_p50_s'] * 1e3:.0f}ms "
              f"p99={m['ttft_p99_s'] * 1e3:.0f}ms, "
              f"TPOT p50={m['tpot_p50_s'] * 1e3:.1f}ms "
              f"p99={m['tpot_p99_s'] * 1e3:.1f}ms, "
              f"{m['tok_per_s']:.1f} tok/s")
        for r in reqs[:4]:
            print(f"  req {r.rid} arrived {r.arrival:.2f}s "
                  f"ttft {r.ttft:.2f}s: {tok.decode(r.tokens)!r}")
        return

    done, stats = serve_paged(cfg, prompts, **kw)
    print(f"{cfg.name} on {args.device} (paged x{args.slots}): {len(done)} "
          f"requests in completion order, {stats['generated_tokens']} tokens "
          f"in {stats['wall_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['decode_steps']} decode steps)")
    for c in done[:4]:
        print(f"  req {c.request_id} finished at step {c.finish_step}: "
              f"{tok.decode(c.response_ids.tolist())!r}")


if __name__ == "__main__":
    main()

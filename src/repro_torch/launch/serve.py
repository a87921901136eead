"""Serving tier of the port: the paged engine behind a request driver,
and the group-at-a-time Sampler serving one fixed batch
(``serve_batch``, ``--engine fixed``), runnable standalone.

The ``RequestDriver`` submits requests as they ARRIVE (Poisson or an
explicit trace), steps the engine, and records every streamed token's
time, from which the latency metrics serving systems quote are computed —
time-to-first-token (TTFT) and time-per-output-token (TPOT), p50/p99.

``--spec`` turns on speculative decode (prompt-lookup drafts, or with
``--spec-draft model`` a resident half-depth draft model's, verified in
one k+1-token forward), ``--prefix-cache`` the radix prefix cache, and
``--shared-system N`` serves N requests that share one system prompt
through the cache (``serve_shared``).

Usage (full-width llama3.2-3b on the GPU; ``--device cpu --reduced`` for
the 2-layer f32 variant on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
        --num-requests 8 --max-new 24 --slots 4 [--rate 4.0] \\
        [--spec --spec-k 4 [--spec-draft model]] [--prefix-cache] \\
        [--shared-system 8]
    PYTHONPATH=src python -m repro_torch.launch.serve --engine fixed \\
        --num-requests 8 --max-new 24
(the paged engine is the port's default; the JAX package's is ``fixed``)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.cbatch import Completed
from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.models import init
from repro_torch.rl.rollout import Sampler


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


def _settle_batch(out, t0: float):
    """Boundary settle for one served batch: read the response lengths
    back (which waits for the batch) and the token count, one call frame
    below the serving entry point, so the entry point itself reads
    nothing back."""
    lens = out.response_len.cpu()      # waits for the batch
    wall = time.time() - t0
    # repro: allow(host-sync): once per served batch, for the stats dict
    return wall, int(lens.sum())


def serve_batch(cfg, prompts, *, max_prompt_len: int, max_new: int,
                temperature: float = 0.7, seed: int = 0, device="cuda",
                params=None):
    """Serve a batch of requests in one call of the group-at-a-time
    Sampler (no logprob capture: serving has no trainer to read them),
    sampled under the key ``seed + 1``; returns (the RolloutBatch, on the
    device, and stats: wall seconds, generated tokens, tok/s)."""
    sampler = Sampler(cfg, max_prompt_len, max_new, temperature=temperature,
                      capture_logprobs=False, device=device)
    if params is None:
        params = init(cfg, seed=seed, device=sampler.device)
    t0 = time.time()
    out = sampler.generate(params, prompts, seed + 1)
    wall, toks = _settle_batch(out, t0)
    return out, {"wall_s": wall, "generated_tokens": toks,
                 "tok_per_s": toks / wall}


def build_paged_engine(cfg, *, max_prompt_len: int, max_new: int,
                       num_slots: int = 4, page_size: int = 16,
                       temperature: float = 0.7, seed: int = 0,
                       spec_k: int = 0, spec_draft: str = "prompt_lookup",
                       prefix_cache: bool = False, drain_interval: int = 1,
                       device="cuda"):
    """One serving-shaped paged engine (group_size=1, no logprob capture):
    enough pages for every slot to hold a full prompt + response, plus
    (with the prefix cache) one prompt's pages of headroom so a cached
    prompt can stay resident. ``drain_interval`` D > 1 decodes D steps a
    block: a request's tokens then arrive in bursts of up to D.
    ``spec_draft`` picks the spec plane's draft provider (a draft model's
    weights are made from ``seed``)."""
    if num_slots < 1 or page_size < 1:
        raise ValueError(f"serving needs num_slots >= 1 and "
                         f"page_size >= 1, got {num_slots}/{page_size}")
    n_pp = -(-max_prompt_len // page_size)
    n_rp = -(-max_new // page_size)
    pages = FIRST_PAGE + num_slots * (n_pp + n_rp)
    if prefix_cache:
        pages += n_pp
    return PagedGroupEngine(cfg, num_slots=num_slots, page_size=page_size,
                            num_pages=pages, max_prompt_len=max_prompt_len,
                            max_new_tokens=max_new, group_size=1,
                            temperature=temperature,
                            capture_logprobs=False,   # serving: no consumer
                            spec_k=spec_k, spec_draft=spec_draft,
                            prefix_cache=prefix_cache,
                            drain_interval=drain_interval, seed=seed,
                            device=device)


def serving_stats(eng, generated_tokens: int) -> dict:
    """The serving stats of an engine's run: decode steps and peak pages,
    with a sliding window the pages it reclaimed, with spec on the
    acceptance rate and tokens per per-row verify forward (1.0 = no gain,
    up to k+1), with the radix cache its hit rate and pages."""
    stats = {"decode_steps": eng.decode_steps,
             "peak_pages": eng.peak_pages_used}
    if eng.window is not None:
        stats["reclaimed_pages"] = eng.reclaimed_pages
    if eng.spec_k:
        stats.update(spec_k=eng.spec_k, acceptance_rate=eng.acceptance_rate,
                     tokens_per_forward=(generated_tokens / eng.spec_steps
                                         if eng.spec_steps else 0.0),
                     rolled_back_pages=eng.rolled_back_pages)
    if eng.radix is not None:
        stats.update(prefix_hit_rate=eng.prefix_hit_rate,
                     prefix_hit_pages=eng.prefix_hit_pages,
                     prefix_miss_pages=eng.prefix_miss_pages,
                     prefix_evicted_pages=eng.prefix_evicted_pages)
    return stats


def serve_paged(cfg, prompts, *, max_prompt_len: int, max_new: int,
                num_slots: int = 4, page_size: int = 16,
                temperature: float = 0.7, seed: int = 0, spec_k: int = 0,
                spec_draft: str = "prompt_lookup", prefix_cache: bool = False,
                drain_interval: int = 1, device="cuda", params=None):
    """Serve independent requests through the paged engine as one batch
    (each request its own 1-row group); returns (completions in completion
    order, stats)."""
    eng = build_paged_engine(cfg, max_prompt_len=max_prompt_len,
                             max_new=max_new, num_slots=num_slots,
                             page_size=page_size, temperature=temperature,
                             seed=seed, spec_k=spec_k, spec_draft=spec_draft,
                             prefix_cache=prefix_cache,
                             drain_interval=drain_interval, device=device)
    if params is None:
        params = init(cfg, seed=seed, device=eng.device)
    eng.set_params(params)  # set-up (the graph's capture) outside the wall
    del params              # on the card the engine holds its own copy
    t0 = time.time()
    done = eng.serve(eng.params, prompts, seed + 1)
    wall = time.time() - t0
    toks = sum(len(c.response_ids) for c in done)
    return done, {"wall_s": wall, "generated_tokens": toks,
                  "tok_per_s": toks / wall, **serving_stats(eng, toks)}


def serve_shared(cfg, system_prompt, suffixes, *, max_prompt_len: int,
                 max_new: int, page_size: int = 16, temperature: float = 0.7,
                 seed: int = 0, spec_k: int = 0,
                 spec_draft: str = "prompt_lookup", device="cuda",
                 params=None, engine=None):
    """Serve N requests that share one system prompt through the radix
    prefix cache: each request submits its FULL prompt (system + its own
    suffix) as a 1-row group; the first admission prefills the system
    pages cold and inserts them into the tree, every later request retains
    them and prefills only its own suffix into private pages.

    Returns (completions in request order, stats incl. the prompt pages
    the cache served in place of a prefill)."""
    N = len(suffixes)
    if engine is None:
        full = max(len(system_prompt) + len(s) for s in suffixes)
        engine = build_paged_engine(
            cfg, max_prompt_len=max(max_prompt_len, full), max_new=max_new,
            num_slots=N, page_size=page_size, temperature=temperature,
            seed=seed, spec_k=spec_k, spec_draft=spec_draft,
            prefix_cache=True, device=device)
    if engine.radix is None:
        raise ValueError("serve_shared needs an engine built with "
                         "prefix_cache=True")
    if params is None:
        params = init(cfg, seed=seed, device=engine.device)
    engine.set_params(params)
    del params              # on the card the engine holds its own copy
    system = np.asarray(system_prompt, np.int32)
    t0 = time.time()
    handles = [engine.submit(np.concatenate([system,
                                             np.asarray(s, np.int32)]),
                             (seed + 1, i))
               for i, s in enumerate(suffixes)]
    while engine.step():
        pass
    wall = time.time() - t0
    done = []
    for i, h in enumerate(handles):
        h.result(timeout=0)           # completion check (raises if not)
        done.append(Completed(request_id=i, response_ids=h.host_rows()[0],
                              finish_step=h.finish_step))
    toks = sum(len(c.response_ids) for c in done)
    return done, {"wall_s": wall, "generated_tokens": toks,
                  "tok_per_s": toks / wall,
                  # pages served from the tree = prompt pages not prefilled
                  "prompt_pages_saved": engine.prefix_hit_pages,
                  **serving_stats(engine, toks)}


def serve_requests(cfg, prompts, *, max_prompt_len: int, max_new: int,
                   num_slots: int = 4, page_size: int = 16,
                   temperature: float = 0.7, seed: int = 0, rate: float = 0.0,
                   spec_k: int = 0, spec_draft: str = "prompt_lookup",
                   prefix_cache: bool = False,
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
            temperature=temperature, seed=seed, spec_k=spec_k,
            spec_draft=spec_draft, prefix_cache=prefix_cache, device=device)
    if params is None:
        params = init(cfg, seed=seed, device=engine.device)
    engine.set_params(params)
    del params              # on the card the engine holds its own copy
    if arrivals is None:
        arrivals = poisson_arrivals(len(prompts), rate, seed=seed)
    reqs = [ServedRequest(rid=i, prompt=np.asarray(p, np.int32),
                          arrival=float(t), max_new=max_new)
            for i, (p, t) in enumerate(zip(prompts, arrivals))]
    RequestDriver(engine).run(reqs, seed + 1)
    m = compute_latency_metrics(reqs)
    return reqs, m, serving_stats(engine, m["generated_tokens"])


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve requests through the port's paged engine, or "
                    "as one fixed batch through the group Sampler.")
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--engine", default="paged", choices=["paged", "fixed"],
                    help="paged: continuous batching over the page pool "
                         "(the port's default); fixed: every request in "
                         "one lock-step batch of the group Sampler")
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
    ap.add_argument("--spec", action="store_true",
                    help="speculative decode: prompt-lookup drafts verified "
                         "in one k+1-token forward (stats report the "
                         "acceptance rate)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify step")
    ap.add_argument("--spec-draft", default="prompt_lookup",
                    choices=["prompt_lookup", "model"],
                    help="draft provider: n-gram prompt lookup (no extra "
                         "model) or a small resident draft model")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged pool: requests "
                         "sharing a token prefix share its pages")
    ap.add_argument("--shared-system", type=int, default=0, metavar="N",
                    help="serve N requests sharing one system prompt "
                         "through the radix prefix cache (suffix-only "
                         "prefill into private pages)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tok = Tokenizer(cfg.vocab_size)
    spec_k = args.spec_k if args.spec else 0
    if args.engine == "fixed" and (args.spec or args.prefix_cache
                                   or args.rate or args.shared_system):
        raise SystemExit("--spec, --prefix-cache, --rate and "
                         "--shared-system ride the paged engine; drop "
                         "--engine fixed")
    plane = dict(spec_k=spec_k, spec_draft=args.spec_draft)
    if args.shared_system:
        # the radix tree serves every request's system pages from cache
        # after the first admission
        system = np.asarray(tok.encode("You are a terse arithmetic solver. ")
                            [: args.max_prompt_len], np.int32)
        problems = ArithmeticTask(seed=args.seed).batch(args.shared_system)
        suffixes = [np.asarray(tok.encode(p.prompt, bos=False)
                               [: args.max_prompt_len], np.int32)
                    for p in problems]
        done, stats = serve_shared(
            cfg, system, suffixes, max_prompt_len=args.max_prompt_len,
            max_new=args.max_new, page_size=args.page_size,
            temperature=args.temperature, seed=args.seed,
            device=args.device, **plane)
        extra = (f", accept={stats['acceptance_rate']:.2f}" if spec_k
                 else "")
        print(f"{cfg.name} on {args.device} (shared-system "
              f"x{args.shared_system}): {stats['generated_tokens']} tokens "
              f"in {stats['wall_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
              f"{stats['decode_steps']} decode steps, prefix hit rate "
              f"{stats['prefix_hit_rate']:.2f}, "
              f"{stats['prompt_pages_saved']} prompt pages saved by the "
              f"cache{extra})")
        for c in done[:4]:
            print(f"  req {c.request_id}: "
                  f"{tok.decode(c.response_ids.tolist())!r}")
        return

    problems = ArithmeticTask(seed=args.seed).batch(args.num_requests)
    prompts = [np.asarray(tok.encode(p.prompt)[: args.max_prompt_len],
                          np.int32) for p in problems]
    kw = dict(max_prompt_len=args.max_prompt_len, max_new=args.max_new,
              num_slots=args.slots, page_size=args.page_size,
              temperature=args.temperature, seed=args.seed,
              device=args.device, prefix_cache=args.prefix_cache, **plane)
    extra_fmt = (lambda st: (f", accept={st['acceptance_rate']:.2f}, "
                             f"{st['tokens_per_forward']:.2f} tok/forward"
                             if spec_k else "")
                 + (f", prefix hit rate {st['prefix_hit_rate']:.2f}"
                    if args.prefix_cache else ""))

    if args.engine == "fixed":
        out, stats = serve_batch(
            cfg, prompts, max_prompt_len=args.max_prompt_len,
            max_new=args.max_new, temperature=args.temperature,
            seed=args.seed, device=args.device)
        print(f"{cfg.name} on {args.device} (fixed batch of "
              f"{len(prompts)}): {stats['generated_tokens']} tokens in "
              f"{stats['wall_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s)")
        resp, lens = out.response_ids.tolist(), out.response_len.tolist()
        for i in range(min(4, len(prompts))):
            print(f"  req {i}: {tok.decode(resp[i][: lens[i]])!r}")
        return

    if args.rate > 0:
        reqs, m, st = serve_requests(cfg, prompts, rate=args.rate, **kw)
        print(f"{cfg.name} on {args.device} (driver x{args.slots} @ "
              f"{args.rate} req/s): {m['generated_tokens']} tokens, "
              f"TTFT p50={m['ttft_p50_s'] * 1e3:.0f}ms "
              f"p99={m['ttft_p99_s'] * 1e3:.0f}ms, "
              f"TPOT p50={m['tpot_p50_s'] * 1e3:.1f}ms "
              f"p99={m['tpot_p99_s'] * 1e3:.1f}ms, "
              f"{m['tok_per_s']:.1f} tok/s{extra_fmt(st)}")
        for r in reqs[:4]:
            print(f"  req {r.rid} arrived {r.arrival:.2f}s "
                  f"ttft {r.ttft:.2f}s: {tok.decode(r.tokens)!r}")
        return

    done, stats = serve_paged(cfg, prompts, **kw)
    print(f"{cfg.name} on {args.device} (paged x{args.slots}"
          f"{f' spec k={spec_k}' if spec_k else ''}): {len(done)} "
          f"requests in completion order, {stats['generated_tokens']} tokens "
          f"in {stats['wall_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s, "
          f"{stats['decode_steps']} decode steps{extra_fmt(stats)})")
    for c in done[:4]:
        print(f"  req {c.request_id} finished at step {c.finish_step}: "
              f"{tok.decode(c.response_ids.tolist())!r}")


if __name__ == "__main__":
    main()

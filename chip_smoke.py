#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card (an H100):

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (every phase fails the run on error):

  1. device: the card's name and power limit (the raw nvidia-smi line is
     printed too), torch.version.cuda, and the seconds the build of the
     CUDA kernels (src/repro_torch/kernels/csrc/*.cu, nvcc for sm_90a, all
     sources compiled in parallel) took, with ptxas' register/spill lines;
  2. kernels: each kernel's wrapper on the card against its plain PyTorch
     version (run in f32 on the same inputs), at full-width llama3.2-3b
     heads (H 24, Hkv 8, D 128) in bf16 and f32: SPA prefill over a
     1024-token prompt, an SPA-packed row (prompt 256 + 4 x 128
     responses) and a windowed case; paged decode at B 4 (the serving shape below) and B 16 with
     contexts up to 8k, page 16. Each case prints its max error against
     the stated tolerance, the kernel's time, the plain version's time, one
     PyTorch library call's time (scaled_dot_product_attention with the
     equivalent boolean mask, after a gather of the pages for decode — the
     port never calls it), and the least time the card could take (bytes
     over 3.35 TB/s or operations over the dtype's peak, whichever is
     larger; operations count the (query, key) pairs these inputs make
     visible). Each timed call starts with the 50 MB L2 cache flushed;
  3. serve: full-width llama3.2-3b (28 layers, random bf16 weights made
     on the card from --seed) serves 8 requests (prompts of 64 to 1024
     tokens, 32 new tokens each, 4 slots, page 16, temperature 0.7)
     through RequestDriver and the paged engine. The kernel launch counts
     are reset just before and read just after, and must equal 28 x
     prefills (SPA) and 28 x decode steps (paged decode);
  4. profile: 8 unprofiled decode steps of the same engine at 4 busy
     slots (host wall time per step), then 8 more under torch.profiler
     (device-busy time per step: the sum of kernel self times; the
     kernels that take the most device time), and the device's idle
     share estimated from the two windows;
  5. parity: reduced llama (2 layers, f32) on the card against the same
     engine on the CPU, greedy: identical tokens, prefill logits within
     1e-3.

Then one line {"kernels": [...]} with both kernels at the serving shapes,
and last {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,          # dense tensor-core bf16
              "float32": 67e12}            # f32 outside the tensor cores
# Each kernel is held against its plain version run in f32 on the same
# inputs. Both kernels compute in f32 and round once at the output, so a
# bf16 result may differ by one bf16 ulp (2^-7 of the value) plus f32
# summation-order noise; f32 by the noise alone.
TOL = {"bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-5},
       "float32": {"rtol": 2e-5, "atol": 2e-5}}
FLUSH_BYTES = 64 << 20                     # > the H100's 50 MB L2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------

class Timer:
    """CUDA-event time of one call, averaged over ``iters`` calls, each
    starting with the L2 cache flushed (the serving path reads 28 layers
    of K/V and weights between two calls of the same layer's kernel)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32(args):
    """The same inputs with every floating tensor as float32 (exact)."""
    return tuple(a.float() if a.is_floating_point() else a for a in args)


def max_err(torch, got, want, tol: dict):
    got = got.float()
    if not bool(torch.isfinite(got).all()):
        fail("kernel output is not finite")
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **tol))
    return err, ok


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def spa_case(torch, timer, dev, gen, dtype, *, prompt, responses=0,
             resp_len=0, window=None):
    import torch.nn.functional as F
    from repro_torch.kernels.spa_attention import (allow_mask,
                                                   chunked_attention,
                                                   spa_attention)
    H, Hkv, D = 24, 8, 128
    S = prompt + responses * resp_len
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    seg = torch.zeros(S, dtype=torch.int32, device=dev)
    for r in range(responses):
        lo = prompt + r * resp_len
        pos[lo:lo + resp_len] = torch.arange(prompt, prompt + resp_len,
                                             device=dev)
        seg[lo:lo + resp_len] = r + 1
    pos, seg = pos[None].contiguous(), seg[None].contiguous()
    dt = getattr(torch, dtype)
    q = torch.randn(1, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(1, S, Hkv, D, generator=gen, device=dev).to(dt)
    args = (q, k, v, pos, pos, seg, seg)
    got = spa_attention(*args, window=window)
    want = chunked_attention(*f32(args), window=window)
    err, ok = max_err(torch, got, want, TOL[dtype])
    mask = allow_mask(pos, pos, seg, seg, window)[:, None]     # (1,1,S,S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    pairs = int(mask.sum())
    elt = q.element_size()
    bytes_moved = (q.numel() + k.numel() + v.numel() + got.numel()) * elt \
        + 4 * 4 * S
    b_ms, b_by = bound(bytes_moved, 4.0 * D * H * pairs, dtype)
    return {
        "kernel": "spa_attention", "dtype": dtype, "B": 1, "S": S, "H": H,
        "Hkv": Hkv, "D": D, "prompt": prompt, "responses": responses,
        "resp_len": resp_len, "window": window, "visible_pairs": pairs,
        "max_abs_err": err, "tol": TOL[dtype], "ok": ok,
        "ms": timer.ms(lambda: spa_attention(*args, window=window), 20),
        "plain_ms": timer.ms(lambda: chunked_attention(*args, window=window),
                             5),
        "library_ms": timer.ms(library, 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def decode_case(torch, timer, dev, gen, dtype, *, B, ctx_max, page=16):
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    H, Hkv, D = 24, 8, 128
    INVALID = 2 ** 30
    n_max = -(-ctx_max // page)
    lens = np.linspace(max(1, ctx_max // 8), ctx_max, B).astype(int)
    n_pages = [-(-int(n) // page) for n in lens]
    P = 2 + sum(n_pages)
    rng = np.random.RandomState(B)
    ids = rng.permutation(np.arange(2, P))         # fragmented pool
    table = np.zeros((B, n_max), np.int32)
    pos = np.full((P, page), INVALID, np.int32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(lens, n_pages)):
        for j in range(npg):
            pid = ids[nxt]
            nxt += 1
            table[b, j] = pid
            p = np.arange(j * page, (j + 1) * page)
            pos[pid] = np.where(p < n, p, INVALID)
    q_pos = (lens - 1).astype(np.int32)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dt)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    pos_t = torch.from_numpy(pos).to(dev)
    table_t = torch.from_numpy(table).to(dev)
    qpos_t = torch.from_numpy(q_pos).to(dev)
    args = (q, kp, vp, pos_t, table_t, qpos_t)
    got = paged_decode_attention(*args)
    want = paged_decode_attention_plain(*f32(args))
    err, ok = max_err(torch, got, want, TOL[dtype])

    def library():
        k, v, kv_pos = gather_pages(kp, vp, pos_t, table_t)
        mask = (kv_pos <= qpos_t[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    visible = int(lens.sum())                    # keys these rows can see
    elt = q.element_size()
    bytes_moved = (2 * q.numel() + 2 * visible * Hkv * D) * elt \
        + 4 * (sum(n_pages) * page + table.size + B)
    b_ms, b_by = bound(bytes_moved, 4.0 * D * H * visible, dtype)
    return {
        "kernel": "paged_decode_attention", "dtype": dtype, "B": B,
        "ctx_max": int(ctx_max), "n_max": n_max, "page": page, "H": H,
        "Hkv": Hkv, "D": D, "visible_keys": visible,
        "max_abs_err": err, "tol": TOL[dtype], "ok": ok,
        "ms": timer.ms(lambda: paged_decode_attention(*args), 20),
        "plain_ms": timer.ms(lambda: paged_decode_attention_plain(*args), 5),
        "library_ms": timer.ms(library, 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


# ---------------------------------------------------------------------
# phase 3: full-width serving; phase 4: reduced parity with the CPU
# ---------------------------------------------------------------------

def serve_full_width(torch, np, dev, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_requests
    from repro_torch.models import init
    cfg = get_config("llama3.2-3b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1025, size=8)
    lens[int(np.argmax(lens))] = 1024
    prompts = [rng.randint(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lens]
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.7)
    eng = build_paged_engine(cfg, device=dev, **kw)
    # warm-up request (cuBLAS handles, allocator), then the measured run
    serve_requests(cfg, prompts[:1], params=params, engine=eng, seed=seed,
                   arrivals=np.zeros(1), **kw)
    eng.reset_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    reqs, m, stats = serve_requests(cfg, prompts, params=params, engine=eng,
                                    seed=seed, arrivals=np.zeros(len(prompts)),
                                    **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    snap = eng.stats_snapshot()
    L = cfg.num_layers
    if launches["spa_attention"] != L * snap["prefills"] or \
            snap["prefills"] != len(prompts):
        fail(f"SPA launches {launches['spa_attention']} != {L} x "
             f"{snap['prefills']} prefills")
    if launches["paged_decode_attention"] != L * snap["decode_steps"] or \
            snap["decode_steps"] == 0:
        fail(f"decode launches {launches['paged_decode_attention']} != "
             f"{L} x {snap['decode_steps']} decode steps")
    for r in reqs:
        if not 1 <= len(r.tokens) <= 32 or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"request {r.rid}: bad tokens {r.tokens}")
    if not bool(torch.isfinite(eng.logits).all()):
        fail("non-finite logits after serving")
    return eng, params, prompts, {
        "phase": "serve", "arch": cfg.name, "layers": L,
        "d_model": cfg.d_model, "params": sum(
            t.numel() for t in _leaves(params)),
        "dtype": cfg.param_dtype, "init_s": init_s,
        "requests": len(reqs), "prompt_lens": [int(n) for n in lens],
        "max_new": 32, "slots": 4, "page": 16, "temperature": 0.7,
        "generated_tokens": m["generated_tokens"],
        "tok_per_s": m["tok_per_s"], "makespan_s": m["makespan_s"],
        "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
        "tpot_p50_s": m["tpot_p50_s"], "tpot_p99_s": m["tpot_p99_s"],
        "prefills": snap["prefills"], "decode_steps": snap["decode_steps"],
        "peak_pages": stats["peak_pages"], "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "first_tokens": [r.tokens[:8] for r in reqs[:2]],
    }


def profile_decode(torch, np, eng, prompts, seed: int, steps: int = 8):
    """Device busy and idle time of decode steps with every slot busy
    (prefills happen before the windows open). Two adjacent windows of
    ``steps`` steps each: the first unprofiled, for the host wall time of
    a step; the second under torch.profiler, for the device-busy time of
    a step (the profiler slows the host, not the kernels). The idle share
    is an estimate from the two windows."""
    from torch.profiler import ProfilerActivity, profile

    def wall_ms_per_step() -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps
    handles = [eng.submit(p, (seed, 1000 + i), max_new=32)
               for i, p in enumerate(prompts[:eng.B])]
    eng.step()                                  # admission + prefills
    torch.cuda.synchronize()
    wall_ms = wall_ms_per_step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = wall_ms_per_step()
    while eng.step():
        pass
    if not all(h.done() for h in handles):
        fail("profiled requests did not complete")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "phase": "profile", "steps": steps, "slots_busy": eng.B,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "device_busy_ms_per_step": busy_ms,
        # busy time of the profiled window over wall time of the unprofiled
        # one; null when the profiler saw no device activity on this machine
        "device_idle_share_est": (1.0 - busy_ms / wall_ms) if busy_ms
        else None,
        "top_kernels_ms_per_step": [
            [e.key[:80], e.self_device_time_total / 1e3 / steps, e.count]
            for e in top],
    }


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def reduced_parity(torch, np, dev, seed: int):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import forward, init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=seed, device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}
    p_gpu = to(p_cpu, dev)
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in rng.randint(5, 48, size=4)]
    kw = dict(max_prompt_len=48, max_new=16, num_slots=2, page_size=16,
              temperature=0.0, seed=seed)
    done_cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu, **kw)
    done_gpu, _ = serve_paged(cfg, prompts, device=dev, params=p_gpu, **kw)
    tok_cpu = {c.request_id: c.response_ids.tolist() for c in done_cpu}
    tok_gpu = {c.request_id: c.response_ids.tolist() for c in done_gpu}
    if tok_cpu != tok_gpu:
        fail(f"greedy tokens differ between card and CPU: {tok_gpu} vs "
             f"{tok_cpu}")
    toks = torch.from_numpy(rng.randint(3, cfg.vocab_size, size=(2, 48)))
    lg_cpu, _ = forward(p_cpu, cfg, toks)
    lg_gpu, _ = forward(p_gpu, cfg, toks.to(dev))
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if err > 1e-3:
        fail(f"prefill logits differ by {err} > 1e-3 between card and CPU")
    return {"phase": "parity", "arch": cfg.name, "dtype": "float32",
            "requests": len(prompts),
            "tokens": sum(len(t) for t in tok_cpu.values()),
            "tokens_identical": True, "prefill_logits_max_abs_err": err,
            "tol": 1e-3}


# ---------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi)
    t0 = time.time()
    logs = build.build()
    build_s = time.time() - t0
    for name in build.sources():
        build.load(name)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})

    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = []
    for dtype in ("bfloat16", "float32"):
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=1024))
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=256,
                              responses=4, resp_len=128))
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=1024,
                              window=256))
        cases.append(decode_case(torch, timer, dev, gen, dtype, B=4,
                                 ctx_max=1056))
        cases.append(decode_case(torch, timer, dev, gen, dtype, B=16,
                                 ctx_max=8192))
    for c in cases:
        emit({"phase": "kernel", **c})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version")

    eng, params, prompts, serve = serve_full_width(torch, np, dev, args.seed)
    launches = serve["launches"]
    main_dec = cases[3]                       # bf16, B 4: the serving shape
    serve["attn_decode_share_of_tpot"] = (
        serve["layers"] * main_dec["ms"] / 1e3 / serve["tpot_p50_s"])
    emit(serve)
    emit(profile_decode(torch, np, eng, prompts, args.seed))
    del eng, params
    emit(reduced_parity(torch, np, dev, args.seed))

    meta = {
        "spa_attention": ("src/repro_torch/kernels/csrc/spa_attention.cu",
                          "src/repro/kernels/spa_attention.py:104", cases[0]),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:242", cases[3]),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": c["max_abs_err"],
         "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for name, (src, rep, c) in meta.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

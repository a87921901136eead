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
     1e-3;
  6. train: one periodic-async GRPO run through the port's build_pipeline:
     full-width llama3.2-3b cut to 12 layers, f32 parameters from --seed,
     mode async, one paged instance with 8 slots, N 4 prompts x G 8,
     prompts up to 128 tokens, responses up to 64, SPA packing, captured
     logprobs, a bf16 wire with overlap, 3 iterations. Checks staleness 0
     and trained tokens on every iteration, version 3, the pool's leaves
     bitwise equal to the bf16-rounded policy after every flip (and the
     last, staged version), and every kernel's launch count against the
     formula the run implies (printed). Prints each iteration's wall,
     infer and train time, TPSPD, sync gap, and the peak device memory;
  7. train parity: reduced llama (2 layers, f32), one captured grad step
     and one Adam update on the same SPA-packed micro-batch with seeded
     non-constant advantages, on the card (kernels) against the CPU (plain
     versions): gradients and updated parameters within 2e-4 of each
     leaf's largest entry.

Phase 2 also holds the SPA backward kernel against autograd of the plain
version (full-width heads; a 1024-token prompt, an SPA-packed row, a
windowed prompt and the training row's shape; f32 and bf16; two launches
bitwise equal) and the transfer_cast kernel against x.to(torch.bfloat16),
bitwise, on every leaf of the training tree, a misaligned ragged length
and special values (ties, denormals, +-Inf, NaN).

Then one line {"kernels": [...]} with the four kernels at the training
run's shapes and launch counts, and last {"ok": true, "device": {...}}.
Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import gc
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
# The backward's bars: rtol of each element plus an atol relative to the
# tensor's largest entry (dk and dv sum over every query that sees a key,
# so summation-order noise scales with the tensor, not the element).
GRAD_TOL = {"bfloat16": (2.0 ** -7, 1e-5), "float32": (2e-5, 2e-5)}
FLUSH_BYTES = 64 << 20                     # > the H100's 50 MB L2
TRAIN_LAYERS = 12      # 36 bytes per f32 parameter at an update: 28 layers
# (3.21 B parameters, ~116 GB) do not fit one 80 GB card, 12 (1.60 B) do
TRAIN_PROMPT, TRAIN_GROUP, TRAIN_RESP = 128, 8, 64


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

def spa_inputs(torch, dev, gen, dtype, prompt, responses, resp_len):
    """Full-width heads (H 24, Hkv 8, D 128) over one row: a causal prompt
    followed by ``responses`` SPA segments of ``resp_len`` tokens, each
    restarting at position ``prompt``."""
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
    return (q, k, v, pos, pos, seg, seg), (S, H, Hkv, D)


def spa_case(torch, timer, dev, gen, dtype, *, prompt, responses=0,
             resp_len=0, window=None):
    import torch.nn.functional as F
    from repro_torch.kernels.spa_attention import (allow_mask,
                                                   chunked_attention,
                                                   spa_attention)
    args, (S, H, Hkv, D) = spa_inputs(torch, dev, gen, dtype, prompt,
                                      responses, resp_len)
    q, k, v, pos, _, seg, _ = args
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


def spa_bwd_case(torch, timer, dev, gen, dtype, *, prompt, responses=0,
                 resp_len=0, window=None):
    """The backward kernel against autograd of the plain version run in
    f32 on the same inputs, with the forward's f32 output and log-sum-exp
    from the forward kernel; two launches must agree bitwise."""
    import torch.nn.functional as F
    from repro_torch.kernels.spa_attention import (_forward_kernel,
                                                   allow_mask,
                                                   chunked_attention,
                                                   spa_attention_bwd,
                                                   spa_attention_bwd_plain)
    args, (S, H, Hkv, D) = spa_inputs(torch, dev, gen, dtype, prompt,
                                      responses, resp_len)
    q, k, v, pos, _, seg, _ = args
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    scale = D ** -0.5
    _, o32, lse = _forward_kernel(*args, scale, window, stats=True)
    got = spa_attention_bwd(*args, o32, lse, dout, window=window)
    again = spa_attention_bwd(*args, o32, lse, dout, window=window)
    torch.cuda.synchronize()
    deterministic = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    want = spa_attention_bwd_plain(*f32(args), dout.float(), window=window)
    rtol, atol_rel = GRAD_TOL[dtype]
    ok, errs = deterministic, []
    for g, w in zip(got, want):
        g = g.float()
        if not bool(torch.isfinite(g).all()):
            fail("backward kernel output is not finite")
        err = (g - w).abs()
        ok = ok and bool((err <= rtol * w.abs()
                          + atol_rel * w.abs().max()).all())
        errs.append(float(err.max()))

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out_plain = chunked_attention(*leaves, *args[3:], window=window)
    mask = allow_mask(pos, pos, seg, seg, window)[:, None]
    lib = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out_lib = F.scaled_dot_product_attention(*lib, attn_mask=mask,
                                                 enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    pairs = int(mask.sum())
    elt = q.element_size()
    bytes_moved = 2 * (q.numel() + k.numel() + v.numel()) * elt \
        + dout.numel() * elt + (o32.numel() + lse.numel()) * 4 + 4 * 4 * S
    # five products over visible pairs (S = QK, dP = dO V, dV, dK, dQ)
    b_ms, b_by = bound(bytes_moved, 10.0 * D * H * pairs, dtype)
    return {
        "kernel": "spa_attention_bwd", "dtype": dtype, "B": 1, "S": S,
        "H": H, "Hkv": Hkv, "D": D, "prompt": prompt,
        "responses": responses, "resp_len": resp_len, "window": window,
        "visible_pairs": pairs, "max_abs_err": max(errs),
        "max_abs_err_dq_dk_dv": errs, "deterministic": deterministic,
        "tol": {"rtol": rtol, "atol_rel_to_max": atol_rel}, "ok": ok,
        "ms": timer.ms(lambda: spa_attention_bwd(*args, o32, lse, dout,
                                                 window=window), 10),
        "fwd_stats_ms": timer.ms(lambda: _forward_kernel(
            *args, scale, window, stats=True), 10),
        "plain_ms": timer.ms(lambda: torch.autograd.grad(
            out_plain, leaves, dout, retain_graph=True), 3),
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            out_lib, lib, dout_t, retain_graph=True), 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


SPECIALS = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.0,
            1.00390625, 1.01171875,           # bf16 ties: to even, up
            1e-40, -1e-40, 1e-45,             # f32 denormals
            3.3895314e38, 3.4e38, -3.4e38]    # bf16 max, overflow


def cast_bitwise(torch, got, want) -> bool:
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(torch.int16), want[~nan].view(torch.int16)))


def cast_cases(torch, timer, dev, gen, cfg):
    """transfer_cast on every leaf of ``cfg``'s parameter tree (the
    training run's shapes), a misaligned ragged length and special values,
    bitwise against x.to(torch.bfloat16). Times one publish's worth of
    casts: the sum over the tree's leaves."""
    from repro_torch.kernels.transfer_cast import transfer_cast
    from repro_torch.models.transformer import param_shapes
    from repro_torch.transfer.plan import flatten_with_keys
    bf16 = torch.bfloat16
    specials = torch.tensor(SPECIALS, dtype=torch.float32, device=dev)
    keys, shapes = flatten_with_keys(param_shapes(cfg))
    leaves, ok = [], True
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    elements = 0
    for key, shape in zip(keys, shapes):
        x = torch.randn(tuple(shape), generator=gen, device=dev)
        x.view(-1)[:specials.numel()] = specials
        good = cast_bitwise(torch, transfer_cast(x, bf16), x.to(bf16))
        ok = ok and good
        row = {"leaf": key, "shape": list(shape), "bitwise": good,
               "ms": timer.ms(lambda: transfer_cast(x, bf16), 5),
               "plain_ms": timer.ms(lambda: x.to(bf16), 5),
               "library_ms": timer.ms(lambda: x.to(torch.bfloat16), 5)}
        for k in tot:
            tot[k] += row[k]
        elements += x.numel()
        leaves.append(row)
        del x
    ragged = torch.randn(1_000_004, generator=gen, device=dev)[1:]
    ragged[:specials.numel()] = specials
    edge_ok = cast_bitwise(torch, transfer_cast(ragged, bf16),
                           ragged.to(bf16)) and \
        cast_bitwise(torch, transfer_cast(specials, bf16), specials.to(bf16))
    ok = ok and edge_ok
    b_ms, b_by = bound(6.0 * elements, float(elements), "float32")
    return {"kernel": "transfer_cast", "dtype": "float32->bfloat16",
            "tree_layers": cfg.num_layers, "leaves": len(leaves),
            "elements": elements, "ragged_and_specials_bitwise": edge_ok,
            "ok": ok, "max_abs_err": 0.0 if ok else None,
            "per_leaf": leaves, **tot, "bound_ms": b_ms, "bound_by": b_by}


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
# phase 6: one periodic-async GRPO run at full width; phase 7: parity
# ---------------------------------------------------------------------

def train_config(layers: int = TRAIN_LAYERS):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-3b"), num_layers=layers,
                               param_dtype="float32", compute_dtype="float32")


def _tree_leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_tree_leaves(v) if isinstance(v, dict) else (v,))


def _pool_is_bf16_policy(torch, pool_params, policy) -> bool:
    return all(bool(torch.equal(p, q.to(torch.bfloat16).float()))
               for p, q in zip(_tree_leaves(pool_params),
                               _tree_leaves(policy)))


def train_full_width(torch, np, dev, seed: int, iterations: int = 3):
    from repro_torch.configs.base import RLConfig
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import build_pipeline
    cfg = train_config()
    rl = RLConfig(mode="async", rollout_engine="paged",
                  num_inference_instances=1, cbatch_slots=8,
                  batch_prompts=4, group_size=TRAIN_GROUP,
                  max_prompt_len=TRAIN_PROMPT, max_response_len=TRAIN_RESP,
                  shared_prompt_attention=True, capture_logprobs=True,
                  transfer_wire_dtype="bfloat16", transfer_overlap=True,
                  seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    # prompt_pad 96: prompts of about 120 tokens, under the 128 cap
    sched, parts = build_pipeline(cfg, rl, seed=seed, prompt_pad=96,
                                  device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    store = parts["pool"].instances[0].store
    flips = []
    ensure = sched.transfer.ensure

    def checked_ensure(params, version):
        v = ensure(params, version)
        flips.append([version, _pool_is_bf16_policy(
            torch, store.snapshot()[0], params)])
        return v
    sched.transfer.ensure = checked_ensure
    reset_launch_counts()
    hist = sched.run(iterations)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    tri = parts["tri"]
    staged_ok = store.staged_version == iterations and _pool_is_bf16_policy(
        torch, store.staged_params(), tri.policy)
    L = cfg.num_layers
    prefills = sum(h.metrics["prefills"] for h in hist)
    steps = sum(h.metrics["decode_steps"] for h in hist)
    cap, rec = sched.captured_micro_steps, sched.recomputed_micro_steps
    n_leaves = len(sched.transfer.plan.leaves)
    publishes = len(sched.transfer.publishes)
    expect = {
        # prefill: L; captured step: ref L + policy L + remat recompute L;
        # recompute step: old L + ref L + policy L + recompute L
        "spa_attention": L * (prefills + 3 * cap + 4 * rec),
        "spa_attention_bwd": L * (cap + rec),
        "paged_decode_attention": L * steps,
        "transfer_cast": n_leaves * publishes,
    }
    formula = {
        "spa_attention": f"L*(prefills + 3*captured + 4*recomputed) = "
                         f"{L}*({prefills} + 3*{cap} + 4*{rec})",
        "spa_attention_bwd": f"L*(captured + recomputed) = {L}*({cap} + {rec})",
        "paged_decode_attention": f"L*decode_steps = {L}*{steps}",
        "transfer_cast": f"leaves*publishes = {n_leaves}*{publishes}",
    }
    out = {
        "phase": "train", "arch": cfg.name, "layers": L,
        "d_model": cfg.d_model, "dtype": cfg.param_dtype,
        "params": sum(t.numel() for t in _tree_leaves(tri.policy)),
        "mode": rl.mode, "N": rl.batch_prompts, "G": rl.group_size,
        "max_prompt_len": rl.max_prompt_len,
        "max_response_len": rl.max_response_len, "slots": rl.cbatch_slots,
        "spa": True, "capture_logprobs": True, "wire_dtype": "bfloat16",
        "overlap": True, "setup_s": setup_s,
        "iterations": [{
            "iteration": h.iteration, "wall_s": h.wall_time,
            "infer_s": h.infer_time, "train_s": h.train_time,
            "trained_tokens": h.trained_tokens, "tpspd": h.tpspd,
            "sync_gap_s": h.metrics["sync_gap"],
            "staleness": h.max_staleness, "reward_mean": h.reward_mean,
            "prefills": h.metrics["prefills"],
            "decode_steps": h.metrics["decode_steps"],
            "generated_tokens": h.metrics["generated_tokens"]}
            for h in hist],
        "version": tri.version, "flips_bf16_bitwise": flips,
        "staged_bf16_bitwise": staged_ok,
        "captured_steps": cap, "recomputed_steps": rec,
        "launches": launches, "expected_launches": expect,
        "launch_formula": formula,
        "publishes": sched.transfer.publishes,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
    }
    if any(h.max_staleness != 0 or h.trained_tokens <= 0 for h in hist):
        fail(f"train: staleness or empty iteration: {out['iterations']}")
    if tri.version != iterations:
        fail(f"train: tri.version {tri.version} != {iterations}")
    if len(flips) != iterations or not all(ok for _, ok in flips) or \
            not staged_ok:
        fail(f"train: pool leaves are not the bf16-rounded policy: {flips}, "
             f"staged {staged_ok}")
    if launches != expect or 0 in expect.values():
        fail(f"train: launches {launches} != expected {expect} ({formula})")
    if not all(bool(torch.isfinite(t).all())
               for t in _tree_leaves(tri.policy)):
        fail("train: non-finite parameters after the updates")
    return out


def train_parity(torch, np, dev, seed: int):
    """One captured grad step and one Adam update of reduced llama on the
    card (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.queue import RolloutGroup
    from repro_torch.core.spa import pack_spa
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import init
    from repro_torch.optim.adam import adam_init
    from repro_torch.rl.grpo import (make_apply_update,
                                     make_grad_step_captured, to_device)
    cfg = reduced_config(get_config("llama3.2-3b"))
    rl = RLConfig()                      # the paper's lr 1e-6, Adam, clip 1
    G, Lp, T = 8, 40, 48
    rng = np.random.RandomState(seed + 7)
    lens = rng.randint(5, T + 1, size=G).astype(np.int32)
    resp = np.zeros((G, T), np.int32)
    for g in range(G):
        resp[g, :lens[g]] = rng.randint(3, cfg.vocab_size, size=lens[g])
    group = RolloutGroup(
        uid=0, prompt_ids=rng.randint(3, cfg.vocab_size, size=Lp)
        .astype(np.int32), response_ids=resp, response_len=lens,
        rewards=np.zeros(G, np.float32), weight_version=0,
        response_logprobs=(-3.0 * rng.rand(G, T)).astype(np.float32))
    adv = rng.randn(G).astype(np.float32)        # non-constant advantages
    mb = pack_spa(group, adv, Lp, T, responses_per_row=G)

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}
    policy = init(cfg, seed=seed, device="cpu")
    other = init(cfg, seed=seed + 1, device="cpu")
    ref = {k: v for k, v in policy.items()}
    ref["layers"] = {k: {kk: vv + 0.05 * other["layers"][k][kk]
                         for kk, vv in v.items()}
                     for k, v in policy["layers"].items()}
    results = []
    reset_launch_counts()
    for where in ("cpu", dev):
        p, r = to(policy, where), to(ref, where)
        grads, metrics = make_grad_step_captured(cfg, rl)(
            p, None, r, to_device(mb, where))
        new, _, _ = make_apply_update(cfg, rl)(p, adam_init(p), grads)
        results.append((to(grads, "cpu"), to(new, "cpu"),
                        float(metrics["loss"])))
    launches = dict(LAUNCHES)
    (g_cpu, p_cpu, l_cpu), (g_gpu, p_gpu, l_gpu) = results

    def worst(a, b):
        return max(float((x - y).abs().max()) /
                   max(float(y.abs().max()), 1e-30)
                   for x, y in zip(_tree_leaves(a), _tree_leaves(b)))
    grad_err, param_err = worst(g_gpu, g_cpu), worst(p_gpu, p_cpu)
    out = {"phase": "train_parity", "arch": cfg.name, "dtype": "float32",
           "G": G, "packed_row_len": int(mb.tokens.shape[1]),
           "loss_card": l_gpu, "loss_cpu": l_cpu,
           "grad_max_err_rel_to_leaf_max": grad_err,
           "param_max_err_rel_to_leaf_max": param_err, "tol": 2e-4,
           "launches_card": launches}
    if not (grad_err <= 2e-4 and param_err <= 2e-4) or \
            launches["spa_attention_bwd"] != cfg.num_layers:
        fail(f"train parity: card and CPU disagree: {out}")
    return out


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
    bwd_cases = []
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
        bwd_cases.append(spa_bwd_case(torch, timer, dev, gen, dtype,
                                      prompt=1024))
        bwd_cases.append(spa_bwd_case(torch, timer, dev, gen, dtype,
                                      prompt=256, responses=4, resp_len=128))
        bwd_cases.append(spa_bwd_case(torch, timer, dev, gen, dtype,
                                      prompt=1024, window=256))
    # the training run's shapes (f32): an SPA row of a ~120-token prompt
    # and G slots of 1 + 64 tokens; rollout decode at 8 slots
    train_spa = spa_case(torch, timer, dev, gen, "float32", prompt=120,
                         responses=TRAIN_GROUP, resp_len=1 + TRAIN_RESP)
    train_bwd = spa_bwd_case(torch, timer, dev, gen, "float32", prompt=120,
                             responses=TRAIN_GROUP, resp_len=1 + TRAIN_RESP)
    train_dec = decode_case(torch, timer, dev, gen, "float32", B=8,
                            ctx_max=TRAIN_PROMPT + TRAIN_RESP)
    cast = cast_cases(torch, timer, dev, gen, train_config())
    cases += [train_spa, train_dec]
    bwd_cases.append(train_bwd)
    for c in cases + bwd_cases + [cast]:
        emit({"phase": "kernel", **c})
    bad = [c for c in cases + bwd_cases + [cast] if not c["ok"]]
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
    gc.collect()
    torch.cuda.empty_cache()
    train = train_full_width(torch, np, dev, args.seed)
    emit(train)
    gc.collect()
    torch.cuda.empty_cache()
    emit(train_parity(torch, np, dev, args.seed))

    # the training run's launches, each kernel timed at that run's shapes
    meta = {
        "spa_attention": ("src/repro_torch/kernels/csrc/spa_attention.cu",
                          "src/repro/kernels/spa_attention.py:104",
                          train_spa),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:242", train_dec),
        "transfer_cast": ("src/repro_torch/kernels/csrc/transfer_cast.cu",
                          "src/repro/kernels/transfer_cast.py:55", cast),
        "spa_attention_bwd": (
            "src/repro_torch/kernels/csrc/spa_attention_bwd.cu",
            "src/repro/kernels/spa_attention.py:104", train_bwd),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train["launches"][name],
         "launches_serve": launches.get(name, 0),
         "max_abs_err": c["max_abs_err"], "ms": c["ms"],
         "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for name, (src, rep, c) in meta.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

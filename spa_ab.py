#!/usr/bin/env python3
"""A/B timing of the attention kernels of two checkouts on one GPU.

    python3 spa_ab.py OLD_TREE [NEW_TREE] [--rounds N] [--out FILE.jsonl]
                      [--kernels spa,paged,mla,cast]

OLD_TREE and NEW_TREE (default: this checkout) are roots of checkouts of
the repository, e.g. a parent commit unpacked with ``git archive`` into a
directory of this checkout that ``.gitignore`` lists. Each tree's
``repro_torch.kernels.spa_attention``, ``.decode_attention`` and
``.transfer_cast`` are imported from its own ``src`` (its wrappers build
its own ``kernels/csrc`` into its own ``_build``), so both versions run on
one card, in one process, on the same inputs. Four groups of cases,
chip_smoke.py's phase-2 shapes (the first two at full-width llama3.2-3b
heads):

  * spa: a 1024-token prompt, an SPA-packed row, a windowed prompt and
    the training row; bf16 and f32; forward and backward, against
    PyTorch's scaled_dot_product_attention (forward or backward);
  * paged: paged decode at B 4 (contexts to 1056) and B 16 (to 8192) in
    bf16 and f32 and at the training shape (f32, B 8); paged verify at
    the spec shape (B 4, S 5, bf16 and f32), the training spec shape
    (f32, B 8), the 512-token suffix prefill (bf16) and the windowed
    spec shape (bf16); the contiguous decode_attention and
    verify_attention (bf16); against a page gather plus
    scaled_dot_product_attention (SDPA alone for the contiguous ones);
  * mla: the paged MLA kernel at full-width mla_dense heads (H 16, r 512,
    rd 64), chip_smoke's MLA_CASES: decode at B 4 (contexts 64 to 1088)
    and B 16 (to 8192), the spec verify block (B 4, S 5), bf16 and f32,
    the windowed verify block (bf16), the training rollouts' decode (f32,
    B 8) and the radix suffix prefill (bf16, B 1, S 256); against a
    latent page gather plus SDPA;
  * cast: transfer_cast on every leaf of the training run's parameter
    tree (12-layer llama3.2-3b, f32 -> bf16), against x.to(torch.bfloat16);
    besides each leaf's lines, one line per version sums the medians over
    the tree (one publish's casts).

Every round times one call of each tree's wrapper and one of the library
call, alternating the order, with chip_smoke's Timer (L2 flushed, the
host's launch work left out). Prints one JSON line per (case, version)
with the median, quartiles and mean over the rounds and the rounds the
Timer could not keep free of host time, and the card's name and power
limit first; the new tree's lines say whether its output (the SPA
forward's, the paged wrapper's, the cast's) is bitwise that of the old
tree (the cast's also whether it is bitwise x.to's); a paged or MLA
tree's lines also carry the plan its wrapper recorded (``LAST_PLAN``, null
where the tree records none). For the paged and MLA cases it also prints
each tree's host time per wrapper call (``"kind": "host"``, HOST_ROUNDS
rounds): the wall time of HOST_CALLS calls queued behind a spin that
keeps the card busy throughout (checked: the spin is still running when
the last call is queued), so no call waits on the device. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [("prompt1024", dict(prompt=1024)),
          ("packed", dict(prompt=256, responses=4, resp_len=128)),
          ("window256", dict(prompt=1024, window=256)),
          ("train", dict(prompt=120, responses=8, resp_len=65))]


# chip_smoke's phase-2 decode / verify cases: (label, setup, keywords)
PAGED = [("decode_b4", "decode", dict(dtype="bfloat16", B=4, ctx_max=1056)),
         ("decode_b16_8k", "decode",
          dict(dtype="bfloat16", B=16, ctx_max=8192)),
         ("decode_b4", "decode", dict(dtype="float32", B=4, ctx_max=1056)),
         ("decode_b16_8k", "decode",
          dict(dtype="float32", B=16, ctx_max=8192)),
         ("decode_train", "decode", dict(dtype="float32", B=8, ctx_max=192)),
         ("verify_spec", "verify",
          dict(dtype="bfloat16", B=4, S=5, ctx_max=1060)),
         ("verify_spec", "verify",
          dict(dtype="float32", B=4, S=5, ctx_max=1060)),
         ("verify_train", "verify", dict(dtype="float32", B=8, S=5,
                                         ctx_max=196)),
         ("suffix_prefill", "verify", dict(dtype="bfloat16", B=1, S=512,
                                           ctx_max=1024, suffix=True)),
         ("verify_window256", "verify", dict(dtype="bfloat16", B=4, S=5,
                                             ctx_max=1060, window=256)),
         ("decode_contiguous", "contiguous",
          dict(dtype="bfloat16", verify=False)),
         ("verify_contiguous", "contiguous",
          dict(dtype="bfloat16", verify=True))]


def load_tree(tree: str):
    """``tree``'s repro_torch.kernels.spa_attention, .decode_attention and
    .transfer_cast.
    The package is dropped from sys.modules first, so each tree's
    functions keep their own modules (and their own built kernels) once
    loaded."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    try:
        return {m: importlib.import_module(f"repro_torch.kernels.{m}")
                for m in ("spa_attention", "decode_attention",
                          "transfer_cast")}
    finally:
        sys.path.pop(0)


def interleaved(timer, runs: dict, rounds: int):
    """Each run timed once per round, in turns (reversed every other
    round): the times and the rounds the Timer could not cover."""
    times = {key: [] for key in runs}
    uncovered = {key: 0 for key in runs}
    keys = list(runs)
    for r in range(rounds):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            times[key].append(timer.ms(runs[key], 1))
            uncovered[key] += not timer.covered
    return times, uncovered


HOST_CALLS, HOST_ROUNDS = 100, 20
HOST_SPIN_CYCLES = 40_000_000           # ~20 ms at the H100's clock


def host_times(torch, runs: dict, rounds: int):
    """Host microseconds per call of each run, in turns: HOST_CALLS calls
    queued behind a spin, timed on the host's clock. A round in which the
    card finished the spin before the host had queued every call is
    repeated with twice the spin."""
    times = {key: [] for key in runs}
    keys = list(runs)
    spin = HOST_SPIN_CYCLES
    for r in range(rounds):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            fn = runs[key]
            while True:
                fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(spin)
                busy = torch.cuda.Event()
                busy.record()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn()
                t1 = time.perf_counter()
                covered = not busy.query()
                torch.cuda.synchronize()
                if covered:
                    break
                spin *= 2
            times[key].append((t1 - t0) / HOST_CALLS * 1e6)
    return times


def summary(ts) -> dict:
    qs = statistics.quantiles(ts, n=4)
    return {"median_ms": statistics.median(ts), "q1_ms": qs[0],
            "q3_ms": qs[2], "mean_ms": statistics.fmean(ts),
            "rounds": len(ts)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default="spa,paged",
                    help="comma-separated groups: spa, paged, mla, cast")
    args = ap.parse_args()
    groups = set(args.kernels.split(","))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("spa_ab: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"old": args.old, "new": args.new}
    mods = {k: load_tree(t) for k, t in trees.items()}
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader --id=0").read().strip()
    emit({"nvidia_smi": smi, "trees": {k: os.path.abspath(t)
                                       for k, t in trees.items()}})
    for dtype in ("bfloat16", "float32") if "spa" in groups else ():
        for case, kw in SHAPES:
            kw = dict(kw)
            window = kw.pop("window", None)
            inputs, (_, _, _, D) = cs.spa_inputs(
                torch, dev, gen, dtype, kw["prompt"], kw.get("responses", 0),
                kw.get("resp_len", 0))
            q, k, v, pos, _, seg, _ = inputs
            dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            runs = {}
            for name, tree in mods.items():
                m = tree["spa_attention"]
                _, o32, lse = m._forward_kernel(*inputs, D ** -0.5, window,
                                                stats=True)
                runs[("fwd", name)] = lambda m=m: m.spa_attention(
                    *inputs, window=window)
                runs[("bwd", name)] = lambda m=m, o32=o32, lse=lse: \
                    m.spa_attention_bwd(*inputs, o32, lse, dout,
                                        window=window)
            mask = mods["new"]["spa_attention"].allow_mask(
                pos, pos, seg, seg, window)[:, None]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = [t.detach().transpose(1, 2).requires_grad_()
                   for t in (q, k, v)]
            with torch.enable_grad():
                out_lib = F.scaled_dot_product_attention(
                    *lib, attn_mask=mask, enable_gqa=True)
            dout_t = dout.transpose(1, 2)
            runs[("fwd", "sdpa")] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            runs[("bwd", "sdpa")] = lambda: torch.autograd.grad(
                out_lib, lib, dout_t, retain_graph=True)
            same = torch.equal(runs[("fwd", "old")](),
                               runs[("fwd", "new")]())
            times, uncovered = interleaved(timer, runs, args.rounds)
            for (kind, name), ts in times.items():
                emit({"dtype": dtype, "case": case, "kind": kind,
                      "version": name, **summary(ts),
                      "uncovered_rounds": uncovered[(kind, name)],
                      **({"forward_equal_to_old": same}
                         if (kind, name) == ("fwd", "new") else {})})
    cases = (PAGED if "paged" in groups else []) + \
        ([(name, "mla", kw) for name, kw in cs.MLA_CASES.items()]
         if "mla" in groups else [])
    for case, setup, kw in cases:
        kw = dict(kw)
        dtype = kw.pop("dtype")
        c = getattr(cs, f"{setup}_setup")(torch, dev, gen, dtype, **kw)
        a, k = c["args"], c["kw"]
        runs = {name: (lambda f=getattr(tree["decode_attention"],
                                        c["fn"].__name__): f(*a, **k))
                for name, tree in mods.items()}
        runs["library"] = c["library"]
        got = {name: runs[name]().float() for name in mods}
        plans = {name: getattr(tree["decode_attention"], "LAST_PLAN",
                               {}).get(c["name"])
                 for name, tree in mods.items()}
        want = c["plain"](*cs.f32(a), **k)
        times, uncovered = interleaved(timer, runs, args.rounds)
        for name, ts in times.items():
            emit({"dtype": dtype, "case": case, "kind": c["name"],
                  "version": name, **summary(ts),
                  "uncovered_rounds": uncovered[name],
                  **({"max_abs_err": float((got[name] - want).abs().max()),
                      "plan": plans[name]} if name in got else {}),
                  **({"equal_to_old": torch.equal(got["old"], got["new"])}
                     if name == "new" else {})})
        host = host_times(torch, {name: runs[name] for name in mods},
                          HOST_ROUNDS)
        for name, us in host.items():
            qs = statistics.quantiles(us, n=4)
            emit({"dtype": dtype, "case": case, "kind": "host",
                  "wrapper": c["fn"].__name__, "version": name,
                  "median_us": statistics.median(us), "q1_us": qs[0],
                  "q3_us": qs[2], "rounds": len(us), "calls": HOST_CALLS})
    if "cast" in groups:
        cast_tree(torch, cs, mods, timer, gen, dev, args.rounds, emit)


def cast_tree(torch, cs, mods, timer, gen, dev, rounds, emit):
    """transfer_cast of each tree and x.to on every leaf of the training
    tree, interleaved leaf by leaf; per leaf and summed over the tree."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.transfer.plan import flatten_with_keys
    bf16 = torch.bfloat16
    keys, shapes = flatten_with_keys(param_shapes(cs.train_config()))
    total = {name: 0.0 for name in (*mods, "library")}
    bitwise = {name: True for name in mods}
    for key, shape in zip(keys, shapes):
        x = torch.randn(tuple(shape), generator=gen, device=dev)
        runs = {name: (lambda f=tree["transfer_cast"].transfer_cast:
                       f(x, bf16)) for name, tree in mods.items()}
        runs["library"] = lambda: x.to(bf16)
        want = x.to(bf16)
        same = {name: cs.cast_bitwise(torch, runs[name](), want)
                for name in mods}
        times, uncovered = interleaved(timer, runs, rounds)
        for name, ts in times.items():
            rec = summary(ts)
            total[name] += rec["median_ms"]
            if name in same:
                bitwise[name] = bitwise[name] and same[name]
            emit({"dtype": "float32->bfloat16", "case": "train_tree",
                  "kind": "transfer_cast", "leaf": key, "shape": list(shape),
                  "version": name, **rec,
                  "uncovered_rounds": uncovered[name],
                  **({"bitwise_to": same[name]} if name in same else {})})
        del x, want
    for name, ms in total.items():
        emit({"dtype": "float32->bfloat16", "case": "train_tree",
              "kind": "transfer_cast", "leaf": "sum of medians",
              "version": name, "median_ms": ms,
              **({"bitwise_to": bitwise[name]} if name in bitwise else {})})


if __name__ == "__main__":
    main()

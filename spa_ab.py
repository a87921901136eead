#!/usr/bin/env python3
"""A/B timing of the SPA attention kernels of two checkouts on one GPU.

    python3 spa_ab.py OLD_TREE [NEW_TREE] [--rounds N] [--out FILE.jsonl]

OLD_TREE and NEW_TREE (default: this checkout) are roots of checkouts of
the repository, e.g. a parent commit unpacked with ``git archive`` into a
directory of this checkout that ``.gitignore`` lists. Each tree's
``repro_torch.kernels.spa_attention`` is imported from its own ``src``
(its wrappers build its own ``kernels/csrc`` into its own ``_build``), so
both versions run on one card, in one process, on the same inputs. For
each of chip_smoke.py's phase-2 SPA cases (full-width llama3.2-3b heads:
a 1024-token prompt, an SPA-packed row, a windowed prompt and the
training row; bf16 and f32; forward and backward) every round times one
call of each tree's wrapper and one of PyTorch's
scaled_dot_product_attention (the yardstick, forward or backward),
alternating the order, with chip_smoke's Timer (L2 flushed, the host's
launch work left out). Prints one JSON line per (case, version) with the
median, quartiles and mean over the rounds and the rounds the Timer could
not keep free of host time, and the card's name and power limit first.
Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [("prompt1024", dict(prompt=1024)),
          ("packed", dict(prompt=256, responses=4, resp_len=128)),
          ("window256", dict(prompt=1024, window=256)),
          ("train", dict(prompt=120, responses=8, resp_len=65))]


def load_tree(tree: str):
    """``tree``'s repro_torch.kernels.spa_attention. The package is
    dropped from sys.modules first, so each tree's functions keep their
    own modules (and their own built kernels) once loaded."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    try:
        return importlib.import_module("repro_torch.kernels.spa_attention")
    finally:
        sys.path.pop(0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

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
    for dtype in ("bfloat16", "float32"):
        for case, kw in SHAPES:
            kw = dict(kw)
            window = kw.pop("window", None)
            inputs, (_, _, _, D) = cs.spa_inputs(
                torch, dev, gen, dtype, kw["prompt"], kw.get("responses", 0),
                kw.get("resp_len", 0))
            q, k, v, pos, _, seg, _ = inputs
            dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            runs = {}
            for name, m in mods.items():
                _, o32, lse = m._forward_kernel(*inputs, D ** -0.5, window,
                                                stats=True)
                runs[("fwd", name)] = lambda m=m: m.spa_attention(
                    *inputs, window=window)
                runs[("bwd", name)] = lambda m=m, o32=o32, lse=lse: \
                    m.spa_attention_bwd(*inputs, o32, lse, dout,
                                        window=window)
            mask = mods["new"].allow_mask(pos, pos, seg, seg, window)[:, None]
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
            times = {key: [] for key in runs}
            uncovered = {key: 0 for key in runs}
            keys = list(runs)
            for r in range(args.rounds):
                for key in (keys if r % 2 == 0 else keys[::-1]):
                    times[key].append(timer.ms(runs[key], 1))
                    uncovered[key] += not timer.covered
            for (kind, name), ts in times.items():
                qs = statistics.quantiles(ts, n=4)
                emit({"dtype": dtype, "case": case, "kind": kind,
                      "version": name, "median_ms": statistics.median(ts),
                      "q1_ms": qs[0], "q3_ms": qs[2],
                      "mean_ms": statistics.fmean(ts), "rounds": len(ts),
                      "uncovered_rounds": uncovered[(kind, name)]})


if __name__ == "__main__":
    main()

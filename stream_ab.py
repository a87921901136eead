#!/usr/bin/env python3
"""A/B of chip_smoke.py's phase-6 training run between two checkouts on
one GPU, each run in a subprocess of its own.

    python3 stream_ab.py OLD_TREE [NEW_TREE] [--rounds N] [--drain D]
                         [--profile] [--out FILE.jsonl]

OLD_TREE and NEW_TREE (default: this checkout) are roots of checkouts of
the repository, e.g. a parent commit unpacked with ``git archive`` into a
directory of this checkout that ``.gitignore`` lists. Each run imports
its own tree's ``chip_smoke.train_full_width`` and ``repro_torch`` (so
each builds its own kernels into its own ``_build``) and runs the
training run there: full-width llama3.2-3b cut to 12 layers, f32, async,
8 slots, N 4 x G 8, SPA, captured logprobs, a bf16 wire, 3 iterations at
``decode_drain_interval`` D (every check of phase 6). Two such runs do
not fit one card at once (57 GiB each), hence one process per run.

Both trees' kernels are built first (two processes at once). Then every
round runs each tree once, alternating the order (reversed every other
round). With ``--profile`` each run's scheduler runs its last iteration
under this checkout's ``chip_smoke.run_profiled`` (the window phase 6
profiles, for both trees alike), and its line carries that window's
``device_busy``: the device's busy share, each stream's kernel time, and
the kernel time that ran beside another stream's. Prints the card's name
and power limit first, one JSON line per run (each iteration's wall,
infer, train, their overlap infer + train - wall, TPSPD, sync gap and the
run's peak memory), and one line per tree with the median, least and
most of each over the iterations after the first (which holds the
graph's capture) across rounds. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KEYS = ("wall_s", "infer_s", "train_s", "overlap_s", "tpspd", "sync_gap_s")


def run_one(tree: str, drain: int, seed: int, profiled: bool) -> None:
    """In a process of its own: ``tree``'s phase-6 run; prints one JSON
    line."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import numpy as np
    import torch
    import chip_smoke
    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != tree:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = {}
    if profiled:
        spec = importlib.util.spec_from_file_location(
            "ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        mine = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mine)
        from repro_torch.core.scheduler import PeriodicAsyncScheduler
        run = PeriodicAsyncScheduler.run

        def profiled_run(self, n):
            hist, found["busy"] = mine.run_profiled(
                torch, lambda k: run(self, k), n)
            return hist
        PeriodicAsyncScheduler.run = profiled_run
    out = chip_smoke.train_full_width(torch, np, torch.device("cuda", 0),
                                      seed, iterations=3, drain=drain)
    its = []
    for it in out["iterations"]:
        row = {k: it[k] for k in ("iteration", "wall_s", "infer_s",
                                  "train_s", "tpspd", "sync_gap_s")}
        row["overlap_s"] = it["infer_s"] + it["train_s"] - it["wall_s"]
        its.append(row)
    print(json.dumps({"iterations": its, "peak_mem_gib": out["peak_mem_gib"],
                      "setup_s": out["setup_s"], "graph": out["graph"],
                      "device_busy_last_iteration": found.get("busy")}))


def build(tree: str) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.join(os.path.abspath(tree), "src")])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--drain", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="profile each run's last iteration (device busy "
                         "share and time per stream)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        run_one(args.run, args.drain, args.seed, args.profile)
        return
    if args.old is None:
        ap.error("OLD_TREE is required")
    import torch
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available; this A/B needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({**rec, "card": smi})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    builds = [build(args.old), build(args.new)]
    if any(p.wait() != 0 for p in builds):
        sys.exit("kernel build failed")
    trees = {"old": args.old, "new": args.new}
    runs = {name: [] for name in trees}
    names = list(trees)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--run",
                   trees[name], "--drain", str(args.drain), "--seed",
                   str(args.seed)]
            if args.profile:
                cmd.append("--profile")
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                sys.exit(f"{name} run of round {r} failed "
                         f"(exit {proc.returncode})")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[name].append(rec)
            emit({"kind": "run", "version": name, "round": r,
                  "tree": os.path.abspath(trees[name]),
                  "drain_interval": args.drain, **rec})
    for name, recs in runs.items():
        its = [it for rec in recs for it in rec["iterations"][1:]]
        peaks = [rec["peak_mem_gib"] for rec in recs]
        emit({"kind": "summary", "version": name,
              "drain_interval": args.drain, "rounds": len(recs),
              **{k: {"median": statistics.median(it[k] for it in its),
                     "min": min(it[k] for it in its),
                     "max": max(it[k] for it in its)} for k in KEYS},
              "peak_mem_gib": {"median": statistics.median(peaks),
                               "min": min(peaks), "max": max(peaks)}})


if __name__ == "__main__":
    main()

"""End-to-end GRPO training entry point of the port: one periodic-async
pipeline (paper Figure 1), the counterpart of ``src/repro/launch/train.py``.

    PromptLoader -> TemporaryDataGenerator -> InferencePool (paged engines)
                          |  RolloutQueue  |
    PeriodicAsyncScheduler (consumer: tri-model GRPO + grad accumulation)
                          |  WeightTransferService (bucketed, versioned)

Usage (full-width llama3.2-3b cut to 12 layers, f32, on the GPU;
``--device cpu --reduced`` for the 2-layer variant on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --layers 12 \\
        --mode async --iterations 3 --batch-prompts 4 --group-size 8 \\
        --spa --wire-dtype bfloat16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from repro_torch import device as _device
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import RLConfig, require_engine_support
from repro_torch.core.engine import InferenceInstance, InferencePool
from repro_torch.core.generator import TemporaryDataGenerator
from repro_torch.core.paged import PagedGroupEngine
from repro_torch.core.queue import RolloutQueue
from repro_torch.core.scheduler import PeriodicAsyncScheduler
from repro_torch.core.trimodel import TriModelState
from repro_torch.data.loader import PromptLoader
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.models import init
from repro_torch.rl.reward import RuleBasedReward
from repro_torch.transfer.service import WeightTransferService


def build_pipeline(cfg, rl: RLConfig, *, seed: int = 0, prompt_pad: int = 0,
                   scripted_fn=None, params=None, device="cuda"):
    """Returns (scheduler, components dict). With ``scripted_fn`` the
    inference instances return scripted rollouts; otherwise each runs the
    paged engine. ``params`` (a tree in the model's layout, e.g. converted
    from the JAX package) replaces the random weights made from ``seed``.
    Runs on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    tok = Tokenizer(cfg.vocab_size)
    task = ArithmeticTask(seed=seed, prompt_pad=prompt_pad)
    loader = PromptLoader(task, tok, rl.batch_prompts, rl.max_prompt_len)
    if params is None:
        params = init(cfg, seed=seed, device=dev)
    tri = TriModelState.create(params)

    def paged_engine() -> Optional[PagedGroupEngine]:
        if scripted_fn is not None:
            return None
        if rl.rollout_engine == "group":
            require_engine_support(cfg, "group")     # raises: not ported
        elif rl.rollout_engine != "paged":
            raise KeyError(f"unknown rollout engine {rl.rollout_engine!r}")
        if rl.mode == "async_offpolicy":
            raise ValueError(
                "rollout_engine='paged' needs a quiescent engine at weight "
                "sync; the off-policy baseline syncs mid-flight — run it "
                "with scripted instances")
        return PagedGroupEngine(
            cfg, num_slots=rl.cbatch_slots, page_size=rl.kv_page_size,
            num_pages=rl.kv_pages, max_prompt_len=rl.max_prompt_len,
            max_new_tokens=rl.max_response_len, group_size=rl.group_size,
            temperature=rl.temperature, top_p=rl.top_p,
            capture_logprobs=rl.capture_logprobs, device=dev)

    instances = [InferenceInstance(i, cfg, scripted_fn=scripted_fn,
                                   paged_engine=paged_engine())
                 for i in range(rl.num_inference_instances)]
    pool = InferencePool(instances)
    queue = RolloutQueue()
    gen = TemporaryDataGenerator(pool, queue, RuleBasedReward(tok),
                                 rl.group_size)
    transfer = WeightTransferService(
        pool, bucket_bytes=rl.transfer_bucket_bytes,
        wire_dtype=rl.transfer_wire_dtype or None,
        overlap=rl.transfer_overlap)
    sched = PeriodicAsyncScheduler(cfg, rl, tri, gen, queue, loader,
                                   device=dev, transfer=transfer)
    return sched, {"tokenizer": tok, "task": task, "loader": loader,
                   "pool": pool, "queue": queue, "generator": gen,
                   "tri": tri, "transfer": transfer, "device": dev}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer d_model 256 variant (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (widths stay)")
    ap.add_argument("--mode", default="async", choices=["sync", "async"])
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--batch-prompts", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--max-prompt-len", type=int, default=128)
    ap.add_argument("--max-response-len", type=int, default=64)
    ap.add_argument("--spa", action="store_true",
                    help="shared-prompt attention packing (one row per group)")
    ap.add_argument("--wire-dtype", default="", choices=["", "bfloat16"],
                    help="weight-plane payload dtype ('' = storage dtype)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    # the trainer holds f32 master weights; the wire may carry bf16
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32",
                              num_layers=args.layers or cfg.num_layers)
    rl = RLConfig(
        mode=args.mode, batch_prompts=args.batch_prompts,
        group_size=args.group_size, num_inference_instances=1,
        max_prompt_len=args.max_prompt_len,
        max_response_len=args.max_response_len,
        shared_prompt_attention=args.spa,
        transfer_wire_dtype=args.wire_dtype, seed=args.seed)
    sched, _ = build_pipeline(cfg, rl, seed=args.seed, device=args.device)
    t0 = time.time()
    history = sched.run(args.iterations)
    wall = time.time() - t0
    total = sum(s.trained_tokens for s in history)
    print(f"{cfg.name} ({cfg.num_layers} layers, float32) on "
          f"{args.device} mode={args.mode} spa={args.spa}: "
          f"{args.iterations} iterations, {total} tokens, {wall:.1f}s wall, "
          f"TPSPD={total / wall:.1f}")
    for s in history:
        print(f"  iter {s.iteration}: wall={s.wall_time:.2f}s "
              f"infer={s.infer_time:.2f}s train={s.train_time:.2f}s "
              f"tokens={s.trained_tokens} reward={s.reward_mean:.3f} "
              f"staleness={s.max_staleness} "
              f"gap={s.metrics['sync_gap'] * 1e3:.0f}ms")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(s) for s in history], f, indent=1)


if __name__ == "__main__":
    main()

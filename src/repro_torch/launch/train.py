"""End-to-end GRPO training entry point of the port: one periodic-async
pipeline (paper Figure 1), the counterpart of ``src/repro/launch/train.py``.

    PromptLoader -> TemporaryDataGenerator -> InferencePool (rollout engines)
                          |  RolloutQueue  |
    PeriodicAsyncScheduler (consumer: tri-model GRPO + grad accumulation)
                          |  WeightTransferService (bucketed, versioned)

Usage (full-width llama3.2-3b cut to 12 layers, f32, on the GPU;
``--device cpu --reduced`` for the 2-layer variant on the CPU;
``--arch deepseek-v2-lite-16b --layers 3`` trains the MoE model, its
dense prelude and 2 MoE layers, on one card; ``--rollout-engine group``
draws the rollouts from the group-at-a-time Sampler, the only engine of
``--mode async_offpolicy``, the off-policy baseline, and with ``--spec``
from the SpecSampler; ``--spec-draft model`` drafts with a resident
half-depth model instead of prompt lookup):
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
from repro_torch.rl.rollout import Sampler
from repro_torch.spec.sampler import SpecSampler
from repro_torch.transfer.service import WeightTransferService


def build_pipeline(cfg, rl: RLConfig, *, seed: int = 0, prompt_pad: int = 0,
                   scripted_fn=None, params=None, device="cuda"):
    """Returns (scheduler, components dict). With ``scripted_fn`` the
    inference instances return scripted rollouts; otherwise each runs the
    rollout engine ``rl.rollout_engine``: the paged engine (one an
    instance) or, as in the JAX package for every other engine name
    ("group", "cbatch"), the group-at-a-time Sampler (one, shared by the
    instances: it keeps no state between calls). With ``rl.spec_decode``
    "group" builds a SpecSampler for each instance instead (it keeps its
    draft providers and stats between calls, and two instances' calls
    may run at once); "cbatch" refuses spec decode, which the JAX package
    would drop. ``components["sampler"]`` is the first instance's.
    ``params`` (a tree in the model's layout, e.g. converted from the
    JAX package) replaces the random weights made from ``seed``. Runs on
    ``device`` (CUDA unless the caller asks for the CPU); refuses a
    config the port cannot train (``engine_support``'s train plane) or
    roll out on the chosen engine, and the off-policy baseline on the
    paged engine, which needs quiescence at a flip."""
    # repro: allow(support-matrix): the train plane is declared in the port's matrix (src/repro_torch/configs/base.py TRAIN_PLANE); the checker reads the JAX package's
    require_engine_support(cfg, "train")
    dev = _device.resolve(device)
    tok = Tokenizer(cfg.vocab_size)
    task = ArithmeticTask(seed=seed, prompt_pad=prompt_pad)
    loader = PromptLoader(task, tok, rl.batch_prompts, rl.max_prompt_len)
    if params is None:
        params = init(cfg, seed=seed, device=dev)
    tri = TriModelState.create(params)

    group = scripted_fn is None and rl.rollout_engine in ("group", "cbatch")
    shared = None
    if group:
        if rl.prefix_cache:
            require_engine_support(cfg, "prefix",
                                   rollout_engine=rl.rollout_engine)
        if rl.decode_drain_interval != 1:
            raise ValueError("decode_drain_interval is the paged engine's "
                             "decode block; the group Sampler decodes one "
                             "step a forward")
        if rl.spec_decode and rl.rollout_engine == "cbatch":
            raise ValueError("rollout_engine='cbatch' trains on the group "
                             "Sampler, which has no spec decode; use "
                             "rollout_engine='group' (the SpecSampler)")
        if rl.spec_decode:
            # k+1 tokens a target forward; greedy token-identical, sampled
            # distribution-exact, logprobs captured from the verify pass
            require_engine_support(cfg, "spec", rollout_engine="group")
        else:
            shared = Sampler(cfg, rl.max_prompt_len, rl.max_response_len,
                             temperature=rl.temperature, top_p=rl.top_p,
                             capture_logprobs=rl.capture_logprobs,
                             device=dev)
    elif scripted_fn is None and rl.rollout_engine != "paged":
        raise KeyError(f"unknown rollout engine {rl.rollout_engine!r}")

    def group_sampler():
        if not group or shared is not None:
            return shared
        return SpecSampler(
            cfg, rl.max_prompt_len, rl.max_response_len, spec_k=rl.spec_k,
            draft=rl.spec_draft, ngram=rl.spec_ngram,
            temperature=rl.temperature, top_p=rl.top_p,
            capture_logprobs=rl.capture_logprobs, seed=seed, device=dev)

    def paged_engine() -> Optional[PagedGroupEngine]:
        if scripted_fn is not None or group:
            return None
        if rl.mode == "async_offpolicy":
            raise ValueError(
                "rollout_engine='paged' needs a quiescent engine at weight "
                "sync; the off-policy baseline syncs mid-flight — use the "
                "group engine")
        return PagedGroupEngine(
            cfg, num_slots=rl.cbatch_slots, page_size=rl.kv_page_size,
            num_pages=rl.kv_pages, max_prompt_len=rl.max_prompt_len,
            max_new_tokens=rl.max_response_len, group_size=rl.group_size,
            temperature=rl.temperature, top_p=rl.top_p,
            capture_logprobs=rl.capture_logprobs,
            spec_k=rl.spec_k if rl.spec_decode else 0,
            spec_draft=rl.spec_draft, spec_ngram=rl.spec_ngram,
            prefix_cache=rl.prefix_cache,
            drain_interval=rl.decode_drain_interval, seed=seed, device=dev)

    instances = [InferenceInstance(i, cfg, group_sampler(),
                                   scripted_fn=scripted_fn,
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
                   "tri": tri, "transfer": transfer, "device": dev,
                   "sampler": instances[0].sampler if instances else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer d_model 256 variant (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (widths stay)")
    ap.add_argument("--mode", default="async",
                    choices=["sync", "async", "async_offpolicy"],
                    help="async_offpolicy: the off-policy baseline, the "
                         "producer up to --staleness-eta iterations ahead "
                         "(needs --rollout-engine group)")
    ap.add_argument("--staleness-eta", type=int, default=1)
    ap.add_argument("--rollout-engine", default="paged",
                    choices=["paged", "group"],
                    help="rollout engine: token-level paged continuous "
                         "batching (the port's default) or the "
                         "group-at-a-time Sampler over a dense cache (the "
                         "JAX package's default)")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--batch-prompts", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--max-prompt-len", type=int, default=128)
    ap.add_argument("--max-response-len", type=int, default=64)
    ap.add_argument("--spa", action="store_true",
                    help="shared-prompt attention packing (one row per group)")
    ap.add_argument("--wire-dtype", default="", choices=["", "bfloat16"],
                    help="weight-plane payload dtype ('' = storage dtype)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decode for rollouts (draft k tokens, "
                         "verify them in one k+1-token forward)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify step")
    ap.add_argument("--spec-draft", default="prompt_lookup",
                    choices=["prompt_lookup", "model"],
                    help="draft provider: n-gram prompt lookup (no extra "
                         "model) or a small resident draft model")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache on the paged rollout engine: "
                         "prompts sharing a token prefix share its pages "
                         "and prefill only their suffix")
    ap.add_argument("--drain-interval", type=int, default=1,
                    help="fused decode-block length D: the paged engine "
                         "runs D decode steps a block and drains their "
                         "tokens once per block (1 = every step)")
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
        mode=args.mode, staleness_eta=args.staleness_eta,
        rollout_engine=args.rollout_engine,
        batch_prompts=args.batch_prompts,
        group_size=args.group_size, num_inference_instances=1,
        max_prompt_len=args.max_prompt_len,
        max_response_len=args.max_response_len,
        shared_prompt_attention=args.spa,
        transfer_wire_dtype=args.wire_dtype, spec_decode=args.spec,
        spec_k=args.spec_k, spec_draft=args.spec_draft,
        prefix_cache=args.prefix_cache,
        decode_drain_interval=args.drain_interval, seed=args.seed)
    sched, _ = build_pipeline(cfg, rl, seed=args.seed, device=args.device)
    t0 = time.time()
    history = sched.run(args.iterations)
    wall = time.time() - t0
    total = sum(s.trained_tokens for s in history)
    print(f"{cfg.name} ({cfg.num_layers} layers, float32) on "
          f"{args.device} mode={args.mode} "
          f"engine={args.rollout_engine} spa={args.spa} "
          f"spec={args.spec}"
          + (f" ({args.spec_draft} draft)" if args.spec else "")
          + f" prefix_cache={args.prefix_cache} "
          f"drain_interval={args.drain_interval}: "
          f"{args.iterations} iterations, {total} tokens, {wall:.1f}s wall, "
          f"TPSPD={total / wall:.1f}")
    for s in history:
        print(f"  iter {s.iteration}: wall={s.wall_time:.2f}s "
              f"infer={s.infer_time:.2f}s train={s.train_time:.2f}s "
              f"tokens={s.trained_tokens} reward={s.reward_mean:.3f} "
              f"staleness={s.max_staleness} "
              f"gap={s.metrics['sync_gap'] * 1e3:.0f}ms"
              + (f" accept={s.metrics['spec_acceptance']:.2f}"
                 if args.spec else "")
              + (f" prefix_hit={s.metrics['prefix_hit_rate']:.2f}"
                 if args.prefix_cache else ""))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(s) for s in history], f, indent=1)


if __name__ == "__main__":
    main()

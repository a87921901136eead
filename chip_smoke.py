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
     visible). Each timed call starts with the 50 MB L2 cache flushed and
     a spin long enough that the host has queued the call before the card
     reaches it (checked per call; a "timer" line counts the calls where
     it could not be, see Timer).
     Paged verify (S query tokens per row, each at its own position) at
     the spec shape (B 4, S 5, contexts up to 1060; bf16 and f32), the
     rollout engine's (B 8, S 5, contexts up to 196, f32), a suffix
     prefill (B 1, 512 tokens after 512 cached, bf16) and a windowed
     case; the contiguous-cache decode_attention and verify_attention
     wrappers (the same two kernels on a one-page-per-row view), the
     former also at phase 20's shape (B 8 rows of phase 3's prompts
     left-padded to 1024, L 1056, the Sampler's layout: padding INVALID)
     and over a rotated sliding-window ring (window = L = 8192, slots out
     of position order, one row not wrapped, 5 % INVALID padding), and
     the contiguous MLA wrapper (mla_decode_attention: the MLA kernel on B
     pages of length L) at phase 20's mla_dense shape; the contiguous
     verify_attention at phase 21 (a)'s spec shape (B 4 slots, S 5, L
     1024 + 32 + 5, the slot engine's layout: slot == position) and on a
     rotated ring of window + 5 slots (window 8192), and the contiguous
     MLA verify route (mla_verify_attention) at phase 21 (a)'s mla_dense
     spec shape, bf16 and f32. Each
     decode / verify case also prints how the wrapper launched it (regime:
     Split-L or query tiles; context splits; blocks of the main kernel)
     and the share of its bound reached (bound_ms / ms);
  3. serve: full-width llama3.2-3b (28 layers, random bf16 weights made
     on the card from --seed) serves 8 requests (prompts of 64 to 1024
     tokens, 32 new tokens each, 4 slots, page 16, temperature 0.7)
     through RequestDriver and the paged engine. The kernel launch counts
     are reset just before and read just after, and must equal 28 x
     prefills (SPA) and 28 x decode steps (paged decode);
  4. profile: 8 unprofiled decode steps of the same engine at 4 busy
     slots (host wall time per step; the replays' device time from CUDA
     events), then 8 more under torch.profiler (device-busy time per
     step: the sum of kernel self times; the kernels that take the most
     device time), and the device's idle share estimated from the two
     windows;
  5. parity: reduced llama (2 layers, f32) on the card against the same
     engine on the CPU, greedy: identical tokens at D 1 and at D 3 (and
     the card's D 3 tokens equal its D 1 tokens), prefill logits within
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
     infer and train time, their overlap (infer + train - wall: the
     rollout engine decodes on the paged engines' CUDA stream while the
     trainer works on the default stream), TPSPD, sync gap and peak
     device memory (from its boundary to the next), and for the last
     iteration, under torch.profiler (``run_profiled``: CUDA activity
     only, from its boundary to the end of the run), the device's busy
     share (the union of the kernels' intervals over all streams against
     the window's wall) and each stream's kernel time;
  7. train parity: reduced llama (2 layers, f32), one captured grad step
     and one Adam update on the same SPA-packed micro-batch with seeded
     non-constant advantages, on the card (kernels) against the CPU (plain
     versions): gradients and updated parameters within 2e-4 of each
     leaf's largest entry; then the same for reduced mla_dense (its
     expanded attention trains in plain PyTorch, so no kernel of the port
     launches: the check holds the card's PyTorch against the CPU's);
  8. spec_serve: the model of phase 3 serves the same 8 requests through
     RequestDriver with speculative decode (prompt lookup, k 4,
     temperature 0.7). Prints tok/s, TTFT/TPOT p50/p99, acceptance rate,
     tokens per verify forward, rolled-back pages and peak memory, then
     profiles spec steps as phase 4 profiles decode steps. Checks
     that every page returns to the freelist and that launches equal 28 x
     prefills (SPA), 28 x verify forwards (paged verify) and 0 (paged
     decode);
  9. radix_serve: the same model through serve_shared: a 512-token system
     prompt (32 pages) and 8 suffixes of 16 to 256 tokens, spec off, then
     on. Checks 7 x 32 prefix hit pages, SPA launches = 28 x cold
     prefills, verify launches = 28 x (warm prefills + verify forwards),
     paged decode launches 28 x decode steps (0 with spec), every other
     kernel 0, and that after the drain only the tree's pages stay live,
     one reference each. Then the same 8 prompts arrive one every 0.25 s
     (each prefilled alone, spec off) through RequestDriver, on an engine
     with the radix cache and on one without: the TTFT p50/p99 of
     requests 1-7, warm (suffix prefill) against cold;
 10. spec_parity: reduced llama (2 layers, f32), card against CPU: greedy
     spec tokens identical to the CPU's and to the card's own non-spec
     greedy tokens; warm radix tokens identical to cold; a warm suffix
     prefill's last-token logits within 1e-3 of the cold prefill's on
     the CPU (``radix_parity``);
 11. mla_serve: full-width deepseek-v2-lite attention with MoE off
     (``mla_dense``: 27 layers, d 2048, H 16, MLA r 512 / rd 64 / nd 128
     / vd 128, SwiGLU d_ff 1408 in every layer, random bf16 weights made
     on the card from --seed) serves 8 requests (prompts of 64 to 1024
     tokens, 32 new tokens, 4 slots, page 16, temperature 0.7) through
     RequestDriver and the paged engine. Checks launches: the MLA decode
     kernel 27 x decode steps; the MLA verify, SPA and GQA paged kernels
     0 (the expanded MLA prefill is plain PyTorch, as in the JAX
     package); every page back on the freelist. Prints tok/s, TTFT and
     TPOT p50/p99, peak memory and the latent pool's bytes per token
     beside llama3.2-3b's K/V bytes per token; then profiles its decode
     steps as phase 4 does (mla_profile), with the MLA kernel's own device
     time per step (its main kernel and the combine that merges its
     splits; no other kernel of the phase launches the combine);
 12. mla_spec_serve: the same model and requests with spec decode
     (prompt lookup, k 4). Checks MLA verify launches = 27 x verify
     forwards, MLA decode launches 0, every page back. Prints the
     acceptance rate and tokens per verify forward;
 13. mla_parity: reduced mla_dense (2 layers, f32), card against CPU,
     greedy: identical tokens with spec off and on and at D 3, spec and D 3
     tokens identical to non-spec D 1 tokens, prefill logits within 1e-3;
     phase 10's radix checks on latent pages: warm tokens identical to
     cold with spec off, spec on and at D 3, and the warm suffix prefill's
     last-token logits (the MLA verify kernel over cached latent pages)
     within 1e-3 of the CPU's cold prefill.

Phases 8 and 9 run right after phase 4, on the same weights; phase 15
right after phase 12, on phase 11's.

From phase 3 on, every decode step (and every spec verify step) on the card
is one replay of a CUDA graph the engine captured at its first
``set_params`` (``src/repro_torch/core/graphs.py``): D 1 unless a phase
says otherwise. A replay adds the captured kernels' launches to the
counts, so the launch formulas count replays; the graph's warm-up call
launches its kernels once for real, which the training run's formula
counts (phases 3, 8, 9, 11 and 12 capture before their counts are reset).
The profile phases also time each replay with CUDA events
(``replay_device_ms_per_step``), beside torch.profiler's kernel sum.

 14. device_loop: the device-resident decode loop, D 1 against D 8 in
     interleaved rounds (D 1, D 8, D 1, D 8): (a) full-width
     llama3.2-3b on phase 3's workload and (b) full-width mla_dense on
     phase 11's (engines that hold 64 new tokens a row, so the profile
     windows of 16 decode steps keep 4 slots busy at D 8): TPOT and TTFT
     p50/p99, tok/s, host wall ms per decode step, device-busy ms per
     step and the idle share (the profiler's and the replay events'), the
     graph's warm-up and capture ms and a later set_params' weight copy;
     checks that every request's tokens are identical at D 1 and D 8 and
     across rounds, that launches equal L x decode steps made of replays,
     and that every page returns; (c) phase 6's training run (3
     iterations, unprofiled, every check of phase 6) at
     decode_drain_interval 1 and 8 in interleaved rounds (D 1, D 8, two
     each): each iteration's wall, infer, train, overlap, TPSPD, sync gap
     and peak memory, and per D the median, least and most of each over
     the iterations after the first (which holds the graph's capture).
 15. mla_radix_serve: phase 9 on phase 11's model (full-width bf16
     mla_dense, 27 layers): 7 x 32 hit pages from 1 cold and 7 warm
     prefills; launches MLA verify = 27 x (warm prefills + verify
     forwards), MLA decode = 27 x decode steps (0 with spec), SPA and the
     GQA paged kernels 0 (the cold prefill is MLA's expanded attention in
     plain PyTorch); only the tree's pages live after the drain, one
     reference each; tok/s, warm against cold TTFT, peak memory and the
     latent pool's bytes per token;
 16. mla_train: phase 6's run (its settings, checks and prints, the last
     iteration profiled) on mla_dense at full depth (27 layers, 1.025 B
     parameters) in f32: the rollouts launch the f32 MLA decode kernel
     (27 x (decode steps + the graph's warm-up step)); MLA's prefill and
     training attention is its expanded form in plain PyTorch, autograd
     for the gradient (as the JAX package computes it), so the SPA kernels
     launch 0 times, as do the GQA paged kernels; transfer_cast = leaves
     x publishes.

 17. moe_serve (after every earlier model, engine and pool is
     freed; the memory still allocated is printed first): deepseek-v2-lite
     as published (27 layers: 1 dense prelude layer, d_ff 10944, and 26
     MoE layers of 64 experts top-6 with 2 shared, moe_d_ff 1408; MLA;
     vocab 102400; 15.7 B parameters, random bf16 weights made on the card
     from --seed, the router in f32), handed from engine to engine as the
     serve entry points hand theirs over (HeldTree: each keeps the tree
     set_params returns and drops its own, so the card holds the weights
     once, twice during a clone; phases 9, 11, 12 and 15 hand theirs on
     the same way). (d) moe_profile: phase 4's two windows of 8 decode
     steps at 4 busy slots, with the MoE layers' own device time at the
     decode shape (one CUDA graph of the 26 layers' moe_ffn) as a share of
     the replayed step, and the step's weight-read bound: the bytes its
     routing needs (every non-expert leaf once, the f32 LM head, B
     embedding rows, and the distinct experts the window's tokens chose,
     counted by replaying the window's requests on a second engine with
     the counter below), beside the static (E, C) dispatch's bytes, which
     read every expert of every MoE layer; then, with a test-side counter
     of the (token, choice) pairs each expert's capacity drops and of the
     distinct experts each call routes to (per forward kind: prefill,
     decode, verify; its adds run inside the captured steps), (a)
     moe_serve: phase 11's
     workload at D 1 and at D 8 (MLA decode launches 27 x decode steps,
     all of them replays; every other kernel 0; every page back; finite
     logits), (b) moe_spec_serve: spec decode (MLA verify = 27 x verify
     forwards, MLA decode 0), (c) moe_radix_serve: phase 15's
     shared-system workload (7 x 32 hit pages, MLA verify = 27 x (warm
     prefills + verify forwards)), each with tok/s, TTFT / TPOT p50/p99,
     peak memory and the drop counts; then moe_parity: reduced
     deepseek-v2-lite and reduced qwen3-moe (2 layers, 4 experts top-2,
     f32) on the card against the CPU, greedy: prefill logits within 1e-3,
     the prefill's chosen experts identical (a flip passes only where the
     K-th and (K+1)-th probabilities are within 1e-5; the line counts
     them), tokens identical with spec off, spec on and at D 3 (a run's
     tokens are excused only where the first difference between the
     card's and the CPU's records of its forwards, input tokens and chosen
     experts in call order, is a routing flip at such a tie), and
     the SPA, paged decode and paged verify kernels (qwen3-moe) or the MLA
     pair (deepseek) launched by their formulas. Each run also reports
     the rows whose chosen experts or keep flags differ between card and
     CPU, idle (position >= 2^30) or live, and the spec and D 3 runs are
     repeated with the rotary frequencies computed on the card (the
     port's earlier way) to show which rows that moves.
 18. moe_train (last, after phase 17's tree is freed; the memory still
     allocated is printed first): phase 6's run (its settings, checks and
     prints, the last iteration profiled) on deepseek-v2-lite as
     published in f32, every width kept, cut to 3 layers (the dense
     prelude and 2 MoE layers, 1.670 B parameters): a finite loss and a
     finite, positive aux in every grad step; the MLA decode kernel 3 x
     (decode steps + the graph's warm-up step), transfer_cast leaves x
     publishes, every other kernel 0; the (token, choice) pairs dropped
     by each forward kind (prefill, decode, and the grad steps'
     reference, policy and recompute forwards apart); kernels per decode
     step and per grad step of the profiled iteration. Then
     moe_train_parity: reduced deepseek-v2-lite and reduced qwen3-moe (2
     layers, 4 experts top-2, f32) with a router skewed so that the
     packed micro-batch drops pairs, one captured grad step on the card
     against the CPU on phase 7's micro-batch: loss and aux within 1e-5
     relative, every gradient leaf within 2e-4 of its largest entry, each
     MoE call's keep mask equal (excused only behind a flip at a K-th /
     (K+1)-th gap within 1e-5, counted), and qwen3-moe's SPA kernels
     launched by their formula.
 19. window_serve (last, after phase 18's trees are freed): the sliding
     window on the paged plane. long_context_variant llama3.2-3b (window
     8192; 28 layers, bf16, random weights from --seed, 4 slots, page
     16, temperature 0.7, every request at t = 0), on an engine whose
     pool is the windowed admission budget (FIRST_PAGE + each prompt's
     window-visible pages + ``_row_budget``): (i) 4 prompts of 8,064 to
     8,190 tokens, 256 new tokens, at D 1, D 8 and with spec k 4 (the
     window slides mid-decode); (ii) 4 prompts of 32,768 tokens (the
     decode_32k shape), 64 new tokens; each prints tok/s, TTFT and TPOT
     p50/p99, peak memory, the pool's GiB against the full contexts',
     reclaimed pages and the replayed step's device ms (CUDA events),
     and checks reclaimed > 0, peak pages within the budget, every page
     back, the launch formulas (SPA 28 x prefills, the decode kernel 28 x
     decode steps, all replays, or the verify kernel 28 x verify steps),
     and sampled tokens equal at D 1 and D 8; (iii) window_radix_serve: a
     9,000-token system prompt and 8 suffixes of 16 to 256 tokens through
     serve_shared, greedy: 1 cold and 7 warm prefills, hit pages from
     each request's first live page, the tree's placeholders, launches,
     then the same prompts cold: warm tokens equal cold ones (a
     difference excused only at a tie within the card's own warm / cold
     logit difference, at most WINDOW_LOGIT_TOL) and prompt logits within
     it. Then window_kernel: the windowed decode kernel on a copy of the
     engine's own pool and table at about 8.2k and 32.8k context
     (decode step 128 of (i), 32 of (ii)), against its plain version,
     with the plain version's time, a page gather + SDPA with the window
     mask, and the bound of the window's K/V. Then long_context_variant
     mla_dense (27 layers, no cut) on workload (i) at D 1 (the MLA decode
     kernel 27 x decode steps), and window_parity: reduced windowed llama
     and mla_dense (window 32, f32) on the card against the CPU, greedy:
     tokens, reclaimed and peak pages equal at D 1 and D 3, spec off and
     on, and radix warm tokens equal cold ones (card and CPU) where the
     suffix's first query sees pages below its first live page.

 20. group_sampler (last): the group-at-a-time Sampler over a dense
     cache, the first model path through the contiguous decode wrappers.
     (a) sampler_serve: serve_batch on full-width llama3.2-3b, then on
     full-width mla_dense (27 layers), bf16, random weights from --seed:
     phase 3's 8 prompts left-padded to 1024, 32 new tokens, temperature
     0.7, one call of B 8 after a one-request warm-up; wall, tok/s, peak
     memory and launches by wrapper, checked: the contiguous decode
     wrapper (llama) or the contiguous MLA wrapper launches layers x 31
     (the last step's forward, whose logits nothing reads, is not run),
     the SPA forward 28 (llama's one prefill forward; MLA's prefill is
     plain PyTorch), every other kernel 0; greedy tokens of the first 4
     requests against a second, eager run with the plain versions on the
     card, a difference excused only at a tie (``greedy_flips``). (b)
     sampler_train: phase 6's run (12-layer f32 llama, N 4, G 8, prompt
     128, response 64, SPA, bf16 wire) with rollout_engine "group": 2
     iterations of async (staleness 0), then 3 of async_offpolicy at eta
     1 (each iteration's staleness at most 1; its last iteration
     profiled), launches checked against L x 63 x Sampler calls (the
     contiguous decode wrapper) and L x (calls + 3 x captured steps) (the
     SPA forward). (c) sampler_parity: reduced f32 llama, llama with a
     window of 8 (prompts longer than it ride the ring), mla_dense and
     deepseek-v2-lite with MoE on: the Sampler on the card against the
     CPU, greedy (tokens and lengths equal, logprobs within 1e-4), and
     sampled rows equal to the paged engine's on the card under the same
     key (MoE off).
 21. slot_engines (last): the dense-cache slot and spec engines, the
     first model path through the contiguous verify_attention and the
     contiguous MLA verify route. (a) cbatch_serve: ContinuousBatchingSampler
     on full-width llama3.2-3b, then full-width mla_dense, bf16, phase
     3's 8 prompts x 32 new through 4 slots, greedy, at D 1, D 8, spec k
     4 (prompt lookup) and (llama) spec k 4 with the resident draft
     model (14 layers, weights from --seed); wall, tok/s, engine steps,
     verify steps and acceptance, peak memory and launches, checked
     against the engine's own step count: the contiguous decode wrapper
     (or the MLA one) layers x device steps, the verify wrapper (or the
     MLA one) layers x verify steps, SPA layers x 8 admissions (llama),
     plus the draft model's calls (draft layers x k-step steps and
     one-token feeds through decode, x wider feeds through verify, x
     prefills through SPA); D 1 == D 8 bitwise; spec tokens of 4 requests
     against a run of the plain versions on the card, a difference
     excused only at a tie: at the first differing step the plain run's
     gap between the two tokens is within the two runs' own logit
     difference there, at most 0.25 (``greedy_flips`` on the verify
     logits ``VerifyLogits`` records). (b)
     spec_group_train: phase 6's run on --rollout-engine group --spec (the
     SpecSampler, k 4, prompt lookup), 2 async iterations at staleness 0,
     verify_attention checked against 12 x the verify steps. (c)
     model_draft_paged: phase 8's workload on the paged engine, greedy,
     with the prompt-lookup draft and with the draft model: the verify
     graph replays once a verify step, the draft model's calls all on the
     engine stream (recorded per call), launches checked, tokens equal to
     the prompt-lookup run's or differing only at a tie (both runs again,
     their verify logits recorded, ``greedy_flips``). (d) slot_parity:
     the reduced f32 models of phase 20 (c) through the slot engine at D 1
     / D 3 / spec k 2, the SpecSampler and the SpecSampler with the draft
     model, card == CPU (tokens; logprobs within 1e-4), and (MoE and
     window off) the slot engine's sampled rows equal to the paged
     engine's on the card under the same key.

The SPA kernels run bf16 on the tensor cores (wgmma, with the
probabilities and dS fed as a bf16 hi + lo pair) and f32 on the CUDA cores
(register tiles, no TF32). Phase 2 also holds the SPA backward kernel
against autograd of the plain version (full-width heads; a 1024-token
prompt, an SPA-packed row, a windowed prompt and the training row's shape;
f32 and bf16; two launches bitwise equal; torch.profiler's device time by
kernel for each, and of SDPA's backward beside it) and the transfer_cast kernel against x.to(torch.bfloat16),
bitwise, on every leaf of the training tree, a misaligned ragged length
and special values (ties, denormals, +-Inf, NaN). It also holds the MLA
kernel (both of its wrappers) against its plain version at full-width
heads (H 16, r 512, rd 64, MLA's scale 192^-0.5, page 16), bf16 and f32:
decode at B 4 with contexts 64 to 1088 (phase 11's shape) and at B 16
with contexts up to 8k, verify at B 4, S 5, contexts up to 1060 (phase
12's), a windowed verify, the training rollouts' decode (f32, B 8,
contexts up to 192, phase 16's) and the radix suffix prefill (bf16, B 1,
256 tokens after 512 cached, phase 15's longest); each case also prints
the wrapper's plan (context splits, keys per split, blocks). Its library
call is a page gather plus scaled_dot_product_attention with the boolean
mask (Dv != Dk); its bytes count each unique physical (page, slot) pair
the call sees once.

Then one line {"phase": "elapsed"} with the seconds from the script's
start to its end and to the last line of each phase (and phase 21's own
seconds), then one line
{"kernels": [...]} with eleven entries: the four kernels of
the training path at the training run's shapes and launch counts (phase
6; the two SPA entries also carry the bf16 1024-token prefill case, the
serving shape, under "bf16_prefill"; the paged decode entry phase 19's
windowed cases at 8k and 32k context with their D 1 runs' launches,
"window_8k_context" and "window_32k_context"), paged_verify_attention
at the spec shape with phase 8's launches (and the 512-token suffix prefill, phase
9's path, under "suffix_prefill"),
and the MLA kernel's decode case with phase 11's launches and its verify
case with phase 12's (bf16, with the plan's splits and blocks; the long
decode, f32 and windowed cases of phase 2 beside them under their names,
the decode entry's "training" case with phase 16's launches, in all and
per iteration, and the verify entry's "suffix_prefill" case with phase
15's spec-off launches; both MLA entries also carry phase 17's launches
on deepseek-v2-lite as published, the decode entry phase 18's too, as
does the transfer_cast entry); the contiguous decode_attention with
phase 20 (a)'s llama launches, timed at its shape (the 8k ring case and
phase 20 (b)'s training launches beside it), verify_attention with
phase 21 (a)'s llama spec launches (its model-draft run's and (b)'s
training launches beside them), timed at that spec shape (the 8k ring
and the L 1060 case beside it), the contiguous MLA route
(mla_decode_attention) with phase 20 (a)'s mla_dense launches, and the
contiguous MLA verify route (mla_verify_attention) with phase 21 (a)'s
mla_dense spec launches (bf16, the f32 case beside it); and last
{"ok": true, "device": {...}}.
Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import bisect
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
SPIN_CYCLES = 200_000                      # ~0.1 ms at the H100's clock
SPIN_CAP_CYCLES = SPIN_CYCLES << 5
TRAIN_LAYERS = 12      # 36 bytes per f32 parameter at an update: 28 layers
# (3.21 B parameters, ~116 GB) do not fit one 80 GB card, 12 (1.60 B) do
TRAIN_PROMPT, TRAIN_GROUP, TRAIN_RESP = 128, 8, 64
# phase 20 (a): the group Sampler serves phase 3's 8 prompts (left-padded
# to 1024) x 32 new tokens in one call
SAMPLER_LP, SAMPLER_NEW = 1024, 32


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


STARTED = time.time()
# [phase, seconds from the start to its last line] for each run of lines
# of one phase, printed in the "elapsed" line
PHASE_AT = []


def emit(obj: dict) -> None:
    if "phase" in obj:
        at = time.time() - STARTED
        if PHASE_AT and PHASE_AT[-1][0] == obj["phase"]:
            PHASE_AT[-1][1] = at
        else:
            PHASE_AT.append([obj["phase"], at])
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------

class Timer:
    """CUDA-event time of one call, averaged over ``iters`` calls, each
    starting with the L2 cache flushed (the serving path reads 28 layers
    of K/V and weights between two calls of the same layer's kernel).

    A spin is queued after the flush so that the host has enqueued the
    whole call before the card reaches the start event, and the host's
    launch work is not counted as device time. Whether it did is checked
    on every call: once the end event is queued, the start event must
    still be pending. A call the spin did not cover is thrown away and
    the spin doubled, up to SPIN_CAP_CYCLES; past that (a call that waits
    on the host inside, such as a plain version reading a tensor back)
    the call is kept, host time included, ``covered`` is False and the
    function's name and line go into ``uncovered``."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)
        self.covered = True          # of the last ms() call
        self.uncovered = []          # the functions of such calls

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total, kept, spin, covered = 0.0, 0, SPIN_CYCLES, True
        while kept < iters:
            self.flush.zero_()
            torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            ahead = not start.query()
            end.synchronize()
            if not ahead and spin < SPIN_CAP_CYCLES:
                spin *= 2
                continue
            covered = covered and ahead
            total += start.elapsed_time(end)
            kept += 1
        self.covered = covered
        if not covered:
            self.uncovered.append(
                f"{fn.__qualname__}:{fn.__code__.co_firstlineno}")
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

    def kernel():
        return spa_attention(*args, window=window)
    return {
        "kernel": "spa_attention", "dtype": dtype, "B": 1, "S": S, "H": H,
        "Hkv": Hkv, "D": D, "prompt": prompt, "responses": responses,
        "resp_len": resp_len, "window": window, "visible_pairs": pairs,
        "max_abs_err": err, "tol": TOL[dtype], "ok": ok,
        "ms": timer.ms(kernel, 20),
        "plain_ms": timer.ms(lambda: chunked_attention(*args, window=window),
                             5),
        "library_ms": timer.ms(library, 5),
        "library_covered": timer.covered,
        # device time summed over kernels, L2 warm on both sides: a check
        # on the event times that leaves out the host's launch work
        "profile_ms": sum(device_ms_by_kernel(torch, kernel).values()),
        "library_profile_ms": sum(device_ms_by_kernel(torch,
                                                      library).values()),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def device_ms_by_kernel(torch, fn, calls: int = 5) -> dict:
    """Device time a call spends in each kernel, by name, over ``calls``
    calls under torch.profiler (empty when the profiler sees no device
    activity on this machine)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


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

    def kernel():
        return spa_attention_bwd(*args, o32, lse, dout, window=window)

    def library():
        return torch.autograd.grad(out_lib, lib, dout_t, retain_graph=True)
    prof = device_ms_by_kernel(torch, kernel)
    lib_prof = device_ms_by_kernel(torch, library)
    return {
        "kernel": "spa_attention_bwd", "dtype": dtype, "B": 1, "S": S,
        "H": H, "Hkv": Hkv, "D": D, "prompt": prompt,
        "responses": responses, "resp_len": resp_len, "window": window,
        "visible_pairs": pairs, "max_abs_err": max(errs),
        "max_abs_err_dq_dk_dv": errs, "deterministic": deterministic,
        "tol": {"rtol": rtol, "atol_rel_to_max": atol_rel}, "ok": ok,
        "ms": timer.ms(kernel, 10),
        "fwd_stats_ms": timer.ms(lambda: _forward_kernel(
            *args, scale, window, stats=True), 10),
        # where the backward's device time goes: delta, the dq + dk/dv
        # tiles, the ordered sum of the per-head dk/dv parts
        "profile_ms_by_kernel": prof,
        "profile_ms": sum(prof.values()),
        "plain_ms": timer.ms(lambda: torch.autograd.grad(
            out_plain, leaves, dout, retain_graph=True), 3),
        "library_ms": timer.ms(library, 5),
        "library_covered": timer.covered,
        "library_profile_ms_by_kernel": lib_prof,
        "library_profile_ms": sum(lib_prof.values()),
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


def decode_setup(torch, dev, gen, dtype, *, B, ctx_max, page=16):
    """Paged decode at full-width heads: B rows of ctx_max / 8 to ctx_max
    tokens in fragmented pages, one query each at its last position."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    H, Hkv, D = 24, 8, 128
    n_max = -(-ctx_max // page)
    lens = np.linspace(max(1, ctx_max // 8), ctx_max, B).astype(int)
    rng = np.random.RandomState(B)
    P, pos, table, used_pages = _fragmented_pool(np, rng, lens, page, n_max)
    q_pos = (lens - 1).astype(np.int32)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dt)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    pos_t = torch.from_numpy(pos).to(dev)
    table_t = torch.from_numpy(table).to(dev)
    qpos_t = torch.from_numpy(q_pos).to(dev)

    def library():
        k, v, kv_pos = gather_pages(kp, vp, pos_t, table_t)
        mask = (kv_pos <= qpos_t[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    visible = int(lens.sum())                    # keys these rows can see
    elt = q.element_size()
    return {
        "name": "paged_decode_attention", "fn": paged_decode_attention,
        "plain": paged_decode_attention_plain,
        "args": (q, kp, vp, pos_t, table_t, qpos_t), "kw": {},
        "library": library,
        "bytes": (2 * q.numel() + 2 * visible * Hkv * D) * elt
        + 4 * (used_pages * page + table.size + B),
        "flops": 4.0 * D * H * visible,
        "info": {"kernel": "paged_decode_attention", "dtype": dtype, "B": B,
                 "ctx_max": int(ctx_max), "n_max": n_max, "page": page,
                 "H": H, "Hkv": Hkv, "D": D, "visible_keys": visible}}


def _fragmented_pool(np, rng, lens, page, n_max):
    """Rows b hold ``lens[b]`` tokens in pages scattered over the pool."""
    INVALID = 2 ** 30
    n_pages = [-(-int(n) // page) for n in lens]
    P = 2 + sum(n_pages)
    ids = rng.permutation(np.arange(2, P))
    table = np.zeros((len(lens), n_max), np.int32)
    pos = np.full((P, page), INVALID, np.int32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(lens, n_pages)):
        for j in range(npg):
            pid = ids[nxt]
            nxt += 1
            table[b, j] = pid
            p = np.arange(j * page, (j + 1) * page)
            pos[pid] = np.where(p < n, p, INVALID)
    return P, pos, table, sum(n_pages)


def _visible(np, q_pos, kv_pos, window):
    """(B, S, L) keys each query sees, as the kernels' mask says."""
    ok = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return ok


def _slots_read(np, table, page, vis):
    """Physical (page, slot) pairs some query of the call sees: the K/V
    the function must read, each once. A masked query (pos 2^30) sees the
    null page once per unused table entry, but it is one page."""
    phys = (table[:, :, None] * page + np.arange(page)).reshape(
        table.shape[0], -1)
    return int(np.unique(phys[vis.any(axis=1)]).size)


def verify_setup(torch, dev, gen, dtype, *, B, S, ctx_max, page=16,
                 window=None, suffix=False):
    """Paged verify at full-width heads: each row holds its context in
    fragmented pages and its last S tokens are the block (already
    written). Spec shapes mark row 0's last token as a masked slot (pos
    2^30, which sees every slot, as a fresh row's pad slot does)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_verify_attention, paged_verify_attention_plain)
    H, Hkv, D = 24, 8, 128
    rng = np.random.RandomState(B * 1000 + S)
    lens = (np.asarray([ctx_max]) if suffix else
            np.linspace(max(S, ctx_max // 8), ctx_max, B).astype(int))
    n_max = -(-ctx_max // page) + 1
    P, pos, table, used_pages = _fragmented_pool(np, rng, lens, page, n_max)
    q_pos = np.stack([np.arange(n - S, n) for n in lens]).astype(np.int32)
    if not suffix:
        q_pos[0, -1] = 2 ** 30
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    kp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    vp = torch.randn(P, page, Hkv, D, generator=gen, device=dev).to(dt)
    pos_t = torch.from_numpy(pos).to(dev)
    table_t = torch.from_numpy(table).to(dev)
    qpos_t = torch.from_numpy(q_pos).to(dev)
    kv_pos = pos[table].reshape(B, -1)
    vis = _visible(np, q_pos, kv_pos, window)
    pairs = int(vis.sum())
    keys = _slots_read(np, table, page, vis)

    def library():
        k, v, kvp = gather_pages(kp, vp, pos_t, table_t)
        mask = kvp[:, None, :] <= qpos_t[:, :, None]
        if window is not None:
            mask &= (qpos_t[:, :, None] - kvp[:, None, :]) < window
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)
    elt = q.element_size()
    return {
        "name": "paged_verify_attention", "fn": paged_verify_attention,
        "plain": paged_verify_attention_plain,
        "args": (q, kp, vp, pos_t, table_t, qpos_t), "kw": {"window": window},
        "library": library,
        "bytes": (2 * q.numel() + 2 * keys * Hkv * D) * elt
        + 4 * (used_pages * page + table.size + q_pos.size),
        "flops": 4.0 * D * H * pairs,
        "info": {"kernel": "paged_verify_attention", "dtype": dtype, "B": B,
                 "S": S, "ctx_max": int(ctx_max), "n_max": n_max,
                 "page": page, "H": H, "Hkv": Hkv, "D": D, "window": window,
                 "suffix_prefill": suffix, "visible_keys": keys,
                 "visible_pairs": pairs}}


def contiguous_setup(torch, dev, gen, dtype, *, verify, B=4, S=5, L=1060):
    """decode_attention (one query per row) or verify_attention (S per
    row) over a contiguous (B, L, Hkv, D) cache, which launch the paged
    kernels through a one-page-per-row view; rows hold L/8 to L tokens."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, verify_attention,
        verify_attention_plain)
    H, Hkv, D = 24, 8, 128
    S = S if verify else 1
    lens = np.linspace(L // 8, L, B).astype(int)
    kv_pos = np.where(np.arange(L)[None] < lens[:, None], np.arange(L)[None],
                      2 ** 30).astype(np.int32)
    q_pos = np.stack([np.arange(n - S, n) for n in lens]).astype(np.int32)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    kvp = torch.from_numpy(kv_pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    if verify:
        name, fn, plain = "verify_attention", verify_attention, \
            verify_attention_plain
        args = (q, k, v, kvp, qp)
    else:
        name, fn, plain = "decode_attention", decode_attention, \
            decode_attention_plain
        args = (q[:, 0].contiguous(), k, v, kvp, qp[:, 0].contiguous())
    vis = _visible(np, q_pos, kv_pos, None)
    pairs, keys = int(vis.sum()), int(vis.any(axis=1).sum())
    mask = (kvp[:, None, :] <= qp[:, :, None])[:, None]

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    elt = q.element_size()
    return {
        "name": name, "fn": fn, "plain": plain, "args": args, "kw": {},
        "library": library,
        "bytes": (2 * B * S * H * D + 2 * keys * Hkv * D) * elt
        + 4 * (kv_pos.size + q_pos.size),
        "flops": 4.0 * D * H * pairs,
        "info": {"kernel": name, "dtype": dtype, "B": B, "S": S, "L": L,
                 "H": H, "Hkv": Hkv, "D": D, "visible_keys": keys,
                 "visible_pairs": pairs}}


def _contiguous_decode(torch, dev, gen, dtype, kv_pos, q_pos, window, info):
    """decode_attention over a contiguous (B, L, Hkv, D) cache at
    full-width llama heads holding ``kv_pos`` (INVALID where unwritten or
    padding), one query a row at ``q_pos``."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    H, Hkv, D = 24, 8, 128
    B, L = kv_pos.shape
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    kvp = torch.from_numpy(kv_pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    vis = _visible(np, q_pos[:, None], kv_pos, window)
    keys = int(vis.sum())
    mask = (kvp <= qp[:, None])
    if window is not None:
        mask &= (qp[:, None] - kvp) < window

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)
    elt = q.element_size()
    return {
        "name": "decode_attention", "fn": decode_attention,
        "plain": decode_attention_plain, "args": (q, k, v, kvp, qp),
        "kw": {"window": window}, "library": library,
        "bytes": (2 * q.numel() + 2 * keys * Hkv * D) * elt
        + 4 * (kv_pos.size + B),
        "flops": 4.0 * D * H * keys,
        "info": {"kernel": "decode_attention", "dtype": dtype, "B": B,
                 "L": L, "H": H, "Hkv": Hkv, "D": D, "window": window,
                 "visible_keys": keys, **info}}


def sampler_layout(np, lens, t: int):
    """The group Sampler's contiguous cache in phase 20 (a)'s call at its
    decode forward t: row b left-padded to SAMPLER_LP (padding INVALID),
    its prompt at positions 0.. and t + 1 decode tokens after it, the rest
    unwritten (INVALID); the query at position lens[b] + t. Returns
    (kv_pos (B, SAMPLER_LP + SAMPLER_NEW), q_pos (B,))."""
    lens = np.asarray(lens)[:, None]
    i = np.arange(SAMPLER_LP + SAMPLER_NEW)[None]
    start = SAMPLER_LP - lens
    live = (i >= start) & (i <= SAMPLER_LP + t)
    kv_pos = np.where(live, i - start, 2 ** 30).astype(np.int32)
    return kv_pos, (lens[:, 0] + t).astype(np.int32)


def sampler_decode_setup(torch, dev, gen, dtype):
    """The contiguous decode wrapper at phase 20 (a)'s shape: B 8 rows of
    phase 3's prompt lengths in the Sampler's layout, at its last decode
    forward (t = SAMPLER_NEW - 2)."""
    import numpy as np
    lens = phase3_lens(np, 0)
    kv_pos, q_pos = sampler_layout(np, lens, SAMPLER_NEW - 2)
    return _contiguous_decode(torch, dev, gen, dtype, kv_pos, q_pos, None,
                              {"layout": "group Sampler, left-padded"})


def ring_decode_setup(torch, dev, gen, dtype, *, B=4, L=8192):
    """The contiguous decode wrapper over a sliding-window ring (window =
    L = 8192, long_context_variant's): each row's last L positions up to
    its query sit at slot (position mod L), out of position order; one row
    has not wrapped (its unwritten slots INVALID) and 5 % of the slots are
    INVALID padding."""
    import numpy as np
    rng = np.random.RandomState(L + B)
    q_pos = np.linspace(L // 2, 3 * L, B).astype(np.int32)
    i = np.arange(L)[None]
    q = q_pos[:, None]
    kv_pos = q - (q - i) % L
    kv_pos = np.where((kv_pos < 0) | (rng.rand(B, L) < 0.05), 2 ** 30,
                      kv_pos).astype(np.int32)
    return _contiguous_decode(torch, dev, gen, dtype, kv_pos, q_pos, L,
                              {"layout": "ring, rotated"})


def sampler_mla_setup(torch, dev, gen, dtype):
    """The contiguous MLA wrapper (mla_decode_attention) at phase 20 (a)'s
    mla_dense shape: full-width heads over the Sampler's latent cache of B
    8 rows, L SAMPLER_LP + SAMPLER_NEW slots viewed as B pages of length
    L, at the last decode forward."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        mla_decode_attention, mla_decode_attention_plain)
    H, r, rd, nd = MLA_HEADS
    scale = (nd + rd) ** -0.5
    lens = phase3_lens(np, 0)
    kv_pos, q_pos = sampler_layout(np, lens, SAMPLER_NEW - 2)
    B, L = kv_pos.shape
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, r + rd, generator=gen, device=dev).to(dt)
    ckv = torch.randn(B, L, r, generator=gen, device=dev).to(dt)
    kr = torch.randn(B, L, rd, generator=gen, device=dev).to(dt)
    kvp = torch.from_numpy(kv_pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    keys = int(_visible(np, q_pos[:, None], kv_pos, None).sum())

    def library():
        k = torch.cat([ckv, kr], dim=-1)[:, None]
        m = (kvp <= qp[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], k, ckv[:, None], attn_mask=m, scale=scale,
            enable_gqa=True)
    elt = q.element_size()
    return {
        "name": "mla_decode_attention", "fn": mla_decode_attention,
        "plain": mla_decode_attention_plain,
        "args": (q, ckv, kr, kvp, qp), "kw": dict(scale=scale),
        "library": library,
        "bytes": (B * H * ((r + rd) + r) + keys * (r + rd)) * elt
        + 4 * (kv_pos.size + B),
        "flops": 2.0 * keys * H * ((r + rd) + r),
        "info": {"kernel": "mla_decode_attention", "dtype": dtype, "B": B,
                 "L": L, "page": L, "H": H, "r": r, "rd": rd,
                 "scale": scale, "visible_keys": keys,
                 "layout": "group Sampler, left-padded"}}


def slot_layout(np, lens, t: int, L: int):
    """The slot engine's contiguous cache in phase 21 (a)'s spec run at a
    verify step of a steady row t tokens in: row b from slot 0 (slot ==
    position), its prompt and t committed tokens, the block's S slots from
    the last committed one on, 2 stale speculative entries after them
    (positions past every query), the rest unwritten (INVALID). Returns
    (kv_pos (B, L), q_pos (B, S)), S = SPEC_K + 1."""
    S = SPEC_K + 1
    n = np.asarray(lens)[:, None] + t
    i = np.arange(L)[None]
    kv_pos = np.where(i < n + S + 1, i, 2 ** 30).astype(np.int32)
    q_pos = (n - 1 + np.arange(S)[None]).astype(np.int32)
    return kv_pos, q_pos


def _contiguous_verify(torch, dev, gen, dtype, kv_pos, q_pos, window, info):
    """verify_attention over a contiguous (B, L, Hkv, D) cache at
    full-width llama heads holding ``kv_pos``, S queries a row at
    ``q_pos`` (B, S)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        verify_attention, verify_attention_plain)
    H, Hkv, D = 24, 8, 128
    (B, L), S = kv_pos.shape, q_pos.shape[1]
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, L, Hkv, D, generator=gen, device=dev).to(dt)
    kvp = torch.from_numpy(kv_pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    vis = _visible(np, q_pos, kv_pos, window)
    pairs, keys = int(vis.sum()), int(vis.any(axis=1).sum())
    mask = kvp[:, None, :] <= qp[:, :, None]
    if window is not None:
        mask &= (qp[:, :, None] - kvp[:, None, :]) < window

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)
    elt = q.element_size()
    return {
        "name": "verify_attention", "fn": verify_attention,
        "plain": verify_attention_plain, "args": (q, k, v, kvp, qp),
        "kw": {"window": window}, "library": library,
        "bytes": (2 * q.numel() + 2 * keys * Hkv * D) * elt
        + 4 * (kv_pos.size + q_pos.size),
        "flops": 4.0 * D * H * pairs,
        "info": {"kernel": "verify_attention", "dtype": dtype, "B": B,
                 "S": S, "L": L, "H": H, "Hkv": Hkv, "D": D,
                 "window": window, "visible_keys": keys,
                 "visible_pairs": pairs, **info}}


def slot_verify_setup(torch, dev, gen, dtype):
    """The contiguous verify wrapper at phase 21 (a)'s llama spec shape:
    B 4 slots holding 4 of phase 3's prompts, S 5, L 1024 + 32 + 5 (the
    slot engine's cache with spec slack), 16 tokens into the response."""
    import numpy as np
    L = SAMPLER_LP + SAMPLER_NEW + SPEC_K + 1
    kv_pos, q_pos = slot_layout(np, phase3_lens(np, 0)[:SLOT_SLOTS], 16, L)
    return _contiguous_verify(torch, dev, gen, dtype, kv_pos, q_pos, None,
                              {"layout": "slot engine, slot == position"})


def ring_verify_setup(torch, dev, gen, dtype, *, B=4, W=8192):
    """The contiguous verify wrapper over a sliding-window ring of
    window + k + 1 slots (window 8192, long_context_variant's; the dense
    spec engines' ring slack): each row's last L positions up to its last
    query at slot (position mod L), out of position order; one row has
    not wrapped (its unwritten slots INVALID), 5 % of the slots are
    INVALID padding; S 5 queries a row."""
    import numpy as np
    S = SPEC_K + 1
    L = W + S
    rng = np.random.RandomState(W + B + S)
    last = np.linspace(W // 2, 3 * W, B).astype(np.int32)
    i = np.arange(L)[None]
    kv_pos = last[:, None] - (last[:, None] - i) % L
    kv_pos = np.where((kv_pos < 0) | (rng.rand(B, L) < 0.05), 2 ** 30,
                      kv_pos).astype(np.int32)
    q_pos = (last[:, None] - S + 1 + np.arange(S)[None]).astype(np.int32)
    return _contiguous_verify(torch, dev, gen, dtype, kv_pos, q_pos, W,
                              {"layout": "ring of window + k + 1, rotated"})


def slot_mla_verify_setup(torch, dev, gen, dtype):
    """The contiguous MLA verify wrapper (mla_verify_attention) at phase
    21 (a)'s mla_dense spec shape: full-width heads, B 4 slots, S 5, the
    slot engine's latent cache of L 1024 + 32 + 5 slots viewed as B pages
    of length L."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        mla_verify_attention, mla_verify_attention_plain)
    H, r, rd, nd = MLA_HEADS
    scale = (nd + rd) ** -0.5
    L = SAMPLER_LP + SAMPLER_NEW + SPEC_K + 1
    kv_pos, q_pos = slot_layout(np, phase3_lens(np, 0)[:SLOT_SLOTS], 16, L)
    B, S = q_pos.shape
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, r + rd, generator=gen, device=dev).to(dt)
    ckv = torch.randn(B, L, r, generator=gen, device=dev).to(dt)
    kr = torch.randn(B, L, rd, generator=gen, device=dev).to(dt)
    kvp = torch.from_numpy(kv_pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    vis = _visible(np, q_pos, kv_pos, None)
    pairs, keys = int(vis.sum()), int(vis.any(axis=1).sum())

    def library():
        k = torch.cat([ckv, kr], dim=-1)[:, None]
        m = (kvp[:, None, :] <= qp[:, :, None])[:, None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, ckv[:, None], attn_mask=m, scale=scale,
            enable_gqa=True)
    elt = q.element_size()
    return {
        "name": "mla_verify_attention", "fn": mla_verify_attention,
        "plain": mla_verify_attention_plain,
        "args": (q, ckv, kr, kvp, qp), "kw": dict(scale=scale),
        "library": library,
        "bytes": (B * S * H * ((r + rd) + r) + keys * (r + rd)) * elt
        + 4 * (kv_pos.size + q_pos.size),
        "flops": 2.0 * pairs * H * ((r + rd) + r),
        "info": {"kernel": "mla_verify_attention", "dtype": dtype, "B": B,
                 "S": S, "L": L, "page": L, "H": H, "r": r, "rd": rd,
                 "scale": scale, "visible_keys": keys,
                 "visible_pairs": pairs,
                 "layout": "slot engine, slot == position"}}


def paged_case(torch, timer, case):
    """One decode / verify case of phase 2: the kernel against its plain
    version run in f32, its time beside the plain version's, the library
    call's and the bound, and how the wrapper launched it (regime,
    context splits, keys per split, blocks of the main kernel: the plan
    the wrapper recorded for this launch)."""
    from repro_torch.kernels.decode_attention import LAST_PLAN
    fn, plain, args, kw = case["fn"], case["plain"], case["args"], case["kw"]
    info = case["info"]
    dtype = info["dtype"]
    got = fn(*args, **kw)
    plan = dict(LAST_PLAN[info["kernel"]])
    err, ok = max_err(torch, got, plain(*f32(args), **kw), TOL[dtype])
    b_ms, b_by = bound(case["bytes"], case["flops"], dtype)
    ms = timer.ms(lambda: fn(*args, **kw), 20)
    return {
        **info, "regime": plan["regime"], "splits": plan["splits"],
        "keys_per_split": plan["keys_per_split"], "blocks": plan["blocks"],
        "max_abs_err": err, "tol": TOL[dtype], "ok": ok, "ms": ms,
        "plain_ms": timer.ms(lambda: plain(*args, **kw), 5),
        "library_ms": timer.ms(case["library"], 5),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
    }


def decode_case(torch, timer, dev, gen, dtype, **kw):
    return paged_case(torch, timer, decode_setup(torch, dev, gen, dtype,
                                                 **kw))


def verify_case(torch, timer, dev, gen, dtype, **kw):
    return paged_case(torch, timer, verify_setup(torch, dev, gen, dtype,
                                                 **kw))


def contiguous_case(torch, timer, dev, gen, dtype, **kw):
    return paged_case(torch, timer, contiguous_setup(torch, dev, gen, dtype,
                                                     **kw))


def setup_case(torch, timer, dev, gen, dtype, setup, **kw):
    return paged_case(torch, timer, setup(torch, dev, gen, dtype, **kw))


MLA_HEADS = (16, 512, 64, 128)     # H, r, rd, nd of full-width mla_dense
MLA_PROFILE_KERNELS = ("paged_mla_kernel", "combine_kernel")


def mla_setup(torch, dev, gen, dtype, *, B, S, ctx_max, ctx_min=None,
              page=16, window=None, suffix=False):
    """The paged MLA kernel at full-width heads over a fragmented latent
    pool: S == 1 through paged_mla_decode_attention, S > 1 through
    paged_mla_verify_attention (row 0's last token then a masked slot at
    pos 2^30, as a fresh row's pad slot). Rows hold ctx_min (default
    ctx_max / 8) to ctx_max tokens; the queries are each row's last S.
    ``suffix``: a radix suffix prefill, one row of ctx_max tokens whose
    last S are the block, no masked slot."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gather_latent_pages, paged_mla_decode_attention,
        paged_mla_decode_attention_plain, paged_mla_verify_attention,
        paged_mla_verify_attention_plain)
    H, r, rd, nd = MLA_HEADS
    scale = (nd + rd) ** -0.5
    rng = np.random.RandomState(B * 1000 + S + 7)
    lo = max(S, ctx_max // 8) if ctx_min is None else ctx_min
    lens = (np.asarray([ctx_max]) if suffix else
            np.linspace(lo, ctx_max, B).astype(int))
    n_max = -(-ctx_max // page) + 1
    P, pos, table, used_pages = _fragmented_pool(np, rng, lens, page, n_max)
    q_pos = np.stack([np.arange(n - S, n) for n in lens]).astype(np.int32)
    if S > 1 and not suffix:
        q_pos[0, -1] = 2 ** 30
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, r + rd, generator=gen, device=dev).to(dt)
    ckv = torch.randn(P, page, r, generator=gen, device=dev).to(dt)
    kr = torch.randn(P, page, rd, generator=gen, device=dev).to(dt)
    pos_t = torch.from_numpy(pos).to(dev)
    table_t = torch.from_numpy(table).to(dev)
    qpos_t = torch.from_numpy(q_pos).to(dev)
    if S == 1:
        name = "paged_mla_decode_attention"
        fn, plain = paged_mla_decode_attention, \
            paged_mla_decode_attention_plain
        args = (q[:, 0].contiguous(), ckv, kr, pos_t, table_t,
                qpos_t[:, 0].contiguous())
    else:
        name = "paged_mla_verify_attention"
        fn, plain = paged_mla_verify_attention, \
            paged_mla_verify_attention_plain
        args = (q, ckv, kr, pos_t, table_t, qpos_t)
    kv_pos = pos[table].reshape(B, -1)
    vis = _visible(np, q_pos, kv_pos, window)
    pairs = int(vis.sum())
    keys = _slots_read(np, table, page, vis)

    def library():
        k, v, kvp = gather_latent_pages(ckv, kr, pos_t, table_t)
        m = kvp[:, None, :] <= qpos_t[:, :, None]
        if window is not None:
            m &= (qpos_t[:, :, None] - kvp[:, None, :]) < window
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m[:, None], scale=scale, enable_gqa=True)
    elt = q.element_size()
    return {
        "name": name, "fn": fn, "plain": plain, "args": args,
        "kw": dict(scale=scale, window=window), "library": library,
        "bytes": (B * S * H * ((r + rd) + r) + keys * (r + rd)) * elt
        + 4 * (used_pages * page + table.size + q_pos.size),
        "flops": 2.0 * pairs * H * ((r + rd) + r),
        "info": {"kernel": name, "dtype": dtype, "B": B, "S": S,
                 "ctx": [int(lens.min()), int(lens.max())], "n_max": n_max,
                 "page": page, "H": H, "r": r, "rd": rd, "scale": scale,
                 "window": window, "suffix_prefill": suffix,
                 "visible_keys": keys,
                 "visible_pairs": pairs}}


def mla_case(torch, timer, dev, gen, dtype, **kw):
    return paged_case(torch, timer, mla_setup(torch, dev, gen, dtype, **kw))


# ---------------------------------------------------------------------
# phase 3: full-width serving; phase 4: reduced parity with the CPU
# ---------------------------------------------------------------------

def phase3_lens(np, seed: int):
    """Phase 3's 8 prompt lengths: 64 to 1024 tokens, the longest 1024."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1025, size=8)
    lens[int(np.argmax(lens))] = 1024
    return lens


def phase3_prompts(np, cfg, seed: int):
    """(lengths, prompts) of phase 3's 8 requests (random ids from
    ``seed``); phase 20 serves the same."""
    lens = phase3_lens(np, seed)
    rng = np.random.RandomState(seed)
    rng.randint(64, 1025, size=8)           # the draw of the lengths
    return lens, [rng.randint(3, cfg.vocab_size, size=(int(n),))
                  .astype(np.int32) for n in lens]


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
    lens, prompts = phase3_prompts(np, cfg, seed)
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.7)
    eng = build_paged_engine(cfg, device=dev, **kw)
    # hand the tree over and keep the engine's copy: the weights stay
    # resident once (the engine clones what it is given, for its graph)
    params = eng.set_params(params)
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
        "graph_replays": snap["graph_replays"], "graph": eng.capture_ms,
        "peak_pages": stats["peak_pages"], "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "mem_gib": torch.cuda.memory_allocated(dev) / 2 ** 30,
        "first_tokens": [r.tokens[:8] for r in reqs[:2]],
    }


def profile_decode(torch, np, eng, prompts, seed: int, steps: int = 8,
                   kernels=(), max_new: int = 32):
    """Device busy and idle time of decode steps with every slot busy
    (prefills happen before the windows open). Two adjacent windows of
    about ``steps`` decode steps each (``steps // D`` engine steps of D
    decode steps): the first unprofiled, for the host wall time of a
    decode step, and the device time of the graph replays (CUDA events
    around each replay); the second under torch.profiler, for the
    device-busy time of a step (the sum of kernel self times; the profiler
    slows the host, not the kernels). The idle shares are estimates from
    the two windows. ``kernels``: names whose device time per step
    (summed over every kernel whose name holds one) is reported apart."""
    from torch.profiler import ProfilerActivity, profile
    calls = max(1, steps // eng.drain)

    def window():
        """(host wall ms, decode steps, replay device ms) of ``calls``
        engine steps."""
        with eng.time_replays() as pairs:
            n0 = eng.decode_steps
            t0 = time.perf_counter()
            for _ in range(calls):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return (wall, eng.decode_steps - n0,
                sum(a.elapsed_time(b) for a, b in pairs))
    handles = [eng.submit(p, (seed, 1000 + i), max_new=max_new)
               for i, p in enumerate(prompts[:eng.B])]
    eng.step()              # admission + prefills (+ the first block)
    torch.cuda.synchronize()
    wall_ms, n, replay_ms = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_wall_ms, p_n, _ = window()
    while eng.step():
        pass
    if not all(h.done() for h in handles):
        fail("profiled requests did not complete")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / p_n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "phase": "profile", "drain_interval": eng.drain,
        "decode_steps_per_window": n, "slots_busy": eng.B,
        "wall_ms_per_step": wall_ms / n,
        "profiled_wall_ms_per_step": p_wall_ms / p_n,
        "device_busy_ms_per_step": busy_ms,
        # busy time of the profiled window over wall time of the unprofiled
        # one; null when the profiler saw no device activity on this machine
        "device_idle_share_est": (1.0 - busy_ms * n / wall_ms) if busy_ms
        else None,
        # the same from the replays' CUDA events (unprofiled window)
        "replay_device_ms_per_step": replay_ms / n,
        "device_idle_share_replays": 1.0 - replay_ms / wall_ms,
        "top_kernels_ms_per_step": [
            [e.key[:80], e.self_device_time_total / 1e3 / p_n, e.count]
            for e in top],
        "kernel_ms_per_step": {
            name: sum(e.self_device_time_total for e in events
                      if name in e.key) / 1e3 / p_n for name in kernels},
        "kernel_launches_per_step": {
            name: sum(e.count for e in events if name in e.key) / p_n
            for name in kernels},
    }


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _to(tree, d):
    return {k: _to(v, d) if isinstance(v, dict) else v.to(d)
            for k, v in tree.items()}


def reduced_parity(torch, np, dev, seed: int):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import forward, init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=seed, device="cpu")
    p_gpu = _to(p_cpu, dev)
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in rng.randint(5, 48, size=4)]
    kw = dict(max_prompt_len=48, max_new=16, num_slots=2, page_size=16,
              temperature=0.0, seed=seed)
    def tokens(where, params, drain):
        done, _ = serve_paged(cfg, prompts, device=where, params=params,
                              drain_interval=drain, **kw)
        return {c.request_id: c.response_ids.tolist() for c in done}
    tok_cpu = tokens("cpu", p_cpu, 1)
    tok_gpu = tokens(dev, p_gpu, 1)
    if tok_cpu != tok_gpu:
        fail(f"greedy tokens differ between card and CPU: {tok_gpu} vs "
             f"{tok_cpu}")
    # D 3: the card's 3-step graph against the CPU engine at D 3 and the
    # card's own D 1 tokens
    tok_gpu3, tok_cpu3 = tokens(dev, p_gpu, 3), tokens("cpu", p_cpu, 3)
    if not tok_gpu3 == tok_cpu3 == tok_gpu:
        fail(f"greedy tokens at D 3 differ: card {tok_gpu3}, CPU "
             f"{tok_cpu3}, card at D 1 {tok_gpu}")
    toks = torch.from_numpy(rng.randint(3, cfg.vocab_size, size=(2, 48)))
    lg_cpu, _ = forward(p_cpu, cfg, toks)
    lg_gpu, _ = forward(p_gpu, cfg, toks.to(dev))
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if err > 1e-3:
        fail(f"prefill logits differ by {err} > 1e-3 between card and CPU")
    return {"phase": "parity", "arch": cfg.name, "dtype": "float32",
            "requests": len(prompts),
            "tokens": sum(len(t) for t in tok_cpu.values()),
            "tokens_identical": True, "drain_intervals": [1, 3],
            "prefill_logits_max_abs_err": err, "tol": 1e-3}


# ---------------------------------------------------------------------
# phases 8-10: speculative decode and the radix prefix cache
# ---------------------------------------------------------------------

SPEC_K = 4

# phase 2's MLA cases at full-width heads (spa_ab.py --kernels mla times
# the same): name -> mla_setup's dtype and keywords. Serving decode (B 4)
# and the spec verify block (B 4, S 5) at phase 11's and 12's shapes, B 16
# to 8k, in bf16 and f32; the verify block with a window; the training
# rollouts' decode (f32, B 8 to the training row's 192 keys, phase 16)
# and the radix suffix prefill (bf16, B 1, 256 tokens after 512 cached,
# phase 15's longest).
MLA_CASES = {
    f"{case}_{dtype}": dict(dtype=dtype, **kw)
    for dtype in ("bfloat16", "float32")
    for case, kw in (
        ("decode_serve", dict(B=4, S=1, ctx_min=64, ctx_max=1088)),
        ("decode_long", dict(B=16, S=1, ctx_max=8192)),
        ("verify_spec", dict(B=4, S=SPEC_K + 1, ctx_max=1060)))}
MLA_CASES["verify_window_bfloat16"] = dict(
    dtype="bfloat16", B=4, S=SPEC_K + 1, ctx_max=1060, window=256)
MLA_CASES["decode_train_float32"] = dict(
    dtype="float32", B=TRAIN_GROUP, S=1, ctx_max=TRAIN_PROMPT + TRAIN_RESP)
MLA_CASES["verify_suffix_bfloat16"] = dict(
    dtype="bfloat16", B=1, S=256, ctx_max=512 + 256, suffix=True)


def _pages_conserved(eng) -> bool:
    """Drained engine: every page is free or held by the radix tree, and
    the tree holds exactly one reference on each of its pages."""
    from repro_torch.core.paged import FIRST_PAGE
    tree = eng.radix.pages() if eng.radix is not None else []
    return (eng.idle and eng.alloc.num_free + eng.alloc.num_live
            == eng.P - FIRST_PAGE and eng.alloc.num_live == len(tree)
            and all(eng.alloc.refcount(p) == 1 for p in tree))


def spec_serve(torch, np, dev, params, prompts, seed: int):
    """Phase 3's 8 requests through RequestDriver with spec decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_requests
    cfg = get_config("llama3.2-3b")
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.7, spec_k=SPEC_K)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_paged_engine(cfg, device=dev, **kw)
    serve_requests(cfg, prompts[:1], params=params, engine=eng, seed=seed,
                   arrivals=np.zeros(1), **kw)        # warm-up request
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
    expect = {"spa_attention": L * snap["prefills"],
              "paged_verify_attention": L * snap["decode_steps"],
              "paged_decode_attention": 0}
    out = {
        "phase": "spec_serve", "arch": cfg.name, "layers": L,
        "dtype": cfg.param_dtype, "requests": len(reqs), "spec_k": SPEC_K,
        "draft": "prompt_lookup", "max_new": 32, "slots": 4, "page": 16,
        "temperature": 0.7, "generated_tokens": m["generated_tokens"],
        "tok_per_s": m["tok_per_s"], "makespan_s": m["makespan_s"],
        "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
        "tpot_p50_s": m["tpot_p50_s"], "tpot_p99_s": m["tpot_p99_s"],
        "prefills": snap["prefills"], "verify_forwards": snap["decode_steps"],
        "row_verifies": snap["spec_steps"],
        "acceptance_rate": stats["acceptance_rate"],
        "tokens_per_forward": stats["tokens_per_forward"],
        "rolled_back_pages": stats["rolled_back_pages"],
        "peak_pages": stats["peak_pages"], "launches": launches,
        "expected_launches": expect,
        "pages_conserved": _pages_conserved(eng),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "first_tokens": [r.tokens[:8] for r in reqs[:2]],
    }
    if {k: launches[k] for k in expect} != expect or \
            snap["prefills"] != len(prompts) or snap["decode_steps"] == 0:
        fail(f"spec_serve: launches {launches} != {expect}")
    if not out["pages_conserved"]:
        fail("spec_serve: pages did not all return to the freelist")
    for r in reqs:
        if not 1 <= len(r.tokens) <= 32 or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"spec_serve: request {r.rid}: bad tokens {r.tokens}")
    return eng, out


# the engine's paged kernels by family: (S > 1 tokens a row, one token)
PAGED_KERNELS = {False: ("paged_verify_attention", "paged_decode_attention"),
                 True: ("paged_mla_verify_attention",
                        "paged_mla_decode_attention")}
TTFT_GAP_S = 0.25         # arrivals of the TTFT runs: one request at a time


class HeldTree:
    """A phase's one tree of weights, handed from engine to engine as the
    serve entry points hand theirs over: ``load(eng)`` gives the tree to
    ``eng.set_params`` and keeps the tree it returns (on the card the
    engine's clone) in place of the one it gave. So long as the caller
    holds the tree only here and drops each engine before loading the
    next, the card holds the weights once, and twice only during a
    clone."""

    def __init__(self, tree: dict):
        self.tree = tree

    def load(self, eng) -> dict:
        self.tree = eng.set_params(self.tree)
        return self.tree


def radix_ttft(torch, np, dev, cfg, weights, prompts, seed: int):
    """TTFT of the shared-system requests arriving one every TTFT_GAP_S
    (each prefilled alone, spec off) through RequestDriver, on an engine
    with the radix cache and on one without: request 0 is cold on both,
    requests 1..7 are warm (suffix prefill) on the first and cold on the
    second. ``weights``: a ``HeldTree``, loaded into each engine."""
    from repro_torch.launch.serve import (build_paged_engine,
                                          compute_latency_metrics,
                                          serve_requests)
    full = max(len(p) for p in prompts)
    kw = dict(max_prompt_len=full, max_new=32, num_slots=len(prompts),
              page_size=16, temperature=0.7)
    arrivals = np.arange(len(prompts)) * TTFT_GAP_S
    out = {"gap_s": TTFT_GAP_S}
    for name, prefix in (("cold", False), ("warm", True)):
        eng = build_paged_engine(cfg, prefix_cache=prefix, device=dev, **kw)
        weights.load(eng)                 # the graph's capture, outside
        reqs, _, _ = serve_requests(cfg, prompts, params=weights.tree,
                                    engine=eng,
                                    seed=seed, arrivals=arrivals,
                                    prefix_cache=prefix, **kw)
        torch.cuda.synchronize()
        later = sorted(r.ttft for r in reqs if r.rid > 0)
        m = compute_latency_metrics(reqs)
        out[name] = {"first_request_ttft_s": reqs[0].ttft,
                     "ttft_p50_s": float(np.percentile(later, 50)),
                     "ttft_p99_s": float(np.percentile(later, 99)),
                     "tpot_p50_s": m["tpot_p50_s"],
                     "tpot_p99_s": m["tpot_p99_s"],
                     "tok_per_s": m["tok_per_s"],
                     "warm_prefills": eng.warm_prefills,
                     "cold_prefills": eng.prefills}
        del eng
        gc.collect()                      # its pool before the next's
    if out["warm"]["warm_prefills"] != len(prompts) - 1 or \
            out["cold"]["cold_prefills"] != len(prompts):
        fail(f"radix ttft: expected {len(prompts) - 1} warm prefills with "
             f"the cache and none without: {out}")
    return out


def radix_serve(torch, np, dev, cfg, weights, seed: int,
                phase: str = "radix_serve", drops=None):
    """serve_shared over a 512-token system prompt and 8 suffixes, spec
    off and then on, and the warm against cold TTFT (``radix_ttft``).
    ``weights``: a ``HeldTree``, loaded into each engine. ``drops``: a MoE
    drop counter's ``take`` (phase 17), read into each run's line."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_shared
    rng = np.random.RandomState(seed + 9)
    system = rng.randint(3, cfg.vocab_size, size=512).astype(np.int32)
    sfx_lens = np.linspace(16, 256, 8).astype(int)
    suffixes = [rng.randint(3, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in sfx_lens]
    L = cfg.num_layers
    verify, decode = PAGED_KERNELS[cfg.use_mla]
    runs = []
    for spec_k in (0, SPEC_K):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        full = len(system) + int(sfx_lens.max())
        eng = build_paged_engine(cfg, max_prompt_len=full, max_new=32,
                                 num_slots=len(suffixes), page_size=16,
                                 temperature=0.7, spec_k=spec_k,
                                 prefix_cache=True, device=dev)
        # the first set_params captures the step's graph (its warm-up
        # launches are not the serving run's)
        weights.load(eng)
        torch.cuda.synchronize()
        if drops is not None:
            drops()                       # the graph's warm-up routed too
        reset_launch_counts()
        t0 = time.perf_counter()
        done, stats = serve_shared(cfg, system, suffixes, max_prompt_len=full,
                                   max_new=32, page_size=16, temperature=0.7,
                                   seed=seed, spec_k=spec_k,
                                   params=weights.tree, engine=eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        snap = eng.stats_snapshot()
        # the cold prefill: the SPA kernel (GQA) or plain PyTorch (MLA's
        # expanded attention); every other kernel of the run is the
        # family's paged pair
        expect = {name: 0 for name in launches}
        expect["spa_attention"] = 0 if cfg.use_mla else L * snap["prefills"]
        expect[verify] = L * (snap["warm_prefills"]
                              + (snap["decode_steps"] if spec_k else 0))
        expect[decode] = 0 if spec_k else L * snap["decode_steps"]
        run = {
            "spec_k": spec_k, "wall_s": wall,
            "generated_tokens": stats["generated_tokens"],
            "tok_per_s": stats["tok_per_s"],
            "cold_prefills": snap["prefills"],
            "warm_prefills": snap["warm_prefills"],
            "decode_steps": snap["decode_steps"],
            "prefix_hit_pages": snap["prefix_hit_pages"],
            "prefix_miss_pages": snap["prefix_miss_pages"],
            "prefix_hit_rate": stats["prefix_hit_rate"],
            "prompt_pages_saved": stats["prompt_pages_saved"],
            "tree_pages": len(eng.radix.pages()),
            "pages_conserved": _pages_conserved(eng),
            "launches": launches, "expected_launches": expect,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        }
        if spec_k:
            run.update(acceptance_rate=stats["acceptance_rate"],
                       tokens_per_forward=stats["tokens_per_forward"],
                       rolled_back_pages=stats["rolled_back_pages"])
        if drops is not None:
            run["moe_drops"] = drops()
        runs.append(run)
        if snap["prefix_hit_pages"] != 7 * 32 or snap["prefills"] != 1 or \
                snap["warm_prefills"] != 7:
            fail(f"{phase}: expected 7 x 32 hit pages from 1 cold and 7 "
                 f"warm prefills, got {run}")
        if launches != expect:
            fail(f"{phase}: launches {launches} != {expect}")
        if not run["pages_conserved"]:
            fail(f"{phase}: pages not conserved after the drain: {run}")
        for c in done:
            if not 1 <= len(c.response_ids) <= 32 or not all(
                    0 <= t < cfg.vocab_size for t in c.response_ids):
                fail(f"{phase}: request {c.request_id}: bad tokens "
                     f"{c.response_ids}")
        if not bool(torch.isfinite(eng.logits).all()):
            fail(f"{phase}: non-finite logits after serving")
        del eng
        gc.collect()                      # its pool before the next's
    ttft = radix_ttft(torch, np, dev, cfg, weights,
                      [np.concatenate([system, sfx]) for sfx in suffixes],
                      seed)
    return {"phase": phase, "arch": cfg.name, "layers": L,
            "dtype": cfg.param_dtype, "system_tokens": len(system),
            "system_pages": 32, "suffix_lens": [int(n) for n in sfx_lens],
            "max_new": 32, "page": 16, "temperature": 0.7,
            "pool_bytes_per_token": _pool_bytes_per_token(cfg),
            "runs": runs, "ttft": ttft}


def _tokens(done):
    return {c.request_id: c.response_ids.tolist() for c in done}


def radix_parity(torch, np, dev, cfg, p_cpu, p_gpu, rng, seed: int,
                 variants=((0, 1),)):
    """A reduced model's radix cache on the card: greedy warm tokens
    (serve_shared: a 2-page system prompt and 3 suffixes) identical to
    cold ones for each (spec k, D) of ``variants``, and a warm suffix
    prefill's last-token logits within 1e-3 of a cold prefill's on the
    CPU. Returns the checks' numbers."""
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.launch.serve import (build_paged_engine, serve_paged,
                                          serve_shared)
    system = rng.randint(3, cfg.vocab_size, size=32).astype(np.int32)
    sufs = [rng.randint(3, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in (5, 17, 9)]
    kw = dict(max_new=16, page_size=16, temperature=0.0)
    cold = _tokens(serve_paged(cfg, [np.concatenate([system, s])
                                     for s in sufs], device=dev,
                               params=p_gpu, max_prompt_len=64,
                               num_slots=2, seed=seed, **kw)[0])
    for spec_k, drain in variants:
        eng = build_paged_engine(cfg, max_prompt_len=64,
                                 num_slots=len(sufs), spec_k=spec_k,
                                 prefix_cache=True, drain_interval=drain,
                                 device=dev, **kw)
        warm, wstats = serve_shared(cfg, system, sufs, max_prompt_len=64,
                                    seed=seed, params=p_gpu, engine=eng,
                                    **kw)
        if _tokens(warm) != cold or wstats["prompt_pages_saved"] != 4:
            fail(f"{cfg.name} warm radix tokens at spec k {spec_k}, D "
                 f"{drain}: {_tokens(warm)} != cold {cold} (pages saved "
                 f"{wstats['prompt_pages_saved']})")
        del eng
    # the warm suffix prefill's last-token logits against a cold prefill
    ekw = dict(num_slots=2, page_size=16, num_pages=0, max_prompt_len=64,
               max_new_tokens=4, group_size=1, temperature=0.0,
               capture_logprobs=False)
    eng = PagedGroupEngine(cfg, prefix_cache=True, device=dev, **ekw)
    eng.set_params(p_gpu)
    eng.submit(np.concatenate([system, sufs[0]]), 0)
    eng.step()
    h = eng.submit(np.concatenate([system, sufs[1]]), 1)
    eng.step()
    ref = PagedGroupEngine(cfg, device="cpu", **ekw)
    ref.set_params(p_cpu)
    h_ref = ref.submit(np.concatenate([system, sufs[1]]), 1)
    ref.step()
    err = float((h._group.prompt_logits.cpu()
                 - h_ref._group.prompt_logits).abs().max())
    while eng.step():
        pass
    while ref.step():
        pass
    if err > 1e-3 or eng.warm_prefills != 1:
        fail(f"{cfg.name} warm suffix prefill logits: max |err| {err} "
             f"(tol 1e-3), {eng.warm_prefills} warm prefills")
    return {"radix_warm_identical_cold": [list(v) for v in variants],
            "warm_prefills": eng.warm_prefills,
            "warm_prefill_logits_max_abs_err": err, "tol": 1e-3}


def spec_parity(torch, np, dev, seed: int):
    """Reduced llama on the card against the CPU: greedy spec decode, warm
    radix serving and the warm suffix prefill's logits."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=seed, device="cpu")
    p_gpu = _to(p_cpu, dev)
    rng = np.random.RandomState(seed + 2)
    # prompts that repeat themselves, so the prompt lookup drafts hit
    prompts = []
    for n in rng.randint(8, 40, size=4):
        base = rng.randint(3, cfg.vocab_size, size=(int(n) // 2 + 1,))
        prompts.append(np.concatenate([base, base])[:int(n)].astype(np.int32))
    kw = dict(max_prompt_len=48, max_new=16, num_slots=2, page_size=16,
              temperature=0.0, seed=seed)
    reset_launch_counts()
    done_gpu, spec_stats = serve_paged(cfg, prompts, device=dev,
                                       params=p_gpu, spec_k=SPEC_K, **kw)
    spec_gpu = _tokens(done_gpu)
    spec_cpu = _tokens(serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                                   spec_k=SPEC_K, **kw)[0])
    plain_gpu = _tokens(serve_paged(cfg, prompts, device=dev, params=p_gpu,
                                    **kw)[0])
    if not spec_gpu == spec_cpu == plain_gpu:
        fail(f"spec greedy tokens differ: card {spec_gpu}, CPU {spec_cpu}, "
             f"card non-spec {plain_gpu}")
    radix = radix_parity(torch, np, dev, cfg, p_cpu, p_gpu, rng, seed)
    launches = dict(LAUNCHES)
    out = {"phase": "spec_parity", "arch": cfg.name, "dtype": "float32",
           "spec_k": SPEC_K, "requests": len(prompts),
           "spec_tokens": sum(len(t) for t in spec_cpu.values()),
           "spec_acceptance_rate": spec_stats["acceptance_rate"],
           "spec_tokens_per_forward": spec_stats["tokens_per_forward"],
           "spec_identical_cpu_and_nonspec": True, **radix,
           "launches_card": launches}
    if launches["paged_verify_attention"] == 0:
        fail(f"spec parity: {out}")
    return out


# ---------------------------------------------------------------------
# phases 11-13: MLA (deepseek-v2-lite attention, MoE off)
# ---------------------------------------------------------------------

def mla_dense_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                               num_experts=0, num_experts_per_tok=0,
                               num_shared_experts=0, moe_d_ff=0,
                               first_k_dense=0, dense_d_ff=0)


def mla_train_config():
    """Phase 16's model: mla_dense at full depth (27 layers) in f32, the
    trainer's master weights (1.025 B parameters, 4.1 GB a tree)."""
    import dataclasses
    return dataclasses.replace(mla_dense_config(), param_dtype="float32",
                               compute_dtype="float32")


def reduced_mla_train_config():
    from repro_torch.configs import reduced_config
    return reduced_config(mla_train_config())


def _pool_bytes_per_token(cfg) -> int:
    """Bytes one cached token takes in the paged pool over all layers."""
    import math
    from repro_torch.models.attention import cache_streams
    from repro_torch.models.layers import dtype_of
    elt = dtype_of(cfg.compute_dtype).itemsize
    return cfg.num_layers * elt * sum(math.prod(shp)
                                      for _, shp in cache_streams(cfg))


def phase11_prompts(np, cfg, seed: int):
    """Phase 11's 8 prompts of 64 to 1024 tokens (one of 1024)."""
    rng = np.random.RandomState(seed + 11)
    lens = rng.randint(64, 1025, size=8)
    lens[int(np.argmax(lens))] = 1024
    return [rng.randint(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
            for n in lens]


def serve_run(torch, np, dev, cfg, weights, prompts, seed: int, *,
              phase: str, spec_k: int = 0, drain: int = 1, counter=None):
    """An MLA model (mla_dense or deepseek-v2-lite as published) serves
    ``prompts`` through RequestDriver on a fresh engine (32 new tokens, 4
    slots, page 16, temperature 0.7; D ``drain``, spec k ``spec_k``),
    after a warm-up request. ``weights``: a ``HeldTree``, loaded into the
    engine. Checks launches (the MLA decode
    kernel, the verify kernel with spec, L x steps, all of them replays;
    every other kernel 0), every page back, the tokens, finite logits and,
    with a MoE drop ``counter``, its forwards by kind. Returns (engine,
    result line)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_requests
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.7, spec_k=spec_k)
    eng = build_paged_engine(cfg, device=dev, drain_interval=drain, **kw)
    t0 = time.perf_counter()
    params = weights.load(eng)                 # clone, pool, capture
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    serve_requests(cfg, prompts[:1], params=params, engine=eng, seed=seed,
                   arrivals=np.zeros(1), **kw)        # warm-up request
    eng.reset_stats()
    if counter is not None:
        counter.take()
    torch.cuda.synchronize()
    reset_launch_counts()
    reqs, m, stats = serve_requests(cfg, prompts, params=params, engine=eng,
                                    seed=seed, arrivals=np.zeros(len(prompts)),
                                    **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    snap = eng.stats_snapshot()
    L = cfg.num_layers
    steps = snap["decode_steps"]
    verify, decode = PAGED_KERNELS[True]
    expect = {name: 0 for name in launches}
    expect[verify if spec_k else decode] = L * steps
    out = {
        "phase": phase, "arch": cfg.name, "moe": cfg.num_experts > 0,
        "layers": L, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_rope_head_dim": cfg.qk_rope_head_dim, "dtype": cfg.param_dtype,
        "drain_interval": drain, "requests": len(reqs),
        "prompt_lens": [len(p) for p in prompts], "max_new": 32, "slots": 4,
        "page": 16, "temperature": 0.7, "spec_k": spec_k,
        "generated_tokens": m["generated_tokens"],
        "tok_per_s": m["tok_per_s"], "makespan_s": m["makespan_s"],
        "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
        "tpot_p50_s": m["tpot_p50_s"], "tpot_p99_s": m["tpot_p99_s"],
        "prefills": snap["prefills"],
        ("verify_forwards" if spec_k else "decode_steps"): steps,
        "graph_replays": snap["graph_replays"],
        "first_set_params_ms": first_ms, "graph": eng.capture_ms,
        "peak_pages": stats["peak_pages"],
        "pool_bytes_per_token": _pool_bytes_per_token(cfg),
        "launches": launches, "expected_launches": expect,
        "pages_conserved": _pages_conserved(eng),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "mem_gib": torch.cuda.memory_allocated(dev) / 2 ** 30,
        "first_tokens": [r.tokens[:8] for r in reqs[:2]],
    }
    if spec_k:
        out.update(row_verifies=snap["spec_steps"],
                   acceptance_rate=stats["acceptance_rate"],
                   tokens_per_forward=stats["tokens_per_forward"],
                   rolled_back_pages=stats["rolled_back_pages"])
    replays = snap["graph_replays"] * (1 if spec_k else drain)
    if launches != expect or steps == 0 or replays != steps or \
            snap["prefills"] != len(prompts):
        fail(f"{phase} D {drain}: launches {launches} != {expect} "
             f"({snap['graph_replays']} replays, {steps} steps)")
    if not out["pages_conserved"]:
        fail(f"{phase} D {drain}: pages did not all return to the freelist")
    for r in reqs:
        if not 1 <= len(r.tokens) <= 32 or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"{phase}: request {r.rid}: bad tokens {r.tokens}")
    if not bool(torch.isfinite(eng.logits).all()):
        fail(f"{phase}: non-finite logits after serving")
    if counter is not None:
        out["moe_drops"] = drops = counter.take()
        if drops["prefill"]["forwards"] != len(prompts) or \
                drops["verify" if spec_k else "decode"]["forwards"] != steps:
            fail(f"{phase}: MoE forwards by kind {drops} do not match "
                 f"{len(prompts)} prefills and {steps} steps")
    return eng, out


def mla_serve(torch, np, dev, seed: int, spec_k: int, weights=None):
    """Full-width mla_dense through RequestDriver and the paged engine,
    spec decode off (phase 11) or on (phase 12). ``weights``: a
    ``HeldTree`` (made from --seed when None). Returns (weights, engine,
    prompts, result)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init
    cfg = mla_dense_config()
    torch.cuda.reset_peak_memory_stats(dev)
    init_s = None
    if weights is None:
        t0 = time.time()
        weights = HeldTree(init(cfg, seed=seed, device=dev))
        torch.cuda.synchronize()
        init_s = time.time() - t0
    prompts = phase11_prompts(np, cfg, seed)
    eng, out = serve_run(torch, np, dev, cfg, weights, prompts, seed,
                         phase="mla_spec_serve" if spec_k else "mla_serve",
                         spec_k=spec_k)
    out.update(params=sum(t.numel() for t in _leaves(weights.tree)),
               init_s=init_s,
               **{"llama3.2-3b_pool_bytes_per_token": _pool_bytes_per_token(
                   get_config("llama3.2-3b"))})
    return weights, eng, prompts, out


def mla_parity(torch, np, dev, seed: int):
    """Reduced mla_dense on the card against the CPU, greedy, spec off
    and on, prefill logits, and the radix cache on latent pages."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import forward, init
    cfg = reduced_config(mla_dense_config())
    p_cpu = init(cfg, seed=seed, device="cpu")
    p_gpu = _to(p_cpu, dev)
    rng = np.random.RandomState(seed + 13)
    # prompts that repeat themselves, so the prompt lookup drafts hit
    prompts = []
    for n in rng.randint(8, 40, size=4):
        base = rng.randint(3, cfg.vocab_size, size=(int(n) // 2 + 1,))
        prompts.append(np.concatenate([base, base])[:int(n)].astype(np.int32))
    kw = dict(max_prompt_len=48, max_new=16, num_slots=2, page_size=16,
              temperature=0.0, seed=seed)
    reset_launch_counts()
    plain_gpu = _tokens(serve_paged(cfg, prompts, device=dev, params=p_gpu,
                                   **kw)[0])
    plain_cpu = _tokens(serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                                   **kw)[0])
    # D 3: the card's 3-step graph against the CPU engine at D 3
    d3_gpu = _tokens(serve_paged(cfg, prompts, device=dev, params=p_gpu,
                                drain_interval=3, **kw)[0])
    d3_cpu = _tokens(serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                                drain_interval=3, **kw)[0])
    if not d3_gpu == d3_cpu == plain_gpu:
        fail(f"mla greedy tokens at D 3 differ: card {d3_gpu}, CPU "
             f"{d3_cpu}, card at D 1 {plain_gpu}")
    done_gpu, spec_stats = serve_paged(cfg, prompts, device=dev,
                                       params=p_gpu, spec_k=SPEC_K, **kw)
    spec_gpu = _tokens(done_gpu)
    spec_cpu = _tokens(serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                                  spec_k=SPEC_K, **kw)[0])
    launches = dict(LAUNCHES)
    if not plain_gpu == plain_cpu == spec_gpu == spec_cpu:
        fail(f"mla greedy tokens differ: card {plain_gpu}, CPU {plain_cpu}, "
             f"card spec {spec_gpu}, CPU spec {spec_cpu}")
    toks = torch.from_numpy(rng.randint(3, cfg.vocab_size, size=(2, 48)))
    lg_cpu, _ = forward(p_cpu, cfg, toks)
    lg_gpu, _ = forward(p_gpu, cfg, toks.to(dev))
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    # warm radix tokens == cold at spec off, spec on and D 3; the warm
    # suffix prefill (the MLA verify kernel over cached latent pages)
    n_verify = LAUNCHES["paged_mla_verify_attention"]
    radix = radix_parity(torch, np, dev, cfg, p_cpu, p_gpu, rng, seed,
                         variants=((0, 1), (SPEC_K, 1), (0, 3)))
    radix["radix_verify_launches"] = \
        LAUNCHES["paged_mla_verify_attention"] - n_verify
    out = {"phase": "mla_parity", "arch": cfg.name, "dtype": "float32",
           "r": cfg.kv_lora_rank, "rd": cfg.qk_rope_head_dim,
           "requests": len(prompts), "spec_k": SPEC_K,
           "tokens": sum(len(t) for t in plain_cpu.values()),
           "spec_acceptance_rate": spec_stats["acceptance_rate"],
           "spec_tokens_per_forward": spec_stats["tokens_per_forward"],
           "tokens_identical_card_cpu_spec_nonspec": True,
           "drain_intervals": [1, 3],
           "prefill_logits_max_abs_err": err, "tol": 1e-3,
           "launches_card": launches, "radix": radix}
    if err > 1e-3 or launches["paged_mla_decode_attention"] == 0 or \
            launches["paged_mla_verify_attention"] == 0 or \
            radix["radix_verify_launches"] == 0:
        fail(f"mla parity: {out}")
    return out


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


# the paged decode kernels (GQA, MLA): the stream that runs them is the
# rollout engine's
ENGINE_KERNELS = ("splitl_kernel", "paged_mla_kernel")


def device_busy(torch, prof, window_ms: float) -> dict:
    """Kernel time on each CUDA stream and the union of the kernels'
    intervals over all streams, from a torch.profiler run (copies and
    fills left out), against ``window_ms`` of host wall: the device's busy
    share over the window. Each stream also names its three kernels of
    most device time. The rollout engine's stream is the one running the
    paged decode kernels (``ENGINE_KERNELS``)."""
    spans, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.name().startswith(("Memcpy", "Memset")):
            continue
        sid = e.device_resource_id()
        spans.setdefault(sid, []).append((e.start_ns(), e.end_ns()))
        by = names.setdefault(sid, {})
        by[e.name()[:60]] = by.get(e.name()[:60], 0) + e.end_ns() - \
            e.start_ns()

    def union_ns(iv):
        total, end = 0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total
    busy = union_ns([iv for sp in spans.values() for iv in sp])
    # the rollout engine's stream (the one running the paged decode
    # kernel): its kernels alone on the card against those that ran while
    # another stream's kernels did (kernel time per occurrence, the same
    # mix of kernels in both as decode steps dominate)
    engine = max(names, key=lambda sid: sum(
        t for n, t in names[sid].items()
        if any(k in n for k in ENGINE_KERNELS)))
    others = sorted(iv for sid, sp in spans.items() if sid != engine
                    for iv in sp)
    merged = []
    for a, b in others:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    split = {"alone": [0, 0], "beside_other_streams": [0, 0]}
    for a, b in spans[engine]:
        # the last interval of the others that starts before b: the
        # intervals are disjoint, so only it can reach past a
        i = bisect.bisect_right(starts, b) - 1
        beside = i >= 0 and merged[i][1] > a
        cls = split["beside_other_streams" if beside else "alone"]
        cls[0] += 1
        cls[1] += b - a
    streams = {str(sid): {
        "kernels": len(sp), "kernel_ms": sum(b - a for a, b in sp) / 1e6,
        "busy_ms": union_ns(sp) / 1e6,
        "top": [[n, t / 1e6] for n, t in sorted(
            names[sid].items(), key=lambda kv: -kv[1])[:3]]}
        for sid, sp in spans.items()}
    return {"window_ms": window_ms, "busy_ms": busy / 1e6,
            "busy_share": busy / 1e6 / window_ms,
            # kernel time that ran beside another stream's kernels
            "overlap_ms": sum(v["busy_ms"] for v in streams.values())
            - busy / 1e6, "streams": streams, "engine_stream": str(engine),
            "engine_kernels": {k: {"kernels": n, "ms": t / 1e6,
                                   "us_per_kernel": t / 1e3 / n if n
                                   else None}
                               for k, (n, t) in split.items()}}


def run_profiled(torch, run, iterations: int):
    """``iterations`` training iterations through ``run(n)`` (a scheduler's
    ``run``, which returns the stats of the n it ran): n - 1, then the last
    under torch.profiler (CUDA activity only), from its boundary (its
    weight flip) to the card's end of it. Returns (the stats,
    ``device_busy`` of that window, with the ms the profiler took to start
    and to stop, which the window leaves out)."""
    from torch.profiler import ProfilerActivity, profile
    hist = run(iterations - 1)
    prof = profile(activities=[ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    prof.start()
    t1 = time.perf_counter()
    hist += run(1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prof.stop()
    t3 = time.perf_counter()
    return hist, {**device_busy(torch, prof, (t2 - t1) * 1e3),
                  "profiler_start_ms": (t1 - t0) * 1e3,
                  "profiler_stop_ms": (t3 - t2) * 1e3}


def train_full_width(torch, np, dev, seed: int, iterations: int = 3,
                     drain: int = 1, profile: bool = False, cfg=None,
                     phase: str = "train", hook=None, engine: str = "paged",
                     mode: str = "async", spec_k: int = 0):
    """Phase 6's run (phase 16's with ``cfg`` full-depth f32 mla_dense,
    phase 18's with 3-layer f32 deepseek-v2-lite; phase 20's with
    ``engine="group"``, the group Sampler, in ``mode`` async or
    async_offpolicy at eta 1; phase 21's with ``engine="group"`` and
    ``spec_k``, the SpecSampler). ``profile``: its last iteration runs under
    torch.profiler (``run_profiled``). ``hook(sched, parts)`` runs once the
    pipeline is built, before the first iteration."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.train import build_pipeline
    cfg = train_config() if cfg is None else cfg
    rl = RLConfig(mode=mode, staleness_eta=1, rollout_engine=engine,
                  num_inference_instances=1, cbatch_slots=8,
                  batch_prompts=4, group_size=TRAIN_GROUP,
                  max_prompt_len=TRAIN_PROMPT, max_response_len=TRAIN_RESP,
                  shared_prompt_attention=True, capture_logprobs=True,
                  transfer_wire_dtype="bfloat16", transfer_overlap=True,
                  decode_drain_interval=drain, spec_decode=bool(spec_k),
                  spec_k=spec_k or 4, seed=seed)
    torch.cuda.synchronize()
    start_mem = torch.cuda.memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    # prompt_pad 96: prompts of about 120 tokens, under the 128 cap
    sched, parts = build_pipeline(cfg, rl, seed=seed, prompt_pad=96,
                                  device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    store = parts["pool"].instances[0].store
    flips = []
    # peak device memory per window: set-up, then each iteration from its
    # boundary to the next one's (the last to the end of the run)
    peaks = []
    ensure = sched.transfer.ensure

    def checked_ensure(params, version):
        peaks.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        torch.cuda.reset_peak_memory_stats(dev)
        v = ensure(params, version)
        flips.append([version, _pool_is_bf16_policy(
            torch, store.snapshot()[0], params)])
        return v
    sched.transfer.ensure = checked_ensure
    sampler, calls, verifies = parts["sampler"], [0], [0]
    if sampler is not None:
        generate = sampler.generate

        def counted(*a, **kw):
            calls[0] += 1
            return generate(*a, **kw)
        sampler.generate = counted
    if spec_k:
        # the SpecSampler commits one verify step's rows per call
        commit = sampler._commit_rows

        def verified(*a, **kw):
            verifies[0] += 1
            return commit(*a, **kw)
        sampler._commit_rows = verified
    if hook is not None:
        hook(sched, parts)
    reset_launch_counts()
    busy = None
    if profile:
        hist, busy = run_profiled(torch, sched.run, iterations)
    else:
        hist = sched.run(iterations)
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    launches = dict(LAUNCHES)
    tri = parts["tri"]
    if sampler is None:     # a paged engine's flip waits for the boundary
        staged_ok = store.staged_version == iterations and \
            _pool_is_bf16_policy(torch, store.staged_params(), tri.policy)
    else:                   # the group engine's lands with its buckets
        staged_ok = store.version == iterations and _pool_is_bf16_policy(
            torch, store.snapshot()[0], tri.policy)
    L = cfg.num_layers
    prefills = sum(h.metrics["prefills"] for h in hist)
    steps = sum(h.metrics["decode_steps"] for h in hist)
    # the decode graph's warm-up (at the first flip, in iteration 0's
    # boundary) runs D real decode steps
    warm = sum(h.metrics["warmup_steps"] for h in hist)
    cap, rec = sched.captured_micro_steps, sched.recomputed_micro_steps
    n_leaves = len(sched.transfer.plan.leaves)
    publishes = len(sched.transfer.publishes)
    verify, decode = PAGED_KERNELS[cfg.use_mla]
    other_verify, other_decode = PAGED_KERNELS[not cfg.use_mla]
    no = "0 (no MLA)" if not cfg.use_mla else "0 (MLA: the latent kernel)"
    formula = {
        verify: "0 (spec and prefix cache off)",
        decode: f"L*(decode_steps + warm-up steps) = {L}*({steps} + {warm})",
        other_verify: no, other_decode: no,
        "transfer_cast": f"leaves*publishes = {n_leaves}*{publishes}",
    }
    expect = {name: 0 for name in launches}
    expect.update({verify: 0, decode: L * (steps + warm), other_verify: 0,
                   other_decode: 0, "transfer_cast": n_leaves * publishes})
    if spec_k:
        # one prefill a SpecSampler call, then one verify forward a step
        # through the contiguous verify wrapper
        prefills = calls[0]
        step = "mla_verify_attention" if cfg.use_mla else "verify_attention"
        expect[step] = L * verifies[0]
        formula[step] = f"L*verify steps = {L}*{verifies[0]}"
        formula[decode] = "0 (the group engine)"
    elif sampler is not None:
        # one prefill a Sampler call, then max_response_len - 1 decode
        # forwards through the contiguous wrapper
        prefills = calls[0]
        step = "mla_decode_attention" if cfg.use_mla else "decode_attention"
        expect[step] = L * (rl.max_response_len - 1) * calls[0]
        formula[step] = (f"L*(max_response_len - 1)*Sampler calls = "
                         f"{L}*{rl.max_response_len - 1}*{calls[0]}")
        formula[decode] = "0 (the group engine)"
    if cfg.use_mla:
        # MLA's prefill and training attention is its expanded form in
        # plain PyTorch (autograd for the gradient), as in the JAX package
        for name in ("spa_attention", "spa_attention_bwd"):
            expect[name] = 0
            formula[name] = "0 (MLA: expanded attention in plain PyTorch)"
    else:
        # prefill: L; captured step: ref L + policy L + remat recompute L;
        # recompute step: old L + ref L + policy L + recompute L
        expect["spa_attention"] = L * (prefills + 3 * cap + 4 * rec)
        expect["spa_attention_bwd"] = L * (cap + rec)
        formula["spa_attention"] = (f"L*(prefills + 3*captured + "
                                    f"4*recomputed) = {L}*({prefills} + "
                                    f"3*{cap} + 4*{rec})")
        formula["spa_attention_bwd"] = (f"L*(captured + recomputed) = "
                                        f"{L}*({cap} + {rec})")
    out = {
        "phase": phase, "arch": cfg.name, "layers": L,
        "d_model": cfg.d_model, "dtype": cfg.param_dtype,
        "params": sum(t.numel() for t in _tree_leaves(tri.policy)),
        "mode": rl.mode, "N": rl.batch_prompts, "G": rl.group_size,
        "max_prompt_len": rl.max_prompt_len,
        "max_response_len": rl.max_response_len, "slots": rl.cbatch_slots,
        "spa": True, "capture_logprobs": True, "wire_dtype": "bfloat16",
        "overlap": True, "drain_interval": drain, "setup_s": setup_s,
        "engine": engine, "staleness_eta": rl.staleness_eta,
        "sampler_calls": calls[0], "spec_k": spec_k,
        **({"verify_steps": verifies[0],
            "acceptance_rate": sampler.acceptance_rate} if spec_k else {}),
        "graph": (None if sampler is not None else
                  parts["pool"].instances[0].paged_engine.capture_ms),
        "iterations": [{
            "iteration": h.iteration, "wall_s": h.wall_time,
            "infer_s": h.infer_time, "train_s": h.train_time,
            # host time both sides were busy at once (either side's wait
            # for the card included); device_busy says what the card did
            "overlap_s": h.infer_time + h.train_time - h.wall_time,
            "peak_mem_gib": peak, "profiled": busy is not None and
            h.iteration == iterations - 1,
            "trained_tokens": h.trained_tokens, "tpspd": h.tpspd,
            "sync_gap_s": h.metrics["sync_gap"],
            "staleness": h.max_staleness, "reward_mean": h.reward_mean,
            "prefills": h.metrics["prefills"],
            "decode_steps": h.metrics["decode_steps"],
            "graph_replays": h.metrics["graph_replays"],
            "generated_tokens": h.metrics["generated_tokens"]}
            for h, peak in zip(hist, peaks[1:])],
        "device_busy_last_iteration": busy,
        "version": tri.version, "flips_bf16_bitwise": flips,
        "staged_bf16_bitwise": staged_ok,
        "captured_steps": cap, "recomputed_steps": rec,
        "launches": launches, "expected_launches": expect,
        "launch_formula": formula,
        "publishes": sched.transfer.publishes,
        "start_mem_gib": start_mem,
        "peak_mem_gib": max(peaks), "setup_peak_mem_gib": peaks[0],
        "mem_gib": torch.cuda.memory_allocated(dev) / 2 ** 30,
    }
    if sampler is None:
        # the store holds the engine's copy, not the landed tree: the
        # served weights are resident once (the Sampler copies nothing)
        out["store_holds_engine_tree"] = store.snapshot()[0] is \
            parts["pool"].instances[0].paged_engine.params
        if not out["store_holds_engine_tree"]:
            fail(f"{phase}: the store holds a second copy of the served "
                 f"weights")
    if busy is not None and not busy["busy_ms"] > 0:
        fail(f"{phase}: torch.profiler recorded no kernel in the last "
             f"iteration")
    eta = rl.staleness_eta if mode == "async_offpolicy" else 0
    if any(not 0 <= h.max_staleness <= eta or h.trained_tokens <= 0
           for h in hist):
        fail(f"{phase}: staleness or empty iteration: {out['iterations']}")
    if tri.version != iterations:
        fail(f"{phase}: tri.version {tri.version} != {iterations}")
    if len(flips) != iterations or not all(ok for _, ok in flips) or \
            not staged_ok:
        fail(f"{phase}: pool leaves are not the bf16-rounded policy: {flips}, "
             f"staged {staged_ok}")
    if launches != expect or 0 in (v for k, v in expect.items()
                                   if formula.get(k, "0")[0] != "0"):
        fail(f"{phase}: launches {launches} != expected {expect} ({formula})")
    if not all(bool(torch.isfinite(t).all())
               for t in _tree_leaves(tri.policy)):
        fail(f"{phase}: non-finite parameters after the updates")
    return out


def _parity_batch(np, cfg, seed: int):
    """Phase 7's micro-batch: one SPA-packed row of a 40-token prompt and
    G 8 responses of 5 to 48 tokens, captured logprobs, non-constant
    advantages. Returns (the numpy micro-batch, G)."""
    from repro_torch.core.queue import RolloutGroup
    from repro_torch.core.spa import pack_spa
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
    return pack_spa(group, adv, Lp, T, responses_per_row=G), G


def _perturbed(layers: dict, other: dict) -> dict:
    """Each stacked layer leaf plus 0.05 x ``other``'s (the reference
    weights near the policy)."""
    return {k: _perturbed(v, other[k]) if isinstance(v, dict)
            else v + 0.05 * other[k] for k, v in layers.items()}


def train_parity(torch, np, dev, seed: int, cfg=None):
    """One captured grad step and one Adam update of a reduced model
    (llama unless ``cfg`` says otherwise) on the card against the CPU: for
    llama the SPA kernels against their plain versions; for mla_dense its
    expanded attention in plain PyTorch, which launches no kernel of the
    port."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import init
    from repro_torch.optim.adam import adam_init
    from repro_torch.rl.grpo import (make_apply_update,
                                     make_grad_step_captured, to_device)
    cfg = reduced_config(get_config("llama3.2-3b")) if cfg is None else cfg
    rl = RLConfig()                      # the paper's lr 1e-6, Adam, clip 1
    mb, G = _parity_batch(np, cfg, seed)
    policy = init(cfg, seed=seed, device="cpu")
    other = init(cfg, seed=seed + 1, device="cpu")
    ref = {k: v for k, v in policy.items()}
    ref["layers"] = _perturbed(policy["layers"], other["layers"])
    results = []
    reset_launch_counts()
    for where in ("cpu", dev):
        p, r = _to(policy, where), _to(ref, where)
        grads, metrics = make_grad_step_captured(cfg, rl)(
            p, None, r, to_device(mb, where))
        new, _, _ = make_apply_update(cfg, rl)(p, adam_init(p), grads)
        results.append((_to(grads, "cpu"), _to(new, "cpu"),
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
    want_bwd = 0 if cfg.use_mla else cfg.num_layers
    if not (grad_err <= 2e-4 and param_err <= 2e-4) or \
            launches["spa_attention_bwd"] != want_bwd:
        fail(f"train parity: card and CPU disagree: {out}")
    return out


# ---------------------------------------------------------------------
# phase 14: the device-resident decode loop, D 1 against D 8
# ---------------------------------------------------------------------

LOOP_DRAINS = (1, 8)
LOOP_ROUNDS = 2


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_loop_serve(torch, np, dev, cfg, params, prompts, seed: int,
                      kernel: str, profiled: tuple):
    """Phase 3's (or 11's) workload through engines at D 1 and D 8, in
    interleaved rounds (D 1, D 8, D 1, ...): latency, host wall and device
    time per decode step, graph capture cost. Every request's tokens must
    be identical at every D and in every round; launches must equal L x
    decode steps, made of graph replays; every page must come back.
    ``kernel`` is the decode wrapper, ``profiled`` its CUDA kernels' names
    (their device ms per step is reported)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_requests
    # the engines hold 64 new tokens a row so that the profile windows
    # keep 4 slots busy at D 8; the requests ask for 32, as in phase 3
    kw = dict(max_prompt_len=1024, num_slots=4, page_size=16,
              temperature=0.7)
    L = cfg.num_layers
    engines, setup = {}, {}
    for D in LOOP_DRAINS:
        eng = build_paged_engine(cfg, max_new=64, drain_interval=D,
                                 device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.set_params(params)            # pool, weights, graph capture
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        eng.set_params(params)            # what every later flip costs
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        serve_requests(cfg, prompts[:1], params=params, engine=eng,
                       seed=seed, arrivals=np.zeros(1), max_new=32,
                       **kw)                          # warm-up request
        engines[D] = eng
        setup[D] = {"first_set_params_ms": first_ms, **eng.capture_ms,
                    "weight_copy_ms": copy_ms}
    runs, tokens = [], []
    for rnd in range(LOOP_ROUNDS):
        for D in LOOP_DRAINS:
            eng = engines[D]
            eng.reset_stats()
            torch.cuda.synchronize()
            reset_launch_counts()
            reqs, m, _ = serve_requests(
                cfg, prompts, params=params, engine=eng, seed=seed,
                arrivals=np.zeros(len(prompts)), max_new=32, **kw)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            snap = eng.stats_snapshot()
            steps = snap["decode_steps"]
            if launches[kernel] != L * steps or steps == 0 or \
                    snap["graph_replays"] * D != steps:
                fail(f"device_loop {cfg.name} D {D}: {kernel} launches "
                     f"{launches[kernel]} != {L} x {steps} decode steps "
                     f"({snap['graph_replays']} replays)")
            if not _pages_conserved(eng):
                fail(f"device_loop {cfg.name} D {D}: pages not returned")
            for r in reqs:
                if not 1 <= len(r.tokens) <= 32 or \
                        not all(0 <= t < cfg.vocab_size for t in r.tokens):
                    fail(f"device_loop: request {r.rid}: bad tokens")
            tokens.append([r.tokens for r in reqs])
            prof = profile_decode(torch, np, eng, prompts, seed, steps=16,
                                  max_new=64, kernels=profiled)
            runs.append({
                "round": rnd, "drain_interval": D,
                "tok_per_s": m["tok_per_s"], "makespan_s": m["makespan_s"],
                "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
                "tpot_p50_s": m["tpot_p50_s"], "tpot_p99_s": m["tpot_p99_s"],
                "decode_steps": steps, "graph_replays": snap["graph_replays"],
                "prefills": snap["prefills"],
                "launches": {k: v for k, v in launches.items() if v},
                **{k: prof[k] for k in (
                    "decode_steps_per_window", "wall_ms_per_step",
                    "device_busy_ms_per_step", "device_idle_share_est",
                    "replay_device_ms_per_step", "device_idle_share_replays",
                    "kernel_ms_per_step")}})
    if any(t != tokens[0] for t in tokens):
        fail(f"device_loop {cfg.name}: tokens differ between D 1 and D 8 "
             f"or between rounds")
    summary = {}
    for D in LOOP_DRAINS:
        mine = [r for r in runs if r["drain_interval"] == D]
        summary[D] = {k: _median([r[k] for r in mine]) for k in (
            "tpot_p50_s", "ttft_p50_s", "tok_per_s", "wall_ms_per_step",
            "device_busy_ms_per_step", "replay_device_ms_per_step",
            "device_idle_share_replays")}
    return {"phase": "device_loop", "arch": cfg.name, "layers": L,
            "dtype": cfg.param_dtype, "requests": len(prompts),
            "max_new": 32, "slots": 4, "page": 16, "temperature": 0.7,
            "drain_intervals": list(LOOP_DRAINS), "rounds": LOOP_ROUNDS,
            "tokens_identical_across_d_and_rounds": True,
            "generated_tokens": sum(len(t) for t in tokens[0]),
            "setup": setup, "median_by_d": summary, "runs": runs}


def device_loop_train(torch, np, dev, seed: int):
    """Phase 14(c): phase 6's training run (3 iterations, unprofiled) at
    D 1 and D 8 in interleaved rounds, every check of phase 6 in each.
    Iteration 0 holds the graph's capture; the medians and spreads are
    over the later iterations of every round."""
    keys = ("wall_s", "infer_s", "train_s", "overlap_s", "tpspd",
            "sync_gap_s", "peak_mem_gib", "staleness", "decode_steps",
            "graph_replays")
    runs = []
    for rnd in range(LOOP_ROUNDS):
        for D in LOOP_DRAINS:
            r = train_full_width(torch, np, dev, seed, drain=D)
            runs.append({"round": rnd, "drain_interval": D,
                         "setup_s": r["setup_s"], "graph": r["graph"],
                         "start_mem_gib": r["start_mem_gib"],
                         "peak_mem_gib": r["peak_mem_gib"],
                         "iterations": [{k: it[k] for k in keys}
                                        for it in r["iterations"]]})
            gc.collect()
            torch.cuda.empty_cache()
    summary = {}
    for D in LOOP_DRAINS:
        its = [it for run in runs if run["drain_interval"] == D
               for it in run["iterations"][1:]]
        summary[D] = {k: {"median": _median([it[k] for it in its]),
                          "min": min(it[k] for it in its),
                          "max": max(it[k] for it in its)}
                      for k in ("wall_s", "infer_s", "train_s", "overlap_s",
                                "tpspd", "peak_mem_gib")}
    return {"phase": "device_loop_train", "arch": r["arch"],
            "layers": r["layers"], "dtype": r["dtype"],
            "slots": r["slots"], "N": r["N"], "G": r["G"],
            "drain_intervals": list(LOOP_DRAINS), "rounds": LOOP_ROUNDS,
            "summary_by_d": summary, "runs": runs,
            "launches_last_run": r["launches"],
            "launch_formula_last_run": r["launch_formula"]}


def device_loop(torch, np, dev, seed: int):
    """Phase 14: (a) full-width llama3.2-3b on phase 3's workload and (b)
    full-width mla_dense on phase 11's, each at D 1 and D 8 in interleaved
    rounds; (c) phase 6's training run at D 1 and D 8 in interleaved
    rounds."""
    from repro_torch.configs import get_config
    from repro_torch.models import init
    out = []
    for cfg, rng_seed, kernel, profiled in (
            (get_config("llama3.2-3b"), seed, "paged_decode_attention",
             ("splitl_kernel", "combine_kernel")),
            (mla_dense_config(), seed + 11, "paged_mla_decode_attention",
             MLA_PROFILE_KERNELS)):
        params = init(cfg, seed=seed, device=dev)
        rng = np.random.RandomState(rng_seed)     # phase 3's / 11's prompts
        lens = rng.randint(64, 1025, size=8)
        lens[int(np.argmax(lens))] = 1024
        prompts = [rng.randint(3, cfg.vocab_size, size=(int(n),))
                   .astype(np.int32) for n in lens]
        out.append(device_loop_serve(torch, np, dev, cfg, params, prompts,
                                     seed, kernel, profiled))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out.append(device_loop_train(torch, np, dev, seed))
    return out


# ---------------------------------------------------------------------
# phase 17: deepseek-v2-lite as published (MLA + MoE); reduced MoE parity
# ---------------------------------------------------------------------

MOE_KINDS = ("prefill", "decode", "verify")
# the grad step's forwards (phase 18): the no-grad reference forward, the
# policy forward (autograd recording) and the backward's recompute of each
# checkpointed layer
GRAD_KINDS = ("grad_reference", "grad_policy", "grad_recompute")


class DropCounter:
    """A test-side wrapper, not an engine feature: per forward kind
    (prefill: one row; decode: one token a row; verify: several tokens a
    row; with ``GRAD_KINDS``, the forwards of a grad step that
    ``grad_step`` wraps), the MoE layer calls, the (token, choice) pairs
    routed, those dropped past an expert's capacity, and the distinct
    experts each call routed to (summed over calls), added up in device
    tensors, one a kind (the engine's stream adds to the serving kinds',
    the trainer's to the grad kinds'). The kind is per thread: the rollout
    engine prefills on its own thread while the trainer steps, and the
    backward's recompute runs on autograd's device thread. The adds run
    inside the engine's captured step, so the counter is installed
    before an engine's first ``set_params`` and every replay counts;
    ``take`` reads and zeroes the tensors in place (the graph holds their
    addresses)."""

    def __init__(self, torch, dev, moe_layers: int, kinds=MOE_KINDS):
        import threading
        from repro_torch.models import moe, transformer
        self.torch, self.moe_layers = torch, moe_layers
        self.counts = {k: torch.zeros(4, dtype=torch.int64, device=dev)
                       for k in kinds}
        self._saved = (moe._dispatch_slots, transformer.moe_ffn)
        dispatch, ffn = self._saved
        local = self.local = threading.local()
        counts = self.counts

        def counting_dispatch(top_i, E, C):
            slot, keep = dispatch(top_i, E, C)
            c = counts[local.kind]
            c[0:1].add_(1)                       # scalars: no host copy
            c[1:2].add_(keep.numel())
            c[2:3].add_((~keep).sum())
            used = torch.zeros((E,), dtype=torch.int64, device=top_i.device)
            c[3:4].add_(used.index_fill_(0, top_i.reshape(-1), 1).sum())
            return slot, keep

        def classifying_ffn(params, cfg, x, **kw):
            B, S, _ = x.shape
            if torch._C._current_graph_task_id() != -1:
                local.kind = "grad_recompute"    # inside a backward
            elif getattr(local, "grad_step", False):
                local.kind = ("grad_policy" if torch.is_grad_enabled()
                              else "grad_reference")
            else:
                local.kind = ("decode" if S == 1 else "prefill" if B == 1
                              else "verify")
            return ffn(params, cfg, x, **kw)
        moe._dispatch_slots = counting_dispatch
        transformer.moe_ffn = classifying_ffn

    def grad_step(self, step):
        """``step`` (a scheduler's grad step) with its forwards counted
        under the grad kinds."""
        local = self.local

        def counted(*args):
            local.grad_step = True
            try:
                return step(*args)
            finally:
                local.grad_step = False
        return counted

    def remove(self) -> None:
        from repro_torch.models import moe, transformer
        moe._dispatch_slots, transformer.moe_ffn = self._saved

    def take(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for k, c in self.counts.items():
            calls, pairs, dropped, experts = c.tolist()
            c.zero_()
            fwd = calls // self.moe_layers
            out[k] = {"forwards": fwd, "pairs": pairs,
                      "dropped_pairs": dropped,
                      "dropped_per_forward": dropped / fwd if fwd else 0.0,
                      "distinct_experts_per_layer_call":
                          experts / calls if calls else 0.0}
        self.torch.cuda.synchronize()
        return out


def _step_weight_bytes(cfg, params, B: int) -> dict:
    """Bytes of weights one decode step of B slots reads under the static
    (E, C) dispatch, which runs every expert: every leaf once but the
    embedding table (B rows) and the bf16 LM head, which the engine
    replaces by its own f32 copy (d x V x 4); the routed experts' part
    beside it, and one expert's bytes (what a step that reads only the
    experts it routes to reads of each)."""
    embed = params["embed"]["embedding"]
    total = B * embed.shape[1] * embed.element_size()
    total += cfg.d_model * cfg.vocab_size * 4
    for k, sub in params.items():
        if k != "embed":
            total += sum(t.numel() * t.element_size() for t in _leaves(sub))
    moe = params["layers"]["moe"]
    experts = sum(moe[k].numel() * moe[k].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
    return {"step": total, "experts": experts,
            "one_expert": experts // (moe["w_gate"].shape[0]
                                      * cfg.num_experts),
            "moe_layers": sum(t.numel() * t.element_size()
                              for t in _leaves(moe))}


def routed_experts(np, eng, prompts, seed: int, counter, kw: dict,
                   steps: int = 8) -> dict:
    """The routing of ``profile_decode``'s first window, replayed: the
    same warm-up request, the same requests (keys, slots) and the same
    decode steps, on an engine captured with the drop ``counter``; the
    distinct experts its decode steps routed to, per MoE layer and per
    step summed over the MoE layers."""
    from repro_torch.launch.serve import serve_requests
    serve_requests(eng.cfg, prompts[:1], params=eng.params, engine=eng,
                   seed=seed, arrivals=np.zeros(1), **kw)
    handles = [eng.submit(p, (seed, 1000 + i), max_new=kw["max_new"])
               for i, p in enumerate(prompts[:eng.B])]
    eng.step()              # admission + prefills (+ the first block)
    counter.take()
    n0 = eng.decode_steps
    for _ in range(max(1, steps // eng.drain)):
        eng.step()
    got = counter.take()["decode"]
    n = eng.decode_steps - n0
    while eng.step():
        pass
    if not all(h.done() for h in handles) or got["forwards"] != n:
        fail(f"routed window: {got} over {n} decode steps")
    per_layer = got["distinct_experts_per_layer_call"]
    return {"decode_steps": n, "distinct_experts_per_moe_layer": per_layer,
            "distinct_experts_per_step": per_layer * counter.moe_layers}


def moe_layers_ms(torch, cfg, params, dev, B: int = 4, reps: int = 5):
    """Device ms of the MoE layers alone at the decode shape (B tokens),
    one CUDA graph of every MoE layer's ``moe_ffn`` replayed ``reps``
    times between events (the same kernels a decode step launches for
    them; its dispatch, expert products, combine and shared experts)."""
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import layer
    n_moe = cfg.num_layers - cfg.first_k_dense
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    moes = [layer(params["layers"], i)["moe"] for i in range(n_moe)]

    def run():
        for lp in moes:
            moe_ffn(lp, cfg, x)
    run()                                       # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        run()
    g.replay()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    del g
    return ms


def moe_serve(torch, np, dev, seed: int, smi: str):
    """Phase 17: full-width deepseek-v2-lite-16b as published through the
    paged engine: (d) a profiled decode window on an engine without the
    drop counter, then with it the window's routing replayed, (a) phase
    11's workload at D 1 and D 8, (b) spec decode, (c) phase 15's
    shared-system workload. The weights are one ``HeldTree``, handed from
    engine to engine. Yields the result lines as they come."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_paged_engine, serve_requests
    from repro_torch.models import init
    cfg = get_config("deepseek-v2-lite-16b")
    L = cfg.num_layers
    n_moe = L - cfg.first_k_dense
    torch.cuda.synchronize()
    yield {"phase": "moe_serve_start", "card": smi,
           "memory_allocated_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    weights = HeldTree(init(cfg, seed=seed, device=dev))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(weights.tree))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(weights.tree))
    nbytes = _step_weight_bytes(cfg, weights.tree, B=4)
    prompts = phase11_prompts(np, cfg, seed)
    # (d) the profile, on an engine whose graph holds no counter
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.7)
    eng = build_paged_engine(cfg, device=dev, **kw)
    weights.load(eng)
    serve_requests(cfg, prompts[:1], params=weights.tree, engine=eng,
                   seed=seed, arrivals=np.zeros(1), **kw)  # warm-up request
    prof = profile_decode(torch, np, eng, prompts, seed,
                          kernels=MLA_PROFILE_KERNELS)
    del eng
    gc.collect()
    moe_ms = moe_layers_ms(torch, cfg, weights.tree, dev)
    counter = DropCounter(torch, dev, n_moe)
    try:
        # the window's routing: the experts a step had to read
        eng = build_paged_engine(cfg, device=dev, **kw)
        weights.load(eng)
        routed = routed_experts(np, eng, prompts, seed, counter, kw)
        del eng
        gc.collect()
        step_ms = prof["replay_device_ms_per_step"]
        static_ms = nbytes["step"] / HBM_BYTES_PER_S * 1e3
        routed_bytes = (nbytes["step"] - nbytes["experts"]
                        + routed["distinct_experts_per_step"]
                        * nbytes["one_expert"])
        routed_ms = routed_bytes / HBM_BYTES_PER_S * 1e3
        prof.update({
            "phase": "moe_profile", "arch": cfg.name, "params": n_params,
            "param_bytes": param_bytes, "init_s": init_s,
            "moe_layers": n_moe, "moe_layers_device_ms_per_step": moe_ms,
            "moe_share_of_replay_step": moe_ms / step_ms,
            "routed_window": routed,
            # the step's bound: the weights its routing needs (the
            # non-expert leaves, the experts its tokens chose)
            "routed_weight_read_bytes": routed_bytes,
            "routed_weight_read_bound_ms": routed_ms,
            "replay_step_over_routed_bound": step_ms / routed_ms,
            # what the static (E, C) dispatch reads: every expert
            "static_dispatch_weight_bytes": nbytes["step"],
            "static_dispatch_bound_ms": static_ms,
            "replay_step_over_static_dispatch_bound": step_ms / static_ms,
            "expert_weight_bytes": nbytes["experts"],
            "one_expert_weight_bytes": nbytes["one_expert"],
            "moe_layer_weight_bytes": nbytes["moe_layers"],
            "expert_read_bound_ms": nbytes["experts"] / HBM_BYTES_PER_S * 1e3,
            "mla_kernel_ms_per_step": sum(prof["kernel_ms_per_step"].values()),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
        yield prof
        for phase, drain, spec_k in (("moe_serve", 1, 0), ("moe_serve", 8, 0),
                                     ("moe_spec_serve", 1, SPEC_K)):
            torch.cuda.reset_peak_memory_stats(dev)
            eng, out = serve_run(torch, np, dev, cfg, weights, prompts, seed,
                                 phase=phase, spec_k=spec_k, drain=drain,
                                 counter=counter)
            del eng                 # its pool and head before the next's
            gc.collect()
            yield out
        yield radix_serve(torch, np, dev, cfg, weights, seed,
                          phase="moe_radix_serve", drops=counter.take)
    finally:
        counter.remove()
    del weights
    gc.collect()
    torch.cuda.empty_cache()


class RouteLog:
    """In call order, a paged engine's forwards (their input tokens, then
    their positions) and its MoE layers' routing (the chosen experts, and
    each row's gap between the K-th and (K+1)-th probabilities, then the
    keep mask), written into device buffers with ``index_copy_`` at a
    device counter: the records of a captured step are written at each of
    its replays, with no host copy."""
    FORWARD, MOE, POS, KEEP = 1, 2, 3, 4
    N, W = 1024, 256            # records; values per record

    def __init__(self, torch, dev):
        self.torch = torch
        self.kind = torch.zeros((self.N,), dtype=torch.int64, device=dev)
        self.data = torch.zeros((self.N, self.W), dtype=torch.int64,
                                device=dev)
        self.gap = torch.zeros((self.N, self.W), dtype=torch.float32,
                               device=dev)
        self.n = torch.zeros((1,), dtype=torch.int64, device=dev)

    def add(self, kind: int, values, gap=None) -> None:
        torch, F = self.torch, self.torch.nn.functional
        flat = values.reshape(-1).to(torch.int64)
        if flat.numel() > self.W:
            fail(f"route log: a record of {flat.numel()} values > {self.W}")
        # past N the last record is overwritten and ``read`` fails
        i = self.n.clamp(max=self.N - 1)
        self.kind.index_copy_(0, i, torch.full_like(i, kind))
        self.data.index_copy_(0, i, F.pad(flat, (0, self.W - flat.numel()),
                                          value=-1)[None])
        if gap is not None:
            self.gap.index_copy_(0, i, F.pad(gap.float(),
                                             (0, self.W - gap.numel()))[None])
        self.n.add_(1)

    def read(self) -> list:
        """[(kind, values, gap)] of every record since the last ``read``
        (host arrays; a MoE record's values are its (T, K) choices)."""
        self.torch.cuda.synchronize()
        n = int(self.n)
        if n > self.N:
            fail(f"route log: {n} records overflow its {self.N}")
        kind, data, gap = (t[:n].cpu().numpy() for t in
                           (self.kind, self.data, self.gap))
        self.n.zero_()
        return [(int(k), d[d >= 0], g) for k, d, g in zip(kind, data, gap)]


def _tokens_and_routes(log: list) -> list:
    return [r for r in log if r[0] in (RouteLog.FORWARD, RouteLog.MOE)]


def first_divergence(card: list, cpu: list, K: int, tie_tol: float):
    """The first record at which two ``RouteLog`` reads differ in a
    forward's input tokens or a MoE layer's choices: None where they agree
    throughout; else (index, "tokens") for a forward's input tokens,
    (index, "tie") for a routing flip whose every flipped row had a CPU
    gap within ``tie_tol``, (index, "flip") for any other."""
    import numpy as np
    card, cpu = _tokens_and_routes(card), _tokens_and_routes(cpu)
    for i, ((k1, v1, _), (k2, v2, gap)) in enumerate(zip(card, cpu)):
        if k1 != k2 or v1.shape != v2.shape:
            return i, "tokens"
        if np.array_equal(v1, v2):
            continue
        if k1 == RouteLog.FORWARD:
            return i, "tokens"
        rows = (np.sort(v1.reshape(-1, K), -1)
                != np.sort(v2.reshape(-1, K), -1)).any(-1)
        if not rows.any():
            continue                    # the same sets, in another order
        return i, ("tie" if (gap[:len(rows)][rows] <= tie_tol).all()
                   else "flip")
    return None


def idle_row_report(card: list, cpu: list, K: int) -> dict:
    """Where two ``RouteLog`` reads differ, up to their first differing
    input tokens: the rows whose chosen experts differ and the rows whose
    keep flags differ, each split into idle rows (position >= 2^30, an
    empty slot's row or a verify block's masked token) and live rows."""
    import numpy as np
    out = {"records": 0, "routing_rows": {"idle": 0, "live": 0},
           "keep_rows": {"idle": 0, "live": 0}}
    idle = None
    for (k1, v1, _), (k2, v2, _) in zip(card, cpu):
        if k1 != k2 or v1.shape != v2.shape or (
                k1 == RouteLog.FORWARD and not np.array_equal(v1, v2)):
            break
        out["records"] += 1
        if k1 == RouteLog.POS:
            idle = v2 >= 2 ** 30
        elif k1 in (RouteLog.MOE, RouteLog.KEEP):
            rows = (np.sort(v1.reshape(-1, K), -1)
                    != np.sort(v2.reshape(-1, K), -1)).any(-1) \
                if k1 == RouteLog.MOE else \
                (v1.reshape(-1, K) != v2.reshape(-1, K)).any(-1)
            key = "routing_rows" if k1 == RouteLog.MOE else "keep_rows"
            out[key]["idle"] += int((rows & idle).sum())
            out[key]["live"] += int((rows & ~idle).sum())
    return out


class card_made_rope_freqs:
    """Within it, rotary frequencies are computed on the tensor's device
    (``models/layers.py``'s earlier formula) instead of on the CPU."""

    def __init__(self, torch):
        from repro_torch.models import layers
        self.torch, self.layers = torch, layers

    def __enter__(self):
        torch, self.saved = self.torch, self.layers.rope_freqs

        def on_device(head_dim, theta, device):
            half = head_dim // 2
            return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                                 device=device) / half))
        self.layers.rope_freqs = on_device

    def __exit__(self, *exc):
        self.layers.rope_freqs = self.saved


def moe_parity(torch, np, dev, seed: int):
    """Reduced deepseek-v2-lite and reduced qwen3-moe (2 layers, f32) on
    the card against the CPU, greedy: prefill logits within 1e-3; the
    prefill's chosen experts identical, a flip passing only where the
    K-th and (K+1)-th probabilities are within 1e-5; tokens identical with
    spec off, spec on and at D 3 (a run's tokens are excused only where
    the first difference between the card's and the CPU's records of its
    forwards is a routing flip at such a tie, so that the flip precedes
    the first differing token); each engine kernel's launches against its
    formula."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import paged
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.serve import build_paged_engine, serve_paged
    from repro_torch.models import forward, init, moe
    route, fwd_hidden = moe._route, paged.forward_hidden
    dispatch = moe._dispatch_slots
    active = {}                         # device type -> RouteLog

    def recording_route(params, cfg, xf, want_aux):
        out = route(params, cfg, xf, want_aux)
        log = active.get(xf.device.type)
        if log is not None:
            probs = torch.softmax(xf.float() @ params["router"], dim=-1)
            top = torch.sort(probs, dim=-1, descending=True,
                             stable=True).values
            K = cfg.num_experts_per_tok
            log.add(RouteLog.MOE, out[1], top[:, K - 1] - top[:, K])
        return out

    def recording_dispatch(top_i, E, C):
        slot, keep = dispatch(top_i, E, C)
        log = active.get(top_i.device.type)
        if log is not None:
            log.add(RouteLog.KEEP, keep)
        return slot, keep

    def recording_forward(params, cfg, tokens, **kw):
        log = active.get(tokens.device.type)
        if log is not None:
            log.add(RouteLog.FORWARD, tokens)
            log.add(RouteLog.POS, kw["positions"].expand(tokens.shape))
        return fwd_hidden(params, cfg, tokens, **kw)
    moe._route, paged.forward_hidden = recording_route, recording_forward
    moe._dispatch_slots = recording_dispatch
    logs = {"cuda": RouteLog(torch, dev), "cpu": RouteLog(torch, "cpu")}
    lines = []
    try:
        for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
            cfg = reduced_config(get_config(arch))
            L, K = cfg.num_layers, cfg.num_experts_per_tok
            verify, decode = PAGED_KERNELS[cfg.use_mla]
            p_cpu = init(cfg, seed=seed, device="cpu")
            p_gpu = _to(p_cpu, dev)
            rng = np.random.RandomState(seed + 17)
            prompts = []
            for n in rng.randint(8, 40, size=4):
                base = rng.randint(3, cfg.vocab_size, size=(int(n) // 2 + 1,))
                prompts.append(np.concatenate([base, base])[:int(n)]
                               .astype(np.int32))
            kw = dict(max_prompt_len=48, max_new=16, num_slots=2,
                      page_size=16, temperature=0.0)
            runs, excused, diverged, idle_rows = {}, [], {}, {}

            def one_run(name, over):
                """One serving run on the card and on the CPU: (card
                tokens, CPU tokens, their first differing record, the
                differing rows)."""
                # serve_paged's run, with the graph's warm-up launches and
                # records (at the first set_params) left out
                active.update(logs)
                eng = build_paged_engine(cfg, device=dev, **kw, **over)
                params = eng.set_params(p_gpu)
                torch.cuda.synchronize()
                logs["cuda"].read()
                n0 = dict(LAUNCHES)
                gpu = eng.serve(params, prompts, seed + 1)
                torch.cuda.synchronize()
                got = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
                steps = eng.decode_steps
                del eng, params
                want = {k: 0 for k in LAUNCHES}
                want["spa_attention"] = 0 if cfg.use_mla else L * len(prompts)
                want[verify if "spec_k" in over else decode] = L * steps
                if got != want:
                    fail(f"moe parity {cfg.name} {name}: launches {got} != "
                         f"{want}")
                logs["cpu"].read()
                cpu, _ = serve_paged(cfg, prompts, device="cpu",
                                     params=p_cpu, seed=seed, **kw, **over)
                active.clear()
                card_log, cpu_log = logs["cuda"].read(), logs["cpu"].read()
                return (_tokens(gpu), _tokens(cpu),
                        first_divergence(card_log, cpu_log, K, 1e-5),
                        idle_row_report(card_log, cpu_log, K))
            for name, over in (("plain", {}), ("spec", {"spec_k": SPEC_K}),
                               ("d3", {"drain_interval": 3})):
                *runs[name], first, idle_rows[name] = one_run(name, over)
                diverged[name] = first
                if runs[name][0] != runs[name][1]:
                    if first is None or first[1] != "tie":
                        fail(f"moe parity {cfg.name} {name}: card tokens "
                             f"{runs[name][0]} != CPU {runs[name][1]}; the "
                             f"first differing record is {first} (a "
                             f"routing flip at a tie excuses it)")
                    excused.append(name)
            # the spec and D 3 runs again with rotary frequencies computed
            # on each device (the port's earlier way): a pow on the card
            # rounds some an ulp away from the CPU's, which turns the angle
            # of an idle row (position 2^30) by O(1); which rows then differ
            card_made = {}
            with card_made_rope_freqs(torch):
                for name, over in (("spec", {"spec_k": SPEC_K}),
                                   ("d3", {"drain_interval": 3})):
                    gpu_t, cpu_t, first, rows = one_run(name, over)
                    card_made[name] = {"tokens_identical": gpu_t == cpu_t,
                                       "first_record_difference": first,
                                       "differing_rows": rows}
            toks = torch.from_numpy(rng.randint(3, cfg.vocab_size,
                                                size=(2, 48)))
            prefill = []
            for params, where in ((p_cpu, "cpu"), (p_gpu, dev)):
                log = logs[torch.device(where).type]
                active[torch.device(where).type] = log
                lg, _ = forward(params, cfg, toks.to(where))
                active.clear()
                prefill.append((lg.cpu(), [r for r in log.read()
                                           if r[0] == RouteLog.MOE]))
            (lg_cpu, log_cpu), (lg_gpu, log_gpu) = prefill
            err = float((lg_gpu - lg_cpu).abs().max())
            flips = tied_flips = 0
            for (_, i_cpu, gap), (_, i_gpu, _) in zip(log_cpu, log_gpu):
                rows = (np.sort(i_cpu.reshape(-1, K), -1)
                        != np.sort(i_gpu.reshape(-1, K), -1)).any(-1)
                flips += int(rows.sum())
                tied_flips += int((rows & (gap[:len(rows)] <= 1e-5)).sum())
            line = {"phase": "moe_parity", "arch": cfg.name,
                    "dtype": "float32", "layers": L,
                    "experts": cfg.num_experts, "top_k": K,
                    "requests": len(prompts), "spec_k": SPEC_K,
                    "tokens": sum(len(t) for t in runs["plain"][1].values()),
                    "tokens_identical": [k for k in runs
                                         if k not in excused],
                    "excused_by_a_routing_tie": excused,
                    "first_record_difference": diverged,
                    # the rows whose choices or keep flags differ between
                    # card and CPU, idle (position >= 2^30) or live
                    "differing_rows": idle_rows,
                    "with_card_made_rope_freqs": card_made,
                    "prefill_logits_max_abs_err": err, "tol": 1e-3,
                    "prefill_routing_layers": len(log_cpu),
                    "prefill_routing_flips": flips,
                    "prefill_routing_flips_at_a_tie": tied_flips,
                    "tie_tol": 1e-5}
            if err > 1e-3 or flips != tied_flips or \
                    len(log_cpu) != len(log_gpu) or not log_cpu:
                fail(f"moe parity: {line}")
            lines.append(line)
    finally:
        moe._route, paged.forward_hidden = route, fwd_hidden
        moe._dispatch_slots = dispatch
    return lines


# ---------------------------------------------------------------------
# phase 18: GRPO training of deepseek-v2-lite with its MoE on
# ---------------------------------------------------------------------

# the dense prelude + 2 MoE layers: 1.670 B f32 parameters, about 56 GiB
# at 36 bytes a parameter; 4 layers (2.255 B, about 75.6 GiB) do not fit
MOE_TRAIN_LAYERS = 3


def moe_train_config():
    """deepseek-v2-lite as published (MLA, 64 experts top-6, 2 shared, the
    dense prelude layer), f32, cut to ``MOE_TRAIN_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                               num_layers=MOE_TRAIN_LAYERS,
                               param_dtype="float32", compute_dtype="float32")


def moe_train(torch, np, dev, seed: int, smi: str):
    """Phase 18 (a): phase 6's run (``train_full_width``: its settings,
    checks and prints, the last iteration profiled) on 3-layer full-width
    f32 deepseek-v2-lite with MoE on. Also checks a finite loss and a
    finite, positive aux in every grad step, and prints the (token,
    choice) pairs dropped per forward kind (the engine's prefills and
    decode steps, and the grad steps' reference, policy and recompute
    forwards, from ``DropCounter``) and the kernels per decode step and
    per grad step of the profiled iteration. Yields its lines."""
    cfg = moe_train_config()
    n_moe = cfg.num_layers - cfg.first_k_dense
    torch.cuda.synchronize()
    yield {"phase": "moe_train_start", "card": smi,
           "memory_allocated_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    counter = DropCounter(torch, dev, n_moe, kinds=MOE_KINDS + GRAD_KINDS)
    steps = []                                # (loss, aux) per grad step

    def hook(sched, parts):
        for name in ("grad_step", "grad_step_captured"):
            step = counter.grad_step(getattr(sched, name))

            def recorded(*args, step=step):
                grads, metrics = step(*args)
                steps.append((metrics["loss"], metrics["aux"]))
                return grads, metrics
            setattr(sched, name, recorded)
    try:
        out = train_full_width(torch, np, dev, seed, profile=True, cfg=cfg,
                               phase="moe_train", hook=hook)
        drops = counter.take()
    finally:
        counter.remove()
    losses = [[float(l), float(a)] for l, a in steps]
    its = out["iterations"]
    busy = out["device_busy_last_iteration"]
    engine = busy["engine_stream"]
    last_steps = len(steps) // len(its)
    out.update({
        "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
        "shared_experts": cfg.num_shared_experts,
        "moe_d_ff": cfg.moe_d_ff, "prelude_layers": cfg.first_k_dense,
        "dense_d_ff": cfg.dense_d_ff, "kv_lora_rank": cfg.kv_lora_rank,
        "vocab": cfg.vocab_size, "moe_layers": n_moe,
        "grad_steps": len(steps), "loss_aux_per_grad_step": losses,
        "dropped_pairs": drops,
        # the profiled iteration: the engine stream's kernels (its
        # prefills' eager kernels beside the decode graph's) per decode
        # step; the trainer's streams' kernels (the update and the
        # publish's casts included) per grad step
        "engine_stream_kernels_per_decode_step":
            busy["streams"][engine]["kernels"] / its[-1]["decode_steps"],
        "trainer_kernels_per_grad_step": sum(
            v["kernels"] for sid, v in busy["streams"].items()
            if sid != engine) / last_steps,
        "card": smi})
    yield out
    if not losses or not all(np.isfinite(l) and np.isfinite(a) and a > 0
                             for l, a in losses):
        fail(f"moe_train: a grad step's loss or aux is not finite, or its "
             f"aux not positive: {losses}")
    if out["recomputed_steps"] or not (
            drops["grad_policy"]["forwards"] == len(steps)
            == drops["grad_reference"]["forwards"]
            == drops["grad_recompute"]["forwards"]):
        fail(f"moe_train: grad-step forwards {drops} != {len(steps)} steps")


def _skew_router(tree) -> None:
    """Every token of a reduced MoE tree routed to experts 0 and 1 first,
    as the CPU tests' skewed router: a large first embedding coordinate,
    and each router's first row favouring those experts."""
    tree["embed"]["embedding"][:, 0] += 10.0
    router = tree["layers"]["moe"]["router"]          # (L, d, E)
    router[:, 0, :] = 0.0
    router[:, 0, 0], router[:, 0, 1] = 1.0, 0.5


def moe_train_parity(torch, np, dev, seed: int):
    """Phase 18 (b): reduced deepseek-v2-lite and reduced qwen3-moe (2
    layers, 4 experts top-2, f32) under a skewed router, so that the
    packed micro-batch drops pairs: one captured grad step on the card
    against the CPU on the same SPA-packed micro-batch (phase 7's): loss
    and aux within 1e-5 relative, every gradient leaf within 2e-4 of its
    largest entry, each MoE call's keep mask equal (a difference passes
    only where every row whose choices differ has its K-th and (K+1)-th
    probabilities within 1e-5; counted), and qwen3-moe's SPA kernels
    launched by their formula (forward: reference, policy, recompute;
    backward once a layer). Returns one line an arch."""
    import threading
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import init, moe
    from repro_torch.rl.grpo import make_grad_step_captured, to_device
    route, dispatch = moe._route, moe._dispatch_slots
    local = threading.local()
    side = ["cpu"]                  # whose step the records belong to
    records = []

    def recording_route(params, cfg, xf, want_aux):
        out = route(params, cfg, xf, want_aux)
        top = torch.sort(torch.softmax(xf.float() @ params["router"], -1),
                         dim=-1, descending=True, stable=True).values
        K = cfg.num_experts_per_tok
        local.route = (out[1].detach(), (top[:, K - 1] - top[:, K]).detach())
        return out

    def recording_dispatch(top_i, E, C):
        slot, keep = dispatch(top_i, E, C)
        kind = ("recompute" if torch._C._current_graph_task_id() != -1
                else "policy" if torch.is_grad_enabled() else "reference")
        records.append((side[0], kind, *local.route, keep.clone()))
        return slot, keep
    moe._route, moe._dispatch_slots = recording_route, recording_dispatch
    lines = []
    try:
        for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
            cfg = reduced_config(get_config(arch))
            mb, G = _parity_batch(np, cfg, seed)
            policy = init(cfg, seed=seed, device="cpu")
            with torch.no_grad():
                _skew_router(policy)
            other = init(cfg, seed=seed + 1, device="cpu")
            ref = {k: v for k, v in policy.items()}
            ref["layers"] = _perturbed(policy["layers"], other["layers"])
            results, launches = {}, None
            records.clear()
            for side[0], where in (("cpu", "cpu"), ("card", dev)):
                reset_launch_counts()
                grads, metrics = make_grad_step_captured(cfg, RLConfig())(
                    _to(policy, where), None, _to(ref, where),
                    to_device(mb, where))
                results[side[0]] = (_to(grads, "cpu"), float(metrics["loss"]),
                                    float(metrics["aux"]))
                launches = dict(LAUNCHES)
            (g_cpu, l_cpu, a_cpu), (g_gpu, l_gpu, a_gpu) = (
                results["cpu"], results["card"])
            grad_err = max(float((x - y).abs().max()) /
                           max(float(y.abs().max()), 1e-30)
                           for x, y in zip(_tree_leaves(g_gpu),
                                           _tree_leaves(g_cpu)))
            rec = {w: [r[1:] for r in records if r[0] == w]
                   for w in ("cpu", "card")}
            K = cfg.num_experts_per_tok
            calls, excused, differ = len(rec["cpu"]), 0, 0
            dropped = {}
            for (kind, ti_c, gap, keep_c), (kind_g, ti_g, _, keep_g) in zip(
                    rec["cpu"], rec["card"]):
                dropped[kind] = dropped.get(kind, 0) + int((~keep_c).sum())
                if kind != kind_g:
                    differ += 1
                    continue
                if torch.equal(keep_c, keep_g.cpu()):
                    continue
                rows = (torch.sort(ti_c, -1).values
                        != torch.sort(ti_g.cpu(), -1).values).any(-1)
                if rows.any() and bool((gap[rows] <= 1e-5).all()):
                    excused += 1
                else:
                    differ += 1
            L = cfg.num_layers
            want_fwd = 0 if cfg.use_mla else 3 * L
            want_bwd = 0 if cfg.use_mla else L
            line = {"phase": "moe_train_parity", "arch": cfg.name,
                    "dtype": "float32", "layers": L,
                    "experts": cfg.num_experts, "top_k": K, "G": G,
                    "packed_row_len": int(mb.tokens.shape[1]),
                    "capacity": moe.capacity(int(mb.tokens.size), cfg),
                    "loss_card": l_gpu, "loss_cpu": l_cpu,
                    "aux_card": a_gpu, "aux_cpu": a_cpu,
                    "grad_max_err_rel_to_leaf_max": grad_err,
                    "grad_tol": 2e-4, "loss_aux_rtol": 1e-5,
                    "moe_calls": calls,
                    "moe_calls_card": len(rec["card"]),
                    "dropped_pairs_cpu_by_forward": dropped,
                    "keep_masks_differing": differ,
                    "keep_masks_excused_by_a_tie": excused,
                    "tie_tol": 1e-5, "launches_card": launches,
                    "expected_spa": [want_fwd, want_bwd]}
            lines.append(line)
            rel = [abs(a - b) / max(abs(b), 1e-30)
                   for a, b in ((l_gpu, l_cpu), (a_gpu, a_cpu))]
            if max(rel) > 1e-5 or grad_err > 2e-4 or differ or \
                    len(rec["card"]) != calls or \
                    not dropped.get("policy") or \
                    launches["spa_attention"] != want_fwd or \
                    launches["spa_attention_bwd"] != want_bwd:
                fail(f"moe train parity: card and CPU disagree: {line}")
    finally:
        moe._route, moe._dispatch_slots = route, dispatch
    return lines


# ---------------------------------------------------------------------

# ---------------------------------------------------------------------
# phase 19: the sliding window on the paged plane
# ---------------------------------------------------------------------

WINDOW_SLOTS, WINDOW_PAGE = 4, 16
WINDOW_NEW = 256          # workload (i): the window slides mid-decode
WINDOW_32K_NEW = 64       # workload (ii): the decode_32k context
# decode steps after which the D 1 runs copy the decode kernel's inputs
# (every slot busy): about 8.2k context in (i), 32.8k in (ii)
WINDOW_SNAP_AT = {"i": 128, "ii": 32}
DECODE_32K = 32768        # the decode_32k shape's seq_len (JAX configs)
WINDOW_PROMPT_LENS = (8064, 8190)    # workload (i): 4 prompts between
WINDOW_SYSTEM = 9000      # workload (iii): the shared system prompt
# (iii): warm against cold bf16 logits (the warm suffix prefill runs the
# paged verify kernel where the cold prefill runs SPA). An engine that
# missed keys moves them by O(1) (0.47 on reduced llama on the CPU).
WINDOW_LOGIT_TOL = 0.25


def window_config(name: str):
    """``long_context_variant`` of llama3.2-3b or of mla_dense (window
    8192), at full width and depth, bf16."""
    from repro_torch.configs import get_config, long_context_variant
    base = mla_dense_config() if name == "mla_dense" else get_config(name)
    return long_context_variant(base)


def window_engine(cfg, dev, prompt_lens, max_new: int, **kw):
    """A 4-slot serving engine (1-row groups, page 16, temperature 0.7
    unless ``kw`` says otherwise) whose pool is the windowed admission
    budget of ``prompt_lens``: FIRST_PAGE + the sum over the prompts of
    their window-visible prompt pages + ``_row_budget``. Returns (engine,
    budget pages, the pages the full contexts would take)."""
    from repro_torch.core.paged import FIRST_PAGE, PagedGroupEngine
    args = dict(num_slots=WINDOW_SLOTS, page_size=WINDOW_PAGE,
                max_prompt_len=max(prompt_lens), max_new_tokens=max_new,
                group_size=1, temperature=0.7, capture_logprobs=False,
                device=dev)
    args.update(kw)
    probe = PagedGroupEngine(cfg, num_pages=0, **args)  # geometry only
    budget = full = 0
    for n in prompt_lens:
        j0, n_pp = probe._prompt_page_range(n)
        budget += n_pp - j0 + probe._row_budget(max_new)
        full += n_pp + probe._n_total(max_new)
    eng = PagedGroupEngine(cfg, num_pages=FIRST_PAGE + budget, **args)
    return eng, budget, full


class DecodeSnapshot:
    """Wraps a D 1 engine's ``step``: after the first step that brings
    ``decode_steps`` to ``at`` with every slot busy, copies layer 0's K/V
    pools and positions, the page table and each slot's last query
    position (the windowed decode kernel's inputs at that step)."""

    def __init__(self, torch, eng, at: int):
        self.state = None
        step = eng.step

        def hooked():
            out = step()
            if self.state is None and eng.decode_steps >= at and \
                    len(eng.sched.active_slots()) == eng.B:
                kv = eng.caches["layers"]["kv"]
                with torch.cuda.stream(eng.stream):
                    pools = [kv[n][0].clone() for n in
                             ("k_pages", "v_pages", "pos_pages")]
                torch.cuda.synchronize()
                q_pos = [len(r.group.prompt) + len(r.toks) - 1
                         for r in eng.sched.slot_req]
                self.state = (*pools, eng._ptab.copy(), q_pos)
            return out
        eng.step = hooked


def window_decode_case(torch, np, timer, gen, cfg, snap: DecodeSnapshot):
    """The windowed paged decode kernel on a snapshot of the engine's own
    pool (layer 0, a random bf16 query per row at its row's position):
    against its plain version, with the plain version's time, a page
    gather + SDPA with the window mask as the library call, and the bound
    of the window's K/V: the keys each query sees (at most the window),
    read once, not the context's."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    if snap.state is None:
        fail("window_serve: the decode snapshot was never taken")
    k, v, pos, table, q_pos = snap.state
    window = cfg.sliding_window
    dev = k.device
    B, H, D, Hkv = table.shape[0], cfg.num_heads, cfg.head_dim, \
        cfg.num_kv_heads
    q = torch.randn(B, H, D, generator=gen, device=dev).to(k.dtype)
    table_t = torch.from_numpy(table).to(dev)
    qpos_t = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    kv_pos = pos.cpu().numpy()[table]                    # (B, n_max, page)
    d = np.asarray(q_pos)[:, None, None] - kv_pos.astype(np.int64)
    vis = (d >= 0) & (d < window)
    visible, live = int(vis.sum()), int(vis.any(-1).sum())

    def library():
        kk, vv, kp = gather_pages(k, v, pos, table_t)
        dd = qpos_t[:, None] - kp
        mask = ((dd >= 0) & (dd < window))[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    elt = q.element_size()
    page = pos.shape[1]
    return paged_case(torch, timer, {
        "fn": paged_decode_attention, "plain": paged_decode_attention_plain,
        "args": (q, k, v, pos, table_t, qpos_t), "kw": {"window": window},
        "library": library,
        "bytes": (2 * q.numel() + 2 * visible * Hkv * D) * elt
        + 4 * (live * page + live + B),
        "flops": 4.0 * D * H * visible,
        "info": {"kernel": "paged_decode_attention", "dtype": "bfloat16",
                 "B": B, "window": window, "n_max": int(table.shape[1]),
                 "page": page, "H": H, "Hkv": Hkv, "D": D,
                 "q_pos": [int(p) for p in q_pos],
                 "visible_keys": visible, "live_pages": live,
                 "table_entries": int(table.size)}})


def window_run(torch, np, dev, cfg, weights, prompts, seed: int, *,
               max_new: int, drain: int = 1, spec_k: int = 0,
               snap_at: int = 0):
    """``prompts`` through RequestDriver, all arriving at t = 0, on a
    fresh engine whose pool is the windowed budget (``window_engine``),
    every replay timed with CUDA events. Checks launches (SPA = L x
    prefills for GQA; the family's paged decode kernel L x decode steps,
    or its verify kernel L x verify steps with spec; every other kernel
    0), peak pages within the budget, every page back, the tokens and
    finite logits. Returns (result line, tokens by request, snapshot)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve_requests
    eng, budget, full = window_engine(cfg, dev, [len(p) for p in prompts],
                                      max_new, spec_k=spec_k,
                                      drain_interval=drain)
    weights.load(eng)                          # clone, pool, capture
    snap = DecodeSnapshot(torch, eng, snap_at) if snap_at else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    with eng.time_replays() as pairs:
        reqs, m, stats = serve_requests(
            cfg, prompts, params=weights.tree, engine=eng, seed=seed,
            arrivals=np.zeros(len(prompts)), max_new=max_new,
            max_prompt_len=max(len(p) for p in prompts),
            num_slots=WINDOW_SLOTS, page_size=WINDOW_PAGE, temperature=0.7,
            spec_k=spec_k)
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    snap_ = eng.stats_snapshot()
    L = cfg.num_layers
    steps = snap_["decode_steps"]
    verify, decode = PAGED_KERNELS[cfg.use_mla]
    expect = {name: 0 for name in launches}
    expect["spa_attention"] = 0 if cfg.use_mla else L * len(prompts)
    expect[verify if spec_k else decode] = L * steps
    per_step = 1 if spec_k else drain
    replay_ms = sorted(a.elapsed_time(b) / per_step for a, b in pairs)
    page_bytes = _pool_bytes_per_token(cfg) * WINDOW_PAGE
    from repro_torch.core.paged import FIRST_PAGE
    out = {
        "arch": cfg.name, "layers": L, "window": cfg.sliding_window,
        "dtype": cfg.param_dtype, "drain_interval": drain, "spec_k": spec_k,
        "requests": len(reqs), "prompt_lens": [len(p) for p in prompts],
        "max_new": max_new, "slots": WINDOW_SLOTS, "page": WINDOW_PAGE,
        "temperature": 0.7, "generated_tokens": m["generated_tokens"],
        "tok_per_s": m["tok_per_s"], "makespan_s": m["makespan_s"],
        "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
        "tpot_p50_s": m["tpot_p50_s"], "tpot_p99_s": m["tpot_p99_s"],
        "prefills": snap_["prefills"],
        ("verify_forwards" if spec_k else "decode_steps"): steps,
        "graph_replays": snap_["graph_replays"],
        "replay_ms_per_step_p50": replay_ms[len(replay_ms) // 2],
        "reclaimed_pages": snap_["reclaimed_pages"],
        "peak_pages": eng.peak_pages_used, "budget_pages": budget,
        "full_context_pages": full,
        "pool_gib": (FIRST_PAGE + budget) * page_bytes / 2 ** 30,
        "full_context_gib": (FIRST_PAGE + full) * page_bytes / 2 ** 30,
        "launches": launches, "expected_launches": expect,
        "pages_conserved": _pages_conserved(eng),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
    }
    if spec_k:
        out.update(acceptance_rate=stats["acceptance_rate"],
                   tokens_per_forward=stats["tokens_per_forward"],
                   rolled_back_pages=stats["rolled_back_pages"])
    tag = f"window_serve {cfg.name} D {drain} k {spec_k}"
    if launches != expect or steps == 0 or \
            snap_["graph_replays"] * per_step != steps or \
            snap_["prefills"] != len(prompts):
        fail(f"{tag}: launches {launches} != {expect} "
             f"({snap_['graph_replays']} replays, {steps} steps)")
    if out["reclaimed_pages"] <= 0:
        fail(f"{tag}: the window slid but no page was reclaimed")
    if out["peak_pages"] > budget:
        fail(f"{tag}: peak pages {out['peak_pages']} > budget {budget}")
    if not out["pages_conserved"]:
        fail(f"{tag}: pages did not all return to the freelist")
    for r in reqs:
        if not 1 <= len(r.tokens) <= max_new or \
                not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"{tag}: request {r.rid}: bad tokens {r.tokens[:16]}")
    if not bool(torch.isfinite(eng.logits).all()):
        fail(f"{tag}: non-finite logits after serving")
    del eng
    gc.collect()                          # its pool before the next's
    return out, {r.rid: r.tokens for r in reqs}, snap


class StepLogits:
    """Wraps a D 1 engine's ``step`` (greedy): after each step, copies to
    the host each busy row's next-token logits, keyed (request, t), and a
    row's prompt logits as its t = 0 (requests are the engine's groups,
    numbered in submission order)."""

    def __init__(self, torch, eng):
        self.logits = {}
        step = eng.step

        def hooked():
            out = step()
            torch.cuda.synchronize()
            for s in eng.sched.active_slots():
                row = eng.sched.slot_req[s]
                gid = row.group.gid
                if (gid, 0) not in self.logits:
                    self.logits[gid, 0] = \
                        row.group.prompt_logits.float().cpu().numpy()
                self.logits[gid, len(row.toks)] = \
                    eng.logits[s].float().cpu().numpy()
            return out
        eng.step = hooked


def greedy_flips(np, warm: dict, cold: dict, lw: StepLogits,
                 lc: StepLogits, what: str = "window radix") -> dict:
    """Warm against cold greedy tokens. A request whose tokens differ is
    excused only at its first difference t, and only where the two
    tokens chosen there are within the card's own disagreement: both runs
    hold the same context up to t, and the cold logits' gap between the
    two tokens is at most the largest difference between the warm and the
    cold logits at that step. Returns {request: (t, gap, disagreement)}
    for excused requests; fails on any other difference."""
    flips = {}
    for rid, c in cold.items():
        w = warm[rid]
        if w == c:
            continue
        t = next((i for i, (a, b) in enumerate(zip(w, c)) if a != b),
                 min(len(w), len(c)))
        if (rid, t) not in lw.logits or (rid, t) not in lc.logits or \
                t >= len(w) or t >= len(c):
            fail(f"{what}: request {rid} warm {w[:t + 2]} vs cold "
                 f"{c[:t + 2]}: no logits at the difference")
        a, b = lw.logits[rid, t], lc.logits[rid, t]
        gap = float(b[c[t]] - b[w[t]])
        noise = float(np.abs(a - b).max())
        if not 0 <= gap <= noise <= WINDOW_LOGIT_TOL:
            fail(f"{what}: request {rid} warm {w} != cold {c} at "
                 f"t {t}: cold gap {gap} > the logits' difference {noise}")
        flips[rid] = (t, gap, noise)
    return flips


def window_radix(torch, np, dev, cfg, weights, seed: int):
    """Workload (iii): a 9,000-token system prompt and 8 suffixes of 16 to
    256 tokens through serve_shared (greedy, 32 new tokens). The window
    makes each prompt's first (len - 8192) // 16 pages dead for its
    response (j0); the first, cold, request caches its pages from one
    window before its j0 on (``_cold_first_page``: page 0 here, so the
    tree holds no placeholder; one stands for each page below that), and
    each warm request hits the system prompt's pages from its own j0 up,
    its suffix prefill reading the cached pages a window before its
    suffix. Then the same prompts cold (no cache); warm tokens equal cold
    tokens (a difference is excused only at a tie within the card's own
    warm / cold disagreement, ``greedy_flips``), and the prompts' last
    logits agree within WINDOW_LOGIT_TOL."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_shared
    rng = np.random.RandomState(seed + 19)
    system = rng.randint(3, cfg.vocab_size, size=WINDOW_SYSTEM).astype(
        np.int32)
    sfx_lens = np.linspace(16, 256, 8).astype(int)
    suffixes = [rng.randint(3, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in sfx_lens]
    prompts = [np.concatenate([system, s]) for s in suffixes]
    full = max(len(p) for p in prompts)
    L = cfg.num_layers
    kw = dict(max_prompt_len=full, max_new=32, num_slots=len(prompts),
              page_size=WINDOW_PAGE, temperature=0.0, device=dev)
    eng = build_paged_engine(cfg, prefix_cache=True, **kw)
    weights.load(eng)
    logits_w = StepLogits(torch, eng)
    torch.cuda.synchronize()
    reset_launch_counts()
    done, stats = serve_shared(cfg, system, suffixes, max_prompt_len=full,
                               max_new=32, page_size=WINDOW_PAGE,
                               temperature=0.0, seed=seed,
                               params=weights.tree, engine=eng)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    snap = eng.stats_snapshot()
    verify, decode = PAGED_KERNELS[cfg.use_mla]
    expect = {name: 0 for name in launches}
    expect["spa_attention"] = L * snap["prefills"]
    expect[verify] = L * snap["warm_prefills"]
    expect[decode] = L * snap["decode_steps"]
    j0s = [eng._prompt_page_range(len(p))[0] for p in prompts]
    sys_pages = len(system) // WINDOW_PAGE
    want_hits = sum(sys_pages - j0 for j0 in j0s[1:])
    placeholders = eng.radix.num_nodes - eng.radix.cached_pages
    cold_first = eng._cold_first_page(len(prompts[0]))
    out = {"phase": "window_radix_serve", "arch": cfg.name, "layers": L,
           "window": cfg.sliding_window, "system_tokens": len(system),
           "suffix_lens": [int(n) for n in sfx_lens], "max_new": 32,
           "first_live_page": j0s, "cold_first_page": cold_first,
           "tree_nodes": eng.radix.num_nodes,
           "tree_pages": eng.radix.cached_pages,
           "placeholders": placeholders,
           "cold_prefills": snap["prefills"],
           "warm_prefills": snap["warm_prefills"],
           "prefix_hit_pages": snap["prefix_hit_pages"],
           "expected_hit_pages": want_hits,
           "reclaimed_pages": snap["reclaimed_pages"],
           "tok_per_s": stats["tok_per_s"], "launches": launches,
           "expected_launches": expect,
           "pages_conserved": _pages_conserved(eng)}
    if snap["prefills"] != 1 or snap["warm_prefills"] != len(prompts) - 1 \
            or snap["prefix_hit_pages"] != want_hits:
        fail(f"window radix: expected {want_hits} hit pages from 1 cold "
             f"and {len(prompts) - 1} warm prefills: {out}")
    if placeholders != cold_first or j0s[0] <= 0:
        fail(f"window radix: {placeholders} placeholders, expected the "
             f"{cold_first} pages below the cold prefill's first: {out}")
    if launches != expect or not out["pages_conserved"]:
        fail(f"window radix: launches or pages: {out}")
    warm = {c.request_id: c.response_ids.tolist() for c in done}
    del eng
    gc.collect()
    eng = build_paged_engine(cfg, **kw)
    weights.load(eng)
    logits_c = StepLogits(torch, eng)
    cold = {c.request_id: c.response_ids.tolist()
            for c in eng.serve(weights.tree, prompts, seed + 1)}
    torch.cuda.synchronize()
    del eng
    gc.collect()
    flips = greedy_flips(np, warm, cold, logits_w, logits_c)
    first = max(float(np.abs(logits_w.logits[i, 0]
                             - logits_c.logits[i, 0]).max())
                for i in range(len(prompts)))
    if first > WINDOW_LOGIT_TOL:
        fail(f"window radix: warm and cold prompt logits differ by {first}"
             f" > {WINDOW_LOGIT_TOL}")
    out.update(tokens=sum(len(t) for t in cold.values()),
               prompt_logits_max_abs_diff=first,
               requests_identical=len(cold) - len(flips),
               excused_flips={str(k): v for k, v in flips.items()})
    return out


def window_parity(torch, np, dev, seed: int):
    """Reduced windowed llama and mla_dense (2 layers, f32, window 32,
    page 8) on the card against the CPU, greedy: tokens, reclaimed pages
    and peak pages equal at D 1 and D 3, with spec off and on (k 4); and
    through the radix cache, warm tokens equal cold ones."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    lines = []
    for name in ("llama3.2-3b", "mla_dense"):
        cfg = reduced_config(window_config(name))
        p_cpu = init(cfg, seed=seed, device="cpu")
        p_gpu = _to(p_cpu, dev)
        rng = np.random.RandomState(seed + 23)
        prompts = [rng.randint(3, cfg.vocab_size, size=(int(n),)).astype(
            np.int32) for n in (20, 37, 51, 64)]
        kw = dict(max_prompt_len=64, max_new=48, num_slots=2, page_size=8,
                  temperature=0.0, seed=seed)
        runs = []
        for drain, spec_k in ((1, 0), (3, 0), (1, SPEC_K), (3, SPEC_K)):
            got = {}
            for where, params in (("cpu", p_cpu), (dev, p_gpu)):
                done, stats = serve_paged(cfg, prompts, device=where,
                                          params=params, drain_interval=drain,
                                          spec_k=spec_k, **kw)
                got[str(where)] = (_tokens(done), stats["reclaimed_pages"],
                                   stats["peak_pages"])
            cpu, card = got["cpu"], got[str(dev)]
            if cpu != card or cpu[1] <= 0:
                fail(f"window parity {name} D {drain} k {spec_k}: card "
                     f"{card[1:]} vs CPU {cpu[1:]}, tokens equal "
                     f"{card[0] == cpu[0]}")
            runs.append({"drain_interval": drain, "spec_k": spec_k,
                         "reclaimed_pages": cpu[1], "peak_pages": cpu[2],
                         "tokens": sum(len(t) for t in cpu[0].values())})
        # the radix cache: a 40-token system prompt and suffixes of 10 to
        # 20 tokens, whose first suffix query sees pages below its first
        # live page; warm on the card == cold on the card == warm on the
        # CPU
        system = list(rng.randint(3, cfg.vocab_size, size=40))
        shared = [np.asarray(system + list(rng.randint(
            3, cfg.vocab_size, size=n)), np.int32) for n in (10, 14, 20)]
        got = {}
        for where, params, prefix in ((dev, p_gpu, True), (dev, p_gpu, False),
                                      ("cpu", p_cpu, True)):
            done, stats = serve_paged(cfg, shared, device=where,
                                      params=params, prefix_cache=prefix,
                                      **kw)
            got[str(where), prefix] = _tokens(done)
            if prefix and not stats["prefix_hit_pages"]:
                fail(f"window parity {name}: the radix cache never hit")
        if len({str(t) for t in got.values()}) != 1:
            fail(f"window parity {name}: radix warm / cold tokens differ: "
                 f"{got}")
        lines.append({"phase": "window_parity", "arch": cfg.name,
                      "window": cfg.sliding_window, "dtype": "float32",
                      "runs": runs, "tokens_identical": True,
                      "radix_warm_equals_cold": True})
    return lines


def window_serve(torch, np, dev, seed: int, timer, smi: str):
    """Phase 19: long_context_variant llama3.2-3b at full width (28
    layers, bf16, window 8192) on workloads (i) and (ii) and the radix
    cache (iii), the windowed mla_dense on (i), the windowed decode
    kernel at both contexts, then card against CPU on the reduced
    windowed configs. Yields its lines; the "kernels" line reads the
    ones tagged "kernel_case"."""
    from repro_torch.models import init
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    cfg = window_config("llama3.2-3b")
    rng = np.random.RandomState(seed + 19)
    lens_i = np.linspace(*WINDOW_PROMPT_LENS, WINDOW_SLOTS).astype(int)
    prompts_i = [rng.randint(3, cfg.vocab_size, size=int(n)).astype(np.int32)
                 for n in lens_i]
    prompts_ii = [rng.randint(3, cfg.vocab_size, size=DECODE_32K).astype(
        np.int32) for _ in range(WINDOW_SLOTS)]
    torch.cuda.synchronize()
    t0 = time.time()
    weights = HeldTree(init(cfg, seed=seed, device=dev))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    toks, snaps = {}, {}
    for drain, spec_k in ((1, 0), (8, 0), (1, SPEC_K)):
        line, toks[drain, spec_k], snap = window_run(
            torch, np, dev, cfg, weights, prompts_i, seed,
            max_new=WINDOW_NEW, drain=drain, spec_k=spec_k,
            snap_at=WINDOW_SNAP_AT["i"] if (drain, spec_k) == (1, 0) else 0)
        if snap is not None:
            snaps["i"] = snap
        yield {"phase": "window_serve", "workload": "i", "init_s": init_s,
               **line}
    if toks[1, 0] != toks[8, 0]:
        fail("window_serve: sampled tokens differ between D 1 and D 8")
    line, _, snaps["ii"] = window_run(
        torch, np, dev, cfg, weights, prompts_ii, seed,
        max_new=WINDOW_32K_NEW, snap_at=WINDOW_SNAP_AT["ii"])
    yield {"phase": "window_serve", "workload": "ii_decode_32k", **line}
    yield window_radix(torch, np, dev, cfg, weights, seed)
    for ctx, snap in snaps.items():
        case = window_decode_case(torch, np, timer, gen, cfg, snap)
        if not case["ok"]:
            fail(f"window_serve: the windowed decode kernel disagrees with "
                 f"its plain version at context {ctx}: {case}")
        yield {"phase": "window_kernel", "kernel_case": ctx, **case}
    del weights, snaps
    gc.collect()
    torch.cuda.empty_cache()
    mla = window_config("mla_dense")
    weights = HeldTree(init(mla, seed=seed, device=dev))
    # the same lengths, drawn from mla_dense's smaller vocabulary
    prompts_mla = [rng.randint(3, mla.vocab_size, size=len(p)).astype(
        np.int32) for p in prompts_i]
    line, _, _ = window_run(torch, np, dev, mla, weights, prompts_mla, seed,
                            max_new=WINDOW_NEW)
    yield {"phase": "window_serve", "workload": "i", **line}
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    yield from window_parity(torch, np, dev, seed)


# ---------------------------------------------------------------------
# phase 20: the group-at-a-time Sampler on a dense (and ring) cache
# ---------------------------------------------------------------------

class plain_kernels:
    """Within the block, models/attention.py calls the plain versions in
    place of the SPA wrapper and the contiguous decode and verify
    wrappers: the same model path, eager PyTorch on the card, no kernel
    of the port."""

    def __init__(self):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels.spa_attention import chunked_attention
        from repro_torch.models import attention

        def spa(q, k, v, q_pos, kv_pos, q_seg, kv_seg, *, scale=None,
                window=None, chunk_size=512):
            return chunked_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                     window=window, chunk_size=chunk_size,
                                     scale=scale)
        self.mod = attention
        self.swap = {"spa_attention": spa,
                     "decode_attention": da.decode_attention_plain,
                     "verify_attention": da.verify_attention_plain,
                     "mla_decode_attention": da.mla_decode_attention_plain,
                     "mla_verify_attention": da.mla_verify_attention_plain}
        self.saved = {}

    def __enter__(self):
        for name, fn in self.swap.items():
            self.saved[name] = getattr(self.mod, name)
            setattr(self.mod, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


class SamplerLogits:
    """Within the block, every Sampler step's logits (B, V), copied to the
    host, keyed (row, t) as ``StepLogits`` keys an engine's, so that
    ``greedy_flips`` can read them."""

    def __init__(self, torch):
        from repro_torch.rl import rollout
        self.mod, self.logits = rollout, {}
        self.orig = rollout._sample_token_rows
        self.t = 0

        def recorded(logits, *a, **kw):
            host = logits.float().cpu().numpy()
            for b in range(host.shape[0]):
                self.logits[b, self.t] = host[b]
            self.t += 1
            return self.orig(logits, *a, **kw)
        self.recorded = recorded

    def __enter__(self):
        self.mod._sample_token_rows = self.recorded
        return self

    def __exit__(self, *exc):
        self.mod._sample_token_rows = self.orig


def _rows(out) -> dict:
    """A RolloutBatch's rows up to their lengths, keyed by row."""
    ids, lens = out.response_ids.tolist(), out.response_len.tolist()
    return {b: ids[b][: lens[b]] for b in range(len(ids))}


def sampler_serve(torch, np, dev, cfg, seed: int, smi: str):
    """Phase 20 (a) on one model: ``serve_batch`` (the group Sampler, no
    capture, temperature 0.7) over phase 3's 8 prompts x SAMPLER_NEW new
    tokens in one call of B 8, after a warm-up call of one request (cuBLAS
    handles, the allocator); then the same call with one new token (the
    prefill alone), whose wall, taken from the first's, gives the wall
    per decode step. The counts are reset just before the measured
    call and read just after: the contiguous decode wrapper (GQA) or the
    contiguous MLA wrapper launches layers x (SAMPLER_NEW - 1) times (the
    last step's forward, whose logits nothing reads, is not run), the SPA
    forward (GQA) layers times, every other kernel 0. Then greedy tokens of
    the first 4 requests against a second, eager run with the plain
    versions on the card (``plain_kernels``): a difference is excused only
    at a tie (``greedy_flips``)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init
    from repro_torch.rl.rollout import Sampler
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    lens, prompts = phase3_prompts(np, cfg, seed)
    kw = dict(max_prompt_len=SAMPLER_LP, max_new=SAMPLER_NEW,
              temperature=0.7, seed=seed, device=dev, params=params)
    serve_batch(cfg, prompts[:1], **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    out, stats = serve_batch(cfg, prompts, **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    L = cfg.num_layers
    step = "mla_decode_attention" if cfg.use_mla else "decode_attention"
    expect = {name: 0 for name in launches}
    expect[step] = L * (SAMPLER_NEW - 1)
    expect["spa_attention"] = 0 if cfg.use_mla else L
    if launches != expect:
        fail(f"sampler_serve {cfg.name}: launches {launches} != {expect}")
    rows = _rows(out)
    for b, r in rows.items():
        if not 1 <= len(r) <= SAMPLER_NEW or \
                not all(0 <= t < cfg.vocab_size for t in r):
            fail(f"sampler_serve {cfg.name}: row {b} bad tokens {r}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # where the wall goes: the same call with one new token runs the
    # prefill and no decode forward
    _, only = serve_batch(cfg, prompts, **{**kw, "max_new": 1})
    # greedy: the kernels against the plain versions, both on the card
    greedy = Sampler(cfg, SAMPLER_LP, SAMPLER_NEW, temperature=0.0,
                     capture_logprobs=False, device=dev)
    with SamplerLogits(torch) as lk:
        got = _rows(greedy.generate(params, prompts[:4], seed))
    with plain_kernels(), SamplerLogits(torch) as lp:
        want = _rows(greedy.generate(params, prompts[:4], seed))
    flips = greedy_flips(np, got, want, lk, lp, what=f"sampler {cfg.name}")
    del params
    return {
        "phase": "sampler_serve", "arch": cfg.name, "layers": L,
        "dtype": cfg.param_dtype, "card": smi, "init_s": init_s,
        "requests": len(prompts), "B": len(prompts),
        "prompt_lens": [int(n) for n in lens], "max_prompt_len": SAMPLER_LP,
        "max_new": SAMPLER_NEW, "temperature": 0.7,
        "wall_s": stats["wall_s"], "generated_tokens":
        stats["generated_tokens"], "tok_per_s": stats["tok_per_s"],
        "prefill_call_s": only["wall_s"],
        "decode_ms_per_step": (stats["wall_s"] - only["wall_s"])
        / (SAMPLER_NEW - 1) * 1e3,
        "peak_mem_gib": peak, "launches": launches,
        "expected_launches": expect,
        "launch_formula": {step: f"L*(max_new - 1) = {L}*{SAMPLER_NEW - 1}"
                           " (the last step's forward is not run)",
                           "spa_attention": "0 (MLA: expanded prefill)"
                           if cfg.use_mla else f"L = {L} (one prefill)"},
        "greedy_vs_plain_requests": 4,
        "greedy_equal": sum(got[b] == want[b] for b in got),
        "greedy_tie_flips": {str(b): v for b, v in flips.items()},
        "first_tokens": [rows[b][:8] for b in range(2)],
    }


def _sampler_parity_cfgs():
    """Phase 20 (c)'s reduced f32 configs: llama, llama with a window of 8
    (prompts longer than it ride the ring), mla_dense and
    deepseek-v2-lite with MoE on."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    llama = reduced_config(get_config("llama3.2-3b"))
    return {"llama": llama,
            "llama_window8": dataclasses.replace(llama, sliding_window=8),
            "mla_dense": reduced_config(mla_dense_config()),
            "deepseek_moe": reduced_config(get_config(
                "deepseek-v2-lite-16b"))}


def sampler_parity(torch, np, dev, seed: int):
    """Phase 20 (c): on each reduced f32 model the Sampler on the card
    (kernels) against the CPU (plain versions), greedy: tokens and lengths
    equal, logprobs within 1e-4 (the paged card tests' bar), the step
    wrapper launched layers x (max_new - 1) times; then sampled at
    temperature 1 under one key, every row's tokens equal to the port's
    paged engine's row on the card (MoE off: its capacity follows each
    forward's token count, which the two engines size differently)."""
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import init
    from repro_torch.rl.rollout import Sampler
    rng = np.random.RandomState(seed + 20)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (5, 19, 33, 40)]
    Lp, T, G = 40, 12, 4
    out = {}
    for name, cfg in _sampler_parity_cfgs().items():
        p_cpu = init(cfg, seed=seed, device="cpu")
        p_gpu = _to(p_cpu, dev)
        runs = []
        for where, params in ((dev, p_gpu), ("cpu", p_cpu)):
            n0 = dict(LAUNCHES)
            o = Sampler(cfg, Lp, T, temperature=0.0, device=where).generate(
                params, prompts, seed)
            torch.cuda.synchronize()
            runs.append([t.cpu() for t in o])
            n = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
            step = "mla_decode_attention" if cfg.use_mla else \
                "decode_attention"
            if where == dev and n[step] != cfg.num_layers * (T - 1):
                fail(f"sampler_parity {name}: {step} launched {n[step]} "
                     f"!= {cfg.num_layers} x {T - 1}")
        (gi, gl, gp), (ci, cl, cp) = runs
        lp_err = float((gp - cp).abs().max())
        line = {"tokens_equal": bool(torch.equal(gi, ci)),
                "lengths_equal": bool(torch.equal(gl, cl)),
                "logprob_max_err": lp_err,
                "logprobs_close": bool(torch.allclose(gp, cp, atol=1e-4,
                                                      rtol=1e-4))}
        if not all(v for k, v in line.items() if k != "logprob_max_err"):
            fail(f"sampler_parity {name}: card != CPU: {line}")
        if not cfg.is_moe:
            key = (seed, 20)
            group = Sampler(cfg, Lp, T, temperature=1.0, device=dev
                            ).generate(p_gpu, [prompts[2]] * G, key)
            eng = PagedGroupEngine(
                cfg, num_slots=G, page_size=8, num_pages=0,
                max_prompt_len=Lp, max_new_tokens=T, group_size=G,
                temperature=1.0, device=dev)
            eng.set_params(p_gpu)
            h = eng.submit(prompts[2], key)
            while eng.step():
                pass
            torch.cuda.synchronize()
            paged = h.result(timeout=0)
            same = _rows(group) == {b: r.tolist() for b, r in
                                    enumerate(h.host_rows())}
            line["sampled_equal_paged_engine"] = bool(
                same and torch.equal(group.response_len.cpu(),
                                     paged.response_len))
            if not line["sampled_equal_paged_engine"]:
                fail(f"sampler_parity {name}: sampled rows {_rows(group)} "
                     f"!= the paged engine's {h.host_rows()}")
            del eng
        out[name] = line
    return {"phase": "sampler_parity", "prompt_lens": [5, 19, 33, 40],
            "max_prompt_len": Lp, "max_new": T, "G": G, "models": out}


def group_sampler(torch, np, dev, seed: int, smi: str):
    """Phase 20, one line a part: (a) sampler_serve on full-width
    llama3.2-3b and mla_dense in bf16; (b) phase 6's training run on the
    group engine, 2 iterations of async (staleness 0), then 3 of
    async_offpolicy at eta 1 (each group's staleness at most 1), the last
    iteration profiled; (c) sampler_parity."""
    from repro_torch.configs import get_config
    for cfg in (get_config("llama3.2-3b"), mla_dense_config()):
        yield sampler_serve(torch, np, dev, cfg, seed, smi)
    for mode, iterations in (("async", 2), ("async_offpolicy", 3)):
        gc.collect()
        torch.cuda.empty_cache()
        yield {**train_full_width(
            torch, np, dev, seed, iterations=iterations,
            profile=mode != "async", engine="group", mode=mode,
            phase="sampler_train"), "card": smi}
    gc.collect()
    torch.cuda.empty_cache()
    yield sampler_parity(torch, np, dev, seed)


# ---------------------------------------------------------------------
# phase 21: the dense-cache slot and spec engines
# ---------------------------------------------------------------------

SLOT_SLOTS = 4            # phase 21 (a): 4 slots for phase 3's 8 requests


class DraftCounter:
    """Counts a resident draft model's device calls (its prefills, its
    feeds by width: one token a row goes through the contiguous decode
    wrapper, more through the verify wrapper, and its k-step blocks with
    their steps) and records the stream each call was issued on."""

    def __init__(self, torch, draft):
        import collections
        self.n = collections.Counter()
        self.streams = set()
        for name in ("_prefill", "_feed", "_kstep"):
            setattr(draft, name, self._wrap(torch, name,
                                            getattr(draft, name)))

    def _wrap(self, torch, name, fn):
        def counted(*a, **kw):
            self.streams.add(torch.cuda.current_stream().cuda_stream)
            if name == "_feed":
                self.n["feed_multi" if a[0].shape[1] > 1 else
                       "feed_one"] += 1
            elif name == "_kstep":
                self.n["kstep_blocks"] += 1
                self.n["kstep_steps"] += a[-1]
            else:
                self.n["prefills"] += 1
            return fn(*a, **kw)
        return counted


def draft_launches(cfg, n: dict) -> dict:
    """The draft model's launches by wrapper from its call counts: its
    k-step blocks and one-token feeds through the contiguous decode
    wrapper, wider feeds through the verify wrapper, its prefills (GQA)
    through SPA, each once a draft layer."""
    from repro_torch.spec.draft import draft_config
    Ld = draft_config(cfg).num_layers
    mla = cfg.use_mla
    return {"mla_decode_attention" if mla else "decode_attention":
            Ld * (n["kstep_steps"] + n["feed_one"]),
            "mla_verify_attention" if mla else "verify_attention":
            Ld * n["feed_multi"],
            "spa_attention": 0 if mla else Ld * n["prefills"]}


class VerifyLogits:
    """Within the block, a spec engine's verify logits: for each row of
    each verify step, the target logits its committed tokens were chosen
    from (lanes 0 .. count - 1, the ones whose context the commit kept),
    copied to the host and keyed (request, t) as ``StepLogits`` keys an
    engine's, so that ``greedy_flips`` can read them. Request rid of a
    call keyed ``key`` is the row seeded ``_request_seed(key, rid)``
    (the slot engine's and the paged engine's ``serve``'s). It wraps
    ``verify_block`` where ``module`` calls it, keeping a reference to its
    logits, row seeds and committed lengths (a captured step's are the
    graph's own memory, rewritten by each replay, so an engine must be
    built and loaded inside the block), and the step's readback
    (``drain_verify`` where ``drain_module`` calls it, or the paged
    engine's ``_drain_verify`` given by ``eng``) to copy them out once the
    counts are read. A key keeps its first record: a slot left idle
    after its request finished re-verifies under that request's seed at
    length 0, after every t of it was recorded."""

    def __init__(self, torch, module, key, n_requests: int,
                 drain_module=None):
        from repro_torch.core.cbatch import _request_seed
        self.torch, self.mod, self.drain_mod = torch, module, drain_module
        self.rid = {_request_seed(key, r): r for r in range(n_requests)}
        self.logits, self.held, self.saved = {}, None, {}

    def _read(self, count) -> None:
        p, seeds, rc = self.held
        host = p.float().cpu().numpy()
        for b, (seed, c, n) in enumerate(zip(seeds.tolist(), rc.tolist(),
                                             count)):
            rid = self.rid.get(seed)
            for j in range(n if rid is not None else 0):
                self.logits.setdefault((rid, c + j), host[b, j])

    def __enter__(self):
        orig = self.mod.verify_block

        def held(p, draft, seeds, rc, **kw):
            self.held = (p, seeds, rc)
            return orig(p, draft, seeds, rc, **kw)
        self.saved[self.mod, "verify_block"] = orig
        self.mod.verify_block = held
        if self.drain_mod is not None:
            drain = self.drain_mod.drain_verify

            def drained(*a):
                out = drain(*a)
                self._read(out[2])
                return out
            self.saved[self.drain_mod, "drain_verify"] = drain
            self.drain_mod.drain_verify = drained
        return self

    def engine(self, eng):
        """Read ``eng``'s (the paged engine's) verify steps too."""
        drain = eng._drain_verify

        def drained(out, ready):
            res = drain(out, ready)
            self._read(res[2])
            return res
        eng._drain_verify = drained
        return eng

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def slot_expect(cfg, eng, launches: dict, counts=None):
    """Phase 21 (a)'s launch formulas from the engine's own step count
    (``eng.steps``: device decode steps, or verify steps with spec) and
    admissions, plus a draft model's calls. Returns (expect, formula)."""
    L, mla = cfg.num_layers, cfg.use_mla
    decode = "mla_decode_attention" if mla else "decode_attention"
    verify = "mla_verify_attention" if mla else "verify_attention"
    expect = {name: 0 for name in launches}
    formula = {}
    if eng.spec_k:
        expect[verify] = L * eng.steps
        formula[verify] = f"L*verify steps = {L}*{eng.steps}"
    else:
        expect[decode] = L * eng.steps
        formula[decode] = f"L*decode device steps = {L}*{eng.steps}"
    expect["spa_attention"] = 0 if mla else L * 8
    formula["spa_attention"] = "0 (MLA: expanded prefill)" if mla else \
        f"L*admissions = {L}*8"
    if counts is not None:
        for name, n in draft_launches(cfg, counts.n).items():
            expect[name] += n
            formula[name] = formula.get(name, "0") + \
                f" + draft layers x calls = {n}"
    return expect, formula


def cbatch_serve(torch, np, dev, cfg, seed: int, smi: str):
    """Phase 21 (a) on one model: ContinuousBatchingSampler serving phase
    3's 8 prompts x 32 new tokens through 4 slots, greedy, at D 1, D 8,
    spec k 4 with the prompt-lookup draft and (GQA only) spec k 4 with the
    resident draft model; launches checked against the engine's step
    count, D 1 == D 8 bitwise, spec tokens of 4 requests against a run of
    the plain versions on the card (a difference excused only at a tie
    within the two runs' own logit difference at that step,
    ``greedy_flips`` on ``VerifyLogits``)."""
    from repro_torch.core.cbatch import ContinuousBatchingSampler
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import init
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    params = init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    lens, prompts = phase3_prompts(np, cfg, seed)
    kw = dict(num_slots=SLOT_SLOTS, max_prompt_len=SAMPLER_LP,
              max_new_tokens=SAMPLER_NEW, temperature=0.0, device=dev)
    ContinuousBatchingSampler(cfg, **kw).run(params, prompts[:1], seed)
    runs = {"d1": dict(), "d8": dict(drain_interval=8),
            "spec4": dict(spec_k=SPEC_K)}
    if not cfg.use_mla:
        runs["spec4_model_draft"] = dict(spec_k=SPEC_K, spec_draft="model")
    lines, tokens = [], {}
    for name, extra in runs.items():
        eng = ContinuousBatchingSampler(cfg, **kw, **extra)
        counts = DraftCounter(torch, eng._draft) \
            if extra.get("spec_draft") == "model" else None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.time()
        done = eng.run(params, prompts, seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        expect, formula = slot_expect(cfg, eng, launches, counts)
        if launches != expect:
            fail(f"cbatch_serve {cfg.name} {name}: launches {launches} != "
                 f"{expect} ({formula})")
        tokens[name] = _tokens(done)
        n_tok = sum(len(t) for t in tokens[name].values())
        if len(done) != len(prompts) or not all(
                1 <= len(t) <= SAMPLER_NEW and 0 <= min(t) and
                max(t) < cfg.vocab_size for t in tokens[name].values()):
            fail(f"cbatch_serve {cfg.name} {name}: bad completions")
        line = {"run": name, "wall_s": wall, "generated_tokens": n_tok,
                "tok_per_s": n_tok / wall, "engine_steps": eng.steps,
                "completion_order": [c.request_id for c in done],
                "peak_mem_gib": torch.cuda.max_memory_allocated(dev)
                / 2 ** 30, "launches": launches,
                "expected_launches": expect, "launch_formula": formula}
        if eng.spec_k:
            line.update(verify_steps=eng.steps, row_verifies=eng.spec_steps,
                        acceptance_rate=eng.acceptance_rate,
                        tokens_per_forward=n_tok / eng.spec_steps)
        if counts is not None:
            line["draft_calls"] = dict(counts.n)
        lines.append(line)
        del eng
    if tokens["d1"] != tokens["d8"]:
        fail(f"cbatch_serve {cfg.name}: D 1 tokens != D 8 tokens")
    # spec k 4, 4 requests: the kernels against the plain versions
    from repro_torch.core import cbatch as cbatch_mod
    from repro_torch.spec import sampler as spec_mod
    sub = list(prompts[:4])
    spec = ContinuousBatchingSampler(cfg, **kw, spec_k=SPEC_K)
    with VerifyLogits(torch, spec_mod, seed, 4, cbatch_mod) as lk:
        got = _tokens(spec.run(params, sub, seed))
    with plain_kernels(), VerifyLogits(torch, spec_mod, seed, 4,
                                       cbatch_mod) as lp:
        want = _tokens(spec.run(params, sub, seed))
    torch.cuda.synchronize()
    flips = greedy_flips(np, got, want, lk, lp,
                         what=f"cbatch_serve {cfg.name} spec vs plain")
    spec_vs_d1 = sum(tokens["spec4"][r] == tokens["d1"][r]
                     for r in tokens["d1"])
    del params, spec
    return {
        "phase": "cbatch_serve", "arch": cfg.name, "layers": cfg.num_layers,
        "dtype": cfg.param_dtype, "card": smi, "init_s": init_s,
        "requests": len(prompts), "slots": SLOT_SLOTS,
        "prompt_lens": [int(n) for n in lens],
        "max_prompt_len": SAMPLER_LP, "max_new": SAMPLER_NEW,
        "temperature": 0.0, "spec_k": SPEC_K, "runs": lines,
        "d1_equals_d8": True, "spec4_equal_d1_requests": spec_vs_d1,
        "spec_vs_plain_requests": 4,
        "spec_vs_plain_equal": sum(got[r] == want[r] for r in got),
        "spec_vs_plain_tie_flips": {str(r): v for r, v in flips.items()},
        "first_tokens": [tokens["d1"][r][:8] for r in range(2)]}


def model_draft_paged(torch, np, dev, seed: int, smi: str):
    """Phase 21 (c): phase 8's workload (phase 3's 8 requests, 32 new, 4
    slots, page 16, spec k 4) on the paged engine, greedy, with the
    prompt-lookup draft and then with the resident draft model. The draft
    model's calls run eagerly on the engine's stream, beside the verify
    graph's replays; launches checked (the target's verify graph, the
    draft's wrappers); tokens equal the prompt-lookup run's or differ
    only at a tie: then both runs go again, unmeasured, with their verify
    logits recorded (``VerifyLogits``), and ``greedy_flips`` holds each
    flip to the runs' own logit difference at that step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine
    from repro_torch.models import init
    cfg = get_config("llama3.2-3b")
    gc.collect()
    torch.cuda.empty_cache()
    weights = HeldTree(init(cfg, seed=seed, device=dev))
    lens, prompts = phase3_prompts(np, cfg, seed)
    kw = dict(max_prompt_len=1024, max_new=32, num_slots=4, page_size=16,
              temperature=0.0, spec_k=SPEC_K, seed=seed, device=dev)
    out, tokens = {"phase": "model_draft_paged", "arch": cfg.name,
                   "layers": cfg.num_layers, "dtype": cfg.param_dtype,
                   "card": smi, "requests": len(prompts), "spec_k": SPEC_K,
                   "temperature": 0.0, "runs": []}, {}
    for draft in ("prompt_lookup", "model"):
        eng = build_paged_engine(cfg, spec_draft=draft, **kw)
        params = weights.load(eng)
        counts = DraftCounter(torch, eng._draft) if draft == "model" \
            else None
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        done = eng.serve(params, prompts, seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        snap = eng.stats_snapshot()
        L = cfg.num_layers
        expect = {name: 0 for name in launches}
        expect["spa_attention"] = L * snap["prefills"]
        expect["paged_verify_attention"] = L * snap["decode_steps"]
        if counts is not None:
            for name, n in draft_launches(cfg, counts.n).items():
                expect[name] += n
        if launches != expect or snap["prefills"] != len(prompts) or \
                snap["graph_replays"] != snap["decode_steps"]:
            fail(f"model_draft_paged {draft}: launches {launches} != "
                 f"{expect} or replays {snap['graph_replays']} != verify "
                 f"steps {snap['decode_steps']}")
        if counts is not None and counts.streams != {eng.stream.cuda_stream}:
            fail(f"model_draft_paged: draft calls on streams "
                 f"{counts.streams}, not the engine's")
        if not _pages_conserved(eng):
            fail(f"model_draft_paged {draft}: pages did not all return")
        tokens[draft] = _tokens(done)
        n_tok = sum(len(t) for t in tokens[draft].values())
        out["runs"].append({
            "draft": draft, "wall_s": wall, "generated_tokens": n_tok,
            "tok_per_s": n_tok / wall, "verify_steps": snap["decode_steps"],
            "graph_replays": snap["graph_replays"],
            "acceptance_rate": eng.acceptance_rate,
            "tokens_per_forward": n_tok / snap["spec_steps"],
            "launches": launches, "expected_launches": expect,
            **({"draft_calls": dict(counts.n)} if counts else {})})
        del eng, params
    flips = {}
    if tokens["model"] != tokens["prompt_lookup"]:
        # both runs again, unmeasured, their verify logits read out each
        # step: the tokens must come out as in the measured runs
        from repro_torch.core import paged as paged_mod
        logged = {}
        for draft in ("prompt_lookup", "model"):
            with VerifyLogits(torch, paged_mod, seed, len(prompts)) as lg:
                eng = lg.engine(build_paged_engine(cfg, spec_draft=draft,
                                                   **kw))
                params = weights.load(eng)
                again = _tokens(eng.serve(params, prompts, seed))
                torch.cuda.synchronize()
            if again != tokens[draft]:
                fail(f"model_draft_paged {draft}: a second run gave "
                     f"{again}, not {tokens[draft]}")
            logged[draft] = lg
            del eng, params
        flips = greedy_flips(np, tokens["model"], tokens["prompt_lookup"],
                             logged["model"], logged["prompt_lookup"],
                             what="model_draft_paged")
    out.update(draft_on_engine_stream=True,
               equal_requests=sum(tokens["model"][r] ==
                                  tokens["prompt_lookup"][r]
                                  for r in tokens["model"]),
               tie_flips={str(r): v for r, v in flips.items()})
    del weights
    return out


def _slot_parity_run(torch, cfg, where, params, draft_params, mode,
                     prompts, key, temperature=0.0):
    """One run of a slot or spec engine on ``where``: {request: tokens}
    and the captured logprobs (SpecSampler) or None."""
    from repro_torch.core.cbatch import ContinuousBatchingSampler
    from repro_torch.spec.sampler import SpecSampler
    Lp, T = 40, 12
    if mode.startswith("spec_sampler"):
        kw = dict(draft="model", draft_params=draft_params) \
            if mode.endswith("model_draft") else {}
        o = SpecSampler(cfg, Lp, T, spec_k=2, temperature=temperature,
                        device=where, **kw).generate(params, prompts, key)
        ids, lens = o.response_ids.tolist(), o.response_len.tolist()
        return ({b: ids[b][: lens[b]] for b in range(len(prompts))},
                o.response_logprobs.cpu())
    extra = {"cbatch_d1": {}, "cbatch_d3": dict(drain_interval=3),
             "cbatch_spec2": dict(spec_k=2)}[mode]
    done = ContinuousBatchingSampler(
        cfg, num_slots=2, max_prompt_len=Lp, max_new_tokens=T,
        temperature=temperature, device=where, **extra).run(
        params, prompts, key, max_new_per_request=[12, 5, 9, 7])
    return _tokens(done), None


def slot_parity(torch, np, dev, seed: int):
    """Phase 21 (d): on each reduced f32 model of phase 20 (c) the slot
    engine (D 1, D 3, spec k 2), the SpecSampler and the SpecSampler with
    the draft model (the same draft weights on both) on the card against
    the CPU, greedy: tokens equal, the SpecSampler's logprobs within 1e-4;
    then (MoE and window off) the slot engine sampled at temperature 1 on
    the card, every request's tokens equal to the paged engine's
    ``serve`` under the same key (request rid draws as row 0 of the group
    keyed (key, rid)). Under a window the slot engine keeps the JAX
    engine's prefill, whose right-padded row ring-writes its padding over
    the prompt's in-window keys (ROADMAP fact H), so its tokens are held
    to JAX's, not to the paged engine's."""
    from repro_torch.core.cbatch import ContinuousBatchingSampler
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.models import init
    from repro_torch.spec.draft import draft_config
    rng = np.random.RandomState(seed + 21)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (5, 19, 33, 40)]
    modes = ("cbatch_d1", "cbatch_d3", "cbatch_spec2", "spec_sampler",
             "spec_sampler_model_draft")
    out = {}
    for name, cfg in _sampler_parity_cfgs().items():
        p_cpu = init(cfg, seed=seed, device="cpu")
        d_cpu = init(draft_config(cfg), seed=seed + 1, device="cpu")
        p_gpu, d_gpu = _to(p_cpu, dev), _to(d_cpu, dev)
        line = {}
        for mode in modes:
            got, glp = _slot_parity_run(torch, cfg, dev, p_gpu, d_gpu, mode,
                                        prompts, seed)
            torch.cuda.synchronize()
            want, wlp = _slot_parity_run(torch, cfg, "cpu", p_cpu, d_cpu,
                                         mode, prompts, seed)
            line[mode] = got == want
            if glp is not None:
                err = float((glp - wlp).abs().max())
                line[mode + "_logprob_max_err"] = err
                line[mode] = line[mode] and bool(torch.allclose(
                    glp, wlp, atol=1e-4, rtol=1e-4))
            if not line[mode]:
                fail(f"slot_parity {name} {mode}: card {got} != CPU {want}")
        if not cfg.is_moe and cfg.sliding_window is None:
            key = seed + 21
            done = ContinuousBatchingSampler(
                cfg, num_slots=3, max_prompt_len=40, max_new_tokens=12,
                temperature=1.0, device=dev).run(p_gpu, prompts, key)
            eng = PagedGroupEngine(cfg, num_slots=3, page_size=8,
                                   num_pages=0, max_prompt_len=40,
                                   max_new_tokens=12, group_size=1,
                                   temperature=1.0, device=dev)
            paged = eng.serve(p_gpu, prompts, key)
            torch.cuda.synchronize()
            line["sampled_equal_paged_engine"] = \
                _tokens(done) == _tokens(paged)
            if not line["sampled_equal_paged_engine"]:
                fail(f"slot_parity {name}: sampled {_tokens(done)} != "
                     f"the paged engine's {_tokens(paged)}")
            del eng
        out[name] = line
    return {"phase": "slot_parity", "prompt_lens": [5, 19, 33, 40],
            "max_prompt_len": 40, "max_new": 12, "models": out}


def slot_engines(torch, np, dev, seed: int, smi: str):
    """Phase 21, one line a part: (a) cbatch_serve on full-width
    llama3.2-3b and mla_dense in bf16; (b) spec_group_train, phase 6's
    run on the SpecSampler (the group engine with spec k 4, prompt
    lookup), 2 async iterations; (c) model_draft_paged; (d)
    slot_parity."""
    from repro_torch.configs import get_config
    for cfg in (get_config("llama3.2-3b"), mla_dense_config()):
        yield cbatch_serve(torch, np, dev, cfg, seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    yield {**train_full_width(torch, np, dev, seed, iterations=2,
                              engine="group", spec_k=SPEC_K,
                              phase="spec_group_train"), "card": smi}
    gc.collect()
    torch.cuda.empty_cache()
    yield model_draft_paged(torch, np, dev, seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    yield slot_parity(torch, np, dev, seed)


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
    from repro_torch.configs import get_config
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
    prefill = {}                              # bf16 1024-token prompt
    for dtype in ("bfloat16", "float32"):
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=1024))
        if dtype == "bfloat16":
            prefill["spa_attention"] = cases[-1]
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=256,
                              responses=4, resp_len=128))
        cases.append(spa_case(torch, timer, dev, gen, dtype, prompt=1024,
                              window=256))
        dec = decode_case(torch, timer, dev, gen, dtype, B=4, ctx_max=1056)
        cases += [dec, decode_case(torch, timer, dev, gen, dtype, B=16,
                                   ctx_max=8192)]
        ver = verify_case(torch, timer, dev, gen, dtype, B=4, S=5,
                          ctx_max=1060)
        cases.append(ver)
        if dtype == "bfloat16":               # phase 3's and phase 8's
            main_dec, spec_verify = dec, ver
        bwd_cases.append(spa_bwd_case(torch, timer, dev, gen, dtype,
                                      prompt=1024))
        if dtype == "bfloat16":
            prefill["spa_attention_bwd"] = bwd_cases[-1]
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
    # the same row in bf16 (the tensor-core backward at the training shape)
    train_bwd_bf16 = spa_bwd_case(torch, timer, dev, gen, "bfloat16",
                                  prompt=120, responses=TRAIN_GROUP,
                                  resp_len=1 + TRAIN_RESP)
    train_dec = decode_case(torch, timer, dev, gen, "float32", B=8,
                            ctx_max=TRAIN_PROMPT + TRAIN_RESP)
    cast = cast_cases(torch, timer, dev, gen, train_config())
    cases += [train_spa, train_dec]
    # paged verify: the rollout engine's spec shape (f32), a suffix
    # prefill, a windowed case; the contiguous-cache wrappers
    suffix = verify_case(torch, timer, dev, gen, "bfloat16", B=1, S=512,
                         ctx_max=1024, suffix=True)
    cases += [
        verify_case(torch, timer, dev, gen, "float32", B=8, S=SPEC_K + 1,
                    ctx_max=TRAIN_PROMPT + TRAIN_RESP + SPEC_K),
        suffix,
        verify_case(torch, timer, dev, gen, "bfloat16", B=4, S=SPEC_K + 1,
                    ctx_max=1060, window=256),
        contiguous_case(torch, timer, dev, gen, "bfloat16", verify=False),
    ]
    # the contiguous wrappers: verify (no model path calls it yet); the
    # group Sampler's decode at phase 20's shapes (GQA and MLA) and a
    # rotated 8k ring
    cont_verify = contiguous_case(torch, timer, dev, gen, "bfloat16",
                                  verify=True)
    sampler_dec = setup_case(torch, timer, dev, gen, "bfloat16",
                             sampler_decode_setup)
    ring_dec = setup_case(torch, timer, dev, gen, "bfloat16",
                          ring_decode_setup)
    sampler_mla = setup_case(torch, timer, dev, gen, "bfloat16",
                             sampler_mla_setup)
    # the slot engines' verify routes at phase 21 (a)'s spec shapes (GQA
    # and MLA) and on a rotated 8k ring of window + k + 1 slots
    slot_verify = setup_case(torch, timer, dev, gen, "bfloat16",
                             slot_verify_setup)
    ring_verify = setup_case(torch, timer, dev, gen, "bfloat16",
                             ring_verify_setup)
    slot_mla_verify = {dtype: setup_case(torch, timer, dev, gen, dtype,
                                         slot_mla_verify_setup)
                       for dtype in ("bfloat16", "float32")}
    cases += [cont_verify, sampler_dec, ring_dec, sampler_mla, slot_verify,
              ring_verify, *slot_mla_verify.values()]
    # the MLA kernel at full-width heads
    mla = {name: mla_case(torch, timer, dev, gen, **kw)
           for name, kw in MLA_CASES.items()}
    cases += [{"case": k, **c} for k, c in mla.items()]
    bwd_cases += [train_bwd, train_bwd_bf16]
    for c in cases + bwd_cases + [cast]:
        emit({"phase": "kernel", **c})
    # calls whose event time still holds host time (see Timer)
    emit({"phase": "timer", "spin_cycles": SPIN_CYCLES,
          "spin_cap_cycles": SPIN_CAP_CYCLES,
          "uncovered": timer.uncovered})
    bad = [c for c in cases + bwd_cases + [cast] if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version")

    eng, params, prompts, serve = serve_full_width(torch, np, dev, args.seed)
    launches = serve["launches"]
    serve["attn_decode_share_of_tpot"] = (
        serve["layers"] * main_dec["ms"] / 1e3 / serve["tpot_p50_s"])
    emit(serve)
    emit(profile_decode(torch, np, eng, prompts, args.seed))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    spec_eng, spec = spec_serve(torch, np, dev, params, prompts, args.seed)
    emit(spec)
    # the same two windows over spec steps (4 busy slots)
    emit({**profile_decode(torch, np, spec_eng, prompts, args.seed),
          "phase": "spec_profile", "spec_k": SPEC_K})
    del spec_eng
    gc.collect()
    torch.cuda.empty_cache()
    weights = HeldTree(params)
    del params
    emit(radix_serve(torch, np, dev, get_config("llama3.2-3b"), weights,
                     args.seed))
    del weights
    emit(reduced_parity(torch, np, dev, args.seed))
    gc.collect()
    torch.cuda.empty_cache()
    train = train_full_width(torch, np, dev, args.seed, profile=True)
    emit(train)
    gc.collect()
    torch.cuda.empty_cache()
    emit(train_parity(torch, np, dev, args.seed))
    emit(train_parity(torch, np, dev, args.seed,
                      cfg=reduced_mla_train_config()))
    emit(spec_parity(torch, np, dev, args.seed))
    gc.collect()
    torch.cuda.empty_cache()
    mla_weights, mla_eng, mla_prompts, mla_srv = mla_serve(
        torch, np, dev, args.seed, spec_k=0)
    emit(mla_srv)
    # the MLA kernel's device time per step: its main kernel and (above one
    # split) the combine, which no other kernel of this phase launches
    mla_prof = profile_decode(torch, np, mla_eng, mla_prompts, args.seed,
                              kernels=MLA_PROFILE_KERNELS)
    mla_prof["mla_kernel_ms_per_step"] = sum(
        mla_prof["kernel_ms_per_step"].values())
    emit({**mla_prof, "phase": "mla_profile"})
    del mla_eng
    gc.collect()
    torch.cuda.empty_cache()
    _, _, _, mla_spec = mla_serve(torch, np, dev, args.seed, spec_k=SPEC_K,
                                  weights=mla_weights)
    emit(mla_spec)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15: phase 9's workload on the same weights
    mla_radix = radix_serve(torch, np, dev, mla_dense_config(), mla_weights,
                            args.seed, phase="mla_radix_serve")
    emit(mla_radix)
    del mla_weights
    gc.collect()
    torch.cuda.empty_cache()
    emit(mla_parity(torch, np, dev, args.seed))
    gc.collect()
    torch.cuda.empty_cache()
    for line in device_loop(torch, np, dev, args.seed):
        emit({**line, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 16: phase 6's run on full-depth f32 mla_dense
    mla_train = train_full_width(torch, np, dev, args.seed, profile=True,
                                 cfg=mla_train_config(), phase="mla_train")
    emit({**mla_train, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 17: deepseek-v2-lite as published (MLA + MoE): every
    # earlier model, engine and pool is freed
    moe_lines = []
    for line in moe_serve(torch, np, dev, args.seed, smi):
        emit({**line, "card": smi})
        moe_lines.append(line)
    for line in moe_parity(torch, np, dev, args.seed):
        emit({**line, "card": smi})
    moe_runs = {(ln["phase"], ln.get("drain_interval")): ln
                for ln in moe_lines}
    del moe_lines
    gc.collect()
    torch.cuda.empty_cache()
    # phase 18: GRPO training of deepseek-v2-lite with its MoE on, last
    for line in moe_train(torch, np, dev, args.seed, smi):
        emit(line)
        if line["phase"] == "moe_train":
            moe_trained = line["launches"]
    for line in moe_train_parity(torch, np, dev, args.seed):
        emit({**line, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 19: the sliding window on the paged plane
    window = {}
    for line in window_serve(torch, np, dev, args.seed, timer, smi):
        emit({**line, "card": smi})
        if "kernel_case" in line:
            window[line["kernel_case"]] = line
        elif line["phase"] == "window_serve" and not line["spec_k"] and \
                line["drain_interval"] == 1 and not line["arch"].startswith(
                    "deepseek"):
            window["launches", line["workload"][:2]] = line["launches"]

    gc.collect()
    torch.cuda.empty_cache()
    # phase 20: the group Sampler on a dense (and ring) cache
    sampler_lines = []
    for line in group_sampler(torch, np, dev, args.seed, smi):
        emit(line)
        sampler_lines.append(line)
    serves = [ln for ln in sampler_lines if ln["phase"] == "sampler_serve"]
    trains = [ln for ln in sampler_lines if ln["phase"] == "sampler_train"]
    gc.collect()
    torch.cuda.empty_cache()
    # phase 21: the dense-cache slot and spec engines
    slot_lines, slot_t0 = {}, time.time()
    for line in slot_engines(torch, np, dev, args.seed, smi):
        emit(line)
        slot_lines.setdefault(line["phase"], []).append(line)
    slot_runs = {(ln["arch"], r["run"]): r
                 for ln in slot_lines["cbatch_serve"] for r in ln["runs"]}
    spec_train = slot_lines["spec_group_train"][0]
    slot_s = time.time() - slot_t0

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
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    row = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train["launches"][name],
         "launches_serve": launches.get(name, 0),
         **({"launches_moe_train": moe_trained[name]}
            if name == "transfer_cast" else {}),
         **{key: c[key] for key in timing},
         **({"bf16_prefill": {key: prefill[name][key] for key in timing}}
            if name in prefill else {})}
        for name, (src, rep, c) in meta.items()]
    # phase 19's windowed decode kernel at both contexts, with the
    # launches of the D 1 run at that context
    next(r for r in row if r["name"] == "paged_decode_attention").update({
        f"window_{ctx}_context": {
            **{key: window[case][key] for key in timing},
            "launches": window["launches", case][
                "paged_decode_attention"]}
        for ctx, case in (("8k", "i"), ("32k", "ii"))})
    # the spec serving run's launches, timed at its shape (bf16, B 4, S 5);
    # the radix suffix prefill's shape (phase 9's path) beside it
    row.append({
        "name": "paged_verify_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:262",
        "launches": spec["launches"]["paged_verify_attention"],
        **{key: spec_verify[key] for key in timing},
        "suffix_prefill": {key: suffix[key] for key in timing}})
    # the MLA kernel: its decode case with phase 11's launches, its verify
    # case with phase 12's (bf16, the serving shapes), with the plan's
    # splits and blocks; the long decode, f32 and windowed cases of phase
    # 2 beside them
    plan_keys = ("splits", "blocks")
    # the training case with phase 16's launches (per iteration too), the
    # suffix prefill case with phase 15's (spec off: its warm prefills)
    trained = mla_train["launches"]["paged_mla_decode_attention"]
    launched = {
        "training": {"launches": trained, "launches_per_iteration":
                     trained / len(mla_train["iterations"])},
        "suffix_prefill": {"launches": mla_radix["runs"][0]["launches"][
            "paged_mla_verify_attention"]}}
    # phase 17's launches on deepseek-v2-lite as published: decode at D 1
    # and D 8, verify with spec on, suffix prefills (spec off) beside them;
    # phase 18's training rollouts beside the decode ones
    moe_launched = {
        "paged_mla_decode_attention": {
            **{f"moe_serve_d{d}": moe_runs["moe_serve", d]["launches"][
                "paged_mla_decode_attention"] for d in (1, 8)},
            # phase 18: the training engine's f32 rollouts
            "moe_train": moe_trained["paged_mla_decode_attention"]},
        "paged_mla_verify_attention": {
            "moe_spec_serve": moe_runs["moe_spec_serve", 1]["launches"][
                "paged_mla_verify_attention"],
            "moe_radix_serve_suffix_prefill": moe_runs[
                "moe_radix_serve", None]["runs"][0]["launches"][
                "paged_mla_verify_attention"]}}
    for name, replaces, c, run, more in (
            ("paged_mla_decode_attention", 277, mla["decode_serve_bfloat16"],
             mla_srv, {"decode_long": mla["decode_long_bfloat16"],
                       "f32": mla["decode_serve_float32"],
                       "decode_long_f32": mla["decode_long_float32"],
                       "training": mla["decode_train_float32"]}),
            ("paged_mla_verify_attention", 301, mla["verify_spec_bfloat16"],
             mla_spec, {"f32": mla["verify_spec_float32"],
                        "window": mla["verify_window_bfloat16"],
                        "suffix_prefill": mla["verify_suffix_bfloat16"]})):
        row.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_mla_attention.cu",
            "replaces": f"src/repro/kernels/decode_attention.py:{replaces}",
            "launches": run["launches"][name],
            "launches_deepseek_v2_lite_moe": moe_launched[name],
            **{key: c[key] for key in timing + plan_keys},
            **{case: {**{key: m[key] for key in timing + plan_keys},
                      **launched.get(case, {})}
               for case, m in more.items()}})
    # the contiguous wrappers: decode and the MLA route with phase 20
    # (a)'s launches (the group Sampler serving), timed at its shapes (the
    # decode entry also at a rotated 8k ring, and with phase 20 (b)'s
    # training launches); verify, which no model path calls yet, at its
    # phase-2 shape
    row += [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:119",
         "launches": serves[0]["launches"]["decode_attention"],
         "launches_sampler_train": {
             ln["mode"]: ln["launches"]["decode_attention"]
             for ln in trains},
         **{key: sampler_dec[key] for key in timing + plan_keys},
         "ring_8k": {key: ring_dec[key] for key in timing + plan_keys}},
        {"name": "verify_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_verify_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:138",
         "launches": slot_runs["llama3.2-3b", "spec4"]["launches"][
             "verify_attention"],
         "launches_model_draft": slot_runs[
             "llama3.2-3b", "spec4_model_draft"]["launches"][
             "verify_attention"],
         "launches_spec_group_train": spec_train["launches"][
             "verify_attention"],
         **{key: slot_verify[key] for key in timing + plan_keys},
         "ring_8k": {key: ring_verify[key] for key in timing + plan_keys},
         "phase2_l1060": {key: cont_verify[key]
                          for key in timing + plan_keys}},
        {"name": "mla_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_mla_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:277",
         "launches": serves[1]["launches"]["mla_decode_attention"],
         "launches_cbatch_d1": slot_runs[
             "deepseek-v2-lite-16b", "d1"]["launches"][
             "mla_decode_attention"],
         **{key: sampler_mla[key] for key in timing + plan_keys}},
        {"name": "mla_verify_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_mla_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:301",
         "launches": slot_runs["deepseek-v2-lite-16b", "spec4"][
             "launches"]["mla_verify_attention"],
         **{key: slot_mla_verify["bfloat16"][key]
            for key in timing + plan_keys},
         "f32": {key: slot_mla_verify["float32"][key]
                 for key in timing + plan_keys}}]
    emit({"phase": "elapsed", "total_s": time.time() - STARTED,
          "phases_end_at_s": PHASE_AT, "slot_engines_s": slot_s})
    emit({"kernels": row})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

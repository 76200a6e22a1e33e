#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100, run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. device: CUDA present with capability (9, 0); the card's name and power
   limit from nvidia-smi; TF32 off.
2. build: nvcc builds the flash-attention, grouped-SwiGLU, WKV-6 and
   prefix-scan libraries from ``csrc/``, all at once; build seconds and
   ptxas registers and spills.
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main paths' shapes, within the stated tolerances; the kernel's, the
   plain version's and the library yardstick's times (CUDA events, median
   over launches, L2 flushed before each), and the bound; the kernel's
   device time, and the yardstick's where there is one (torch.profiler: the
   kernels a call launches, without the host's gaps).
   - flash attention at qwen2-1.5b's heads (12/2): prefill and decode,
     bf16 and fp32, a window with a bottom-right q_offset, a kv_valid = 0
     row; at Mixtral-8x22B's heads (48/8): a 512-token prefill with its
     4096 window and a decode over the 1024-slot paged view, mixed kv_valid;
     at jamba-v0.1-52b's heads (32/8, no RoPE, no window): a 1024-token
     prefill and a decode over the 2048-slot paged view, mixed kv_valid;
     at deepseek-coder-33b's heads (56/8, g = 7) and mistral-large-123b's
     (96/8, g = 12): a 1024-token prefill and a decode over 2048 slots
     (B = 8, mixed kv_valid), and for g = 12 at S = 4, where a kv head's
     48 query rows take two CTAs (32 + 16 rows); at seamless-m4t-medium's
     decoder heads (16/16 of 64, g = 1): a decode over phase 11's 256
     slots (B = 8, mixed kv_valid) in bf16 and fp32; the fp32 prefill
     (``fma``) also at jamba's heads, at the window with a q_offset, and at
     head dim 64 (seamless's heads, a causal 256-token prefill, mixed
     kv_valid);
     then the split route's edges (T not a multiple of the chunk, T under
     one chunk, kv_valid 0, 1 and T in one batch, S = 2..4 causal with a
     q_offset, a window that empties the early chunks, g = 1, 6, 8, fp32);
     each row names the kernel that ran (``mma``: bf16 prefill on the
     tensor cores; ``fma``: fp32 prefill on the CUDA cores; ``split``:
     decode, S <= 4, split-KV with GQA packing, and its plan), is run twice
     for the same bits, and adds the kernel's and the plain version's error
     against attention in fp64 (bf16 prefill: a few heads; every split
     row: every batch row and head, held row by row to twice the plain
     version's error plus FP64_ULPS ulps at the row's scale); then
     a latency probe of the mma kernel (one kv head a query head, 64 rows,
     1024 columns) at one CTA, one CTA an SM and two;
   - grouped SwiGLU at Mixtral-8x22B's widths: decode (C = 8, the load of a
     real routing of 8 tokens), prefill at C = 512 and C = 1024 (real
     routings, ~128 and ~256 rows per expert), an empty expert (exact
     zeros), a small fp32 case, decode at C = 16, loads of 0, 1 and C rows,
     and D, F multiples of 8 but not 16 at a small shape; at
     jamba-v0.1-52b's (E = 16, D = 4096, F = 14336): decode (C = 8, a real
     top-2 routing of 8 tokens) and prefill (a real routing of 1024 tokens,
     ~128 rows per expert); at kimi-k2-1t-a32b's (E = 384, D = 7168,
     F = 2048, on the served layer's own weights, in phase 9): decode
     (C = 8, a real top-8 routing of 8 tokens) and prefill (C = 512, a real
     top-8 routing of 512 tokens), the plain version taken 32 experts at a
     time (widened to fp32, all 384 would not fit); kernel and plain
     version each also against the function computed in fp64 on a few rows
     per expert; in fp32 at Mixtral's widths for the verify probe's
     decode (C = 8) and verify (C = 40), real top-2 routings, and at
     Jamba's prefill (C = 1024), each fp32 row with its tiles
     (``gmm_plan``); every row run twice for the same bits;
     device times of the kernel and of cuBLAS bmm;
   - WKV-6 at rwkv6-3b's heads (H = 40, N = 64): the bf16 prefill at
     T = 1024, a ragged T = 77 with a non-zero s0, fp32 at B = 2, T = 256,
     one chunk (T = 64, the shortest main-path prompt) and a chunk and a
     step (T = 65), and T = 1024 under extreme decays (w = exp(-exp(x)) up
     to x = 5, whole steps at exactly 0 and 1); every row run twice for the
     same bits; kernel and plain version each also against the recurrence
     in fp64 on a few heads; the kernel's device time;
   - the MoE route, dispatch and combine (``phase_moe_dispatch``) at
     Mixtral-8x22B's decode (T = 32, the engine's batch) and chunk
     (T = 512), at kimi-k2-1t-a32b's decode (T = 8) and 1024-token
     chunk, and at Jamba2-Mini's decode (T = 32) and chunk (T = 512; E =
     16, k = 2, D = 4096) with the top 2 kept unrenormalised
     (``renormalize=False``, the route kernel's other branch), dropless
     with restealing, bf16: the route's experts equal ``route_topk``'s, the plan equal to ``priority_dispatch``'s on the
     kernel's routing, the combine's bits those of
     ``combine_expert_outputs``, twice; kernels a call, device ms and the
     host's microseconds to issue the three steps, fused against plain;
   - the prefix scan: kernel_bench's (4, 1024) and (8, 8192), R = N = 4096
     in fp32, int32 (exact) and bf16 (one tile a row), and rows that the
     look-back chains: four of 2^22, one of 2^20 + 13 (ragged), one of 2^24
     in fp32 and in int32; every row run twice, with the largest difference
     between the two runs (int32: none); torch.cumsum as the yardstick.
4. main path 1: full-width qwen2-1.5b (28 layers, random bf16 weights from
   --seed) served by the paged ``ServingEngine``: 16 requests, prompts of
   64-1024 tokens, 32 new tokens each; every request done, the allocator's
   invariants hold, logits finite, and flash attention launched in both
   prefill and decode.  Then paged == contiguous on 4 requests.  Then the
   live cluster (``phase_cluster``), on the same model and weights: two
   ``EngineReplica``s, each a paged engine of its own (max_batch 4, s_max
   2048, blocks of 16), behind a ``ClusterRouter`` stealing half the work
   and placing round robin, the 16 prompts arriving one every 2 router
   steps, 32 new tokens each: first with chunked prefill (chunks of 256),
   where at least one stolen request must carry its prefix KV and resume
   past token 0; then with whole-prompt prefill.  Each run: every request
   done with 32 tokens, ``alloc.check()`` on both engines,
   ``router.check()``, every launch inside a replica's step (the counts
   read around each step), flash attention once a layer in every
   whole-prompt prefill and decode call of each replica and never in a
   chunk prefill (the masked path, as in the reference), both replicas
   decoding; tokens/s, steals, migrations, KV migrations, steps per
   replica and the telemetry's counts printed.  Then the launcher's own
   gates at full width, as subprocesses: ``--replicas 2 --requests 12
   --chaos kill-one`` (its OK line, crashes=1, replayed > 0) and
   ``--replicas 2 --max-replicas 4 --autoscale --requests 16
   --autoscale-target 128`` (its OK line, ups >= 1; at the default 256
   this traffic never scales up, in the reference's launcher neither).
   Then the speculative paths (``phase_spec``) on 8 of those prompts, 32
   new tokens:
   the plain paged engine, a self draft (k = 4) and a cross draft (the
   same config from --seed + 1, k = 4, adaptive), each served with the
   counts set to 0 just before it and read just after; every request done
   with 32 tokens, ``alloc.check()``, rounds > 0, the self draft's
   acceptance >= 0.9, the cross draft's wasted > 0, flash attention
   launched once a layer in every draft step and never in a verify call;
   draft, verify and plain-decode seconds and calls, launches by phase and
   the share of tokens equal to the plain engine's are printed.  Then the
   verify probe (``phase_verify_probe``): 8 slots at mixed positions,
   ``verify_paged`` on 5 tokens against 5 sequential paged decode steps,
   per row the relative logit difference and argmax agreement (reported).
4b. the greedy contract (``phase_spec_exact``): qwen2-1.5b at full width,
   4 of 28 layers, fp32, flash off, 4 requests, 16 new tokens: the plain
   engine and a self, a cross and a partial draft (the target's weights
   with seeded noise, giving a round with 0 < matched < k) must emit
   identical tokens (a difference passes only as a recorded tie: a top-2
   gap under 1e-5 of the largest |logit|); the self draft accepts all.
   Then the verify probe in fp32, within 1e-4 of the largest |logit|.
   Then KV migration on the same weights with flash on
   (``phase_cluster_kv``): a request stolen mid-prefill with its KV (the
   payload's tensors on the card) emits the tokens of an undisturbed run,
   at the reference test's shape (s_max 48, chunks and blocks of 8) and at
   the cluster's (s_max 2048, chunks of 256, blocks of 16, 1200 tokens);
   a difference passes only as a recorded tie, as above.
5. main path 2: full-width Mixtral-8x22B cut to 8 of its 56 layers (random
   bf16 weights from --seed), served the same way: 8 requests, prompts of
   64-512 tokens, 16 new tokens each; both kernels launched in both
   prefill and decode.  Then paged == contiguous on 4 requests.  Then
   ``phase_spec`` with the plain engine and a self draft (k = 4, fixed):
   the checks above (the self draft's acceptance >= 0.6: see
   MOE_SELF_ACCEPT_MIN), and grouped SwiGLU launched once a layer in every
   verify call with its dispatch reaching C = B (k + 1) = 40 rows (the
   128-row tile); the grouped-SwiGLU device time of each verify and plain
   decode call (CUDA events) is printed.  Then the verify probe at
   Mixtral's widths: bf16 (reported), and fp32 with 2 of its 56 layers
   through the kernels (fp32 grouped SwiGLU, flash's split decode), within
   1e-4 of the largest |logit|.
6. main path 3: full rwkv6-3b (32 layers, random bf16 weights from --seed)
   served by the contiguous ``ServingEngine`` (the family has no paged
   path): 8 requests, prompts of 64-1024 tokens, 32 new tokens each; WKV-6
   launched once a layer in every prefill and never in decode (decode is
   the plain recurrence, as in the reference).  Then, in place of paged ==
   contiguous: the state hand-off (prefill(p + [t]) against prefill(p) then
   decode_step(t), in bf16 within the reference's bound of 0.25 on the
   logits) and the kernel route against the chunked scan (in fp32 within
   1e-3; in bf16 each route as far from the fp32 logits as the other), on
   4 prompts.

7. main path 4: jamba-v0.1-52b at full width cut to 2 of its 4
   superblocks (16 of 32 layers, random bf16 weights from --seed; 3
   superblocks would not fit the card) served by the paged engine: 8
   requests, prompts of 64-1024 tokens, 16 new tokens each; every request
   done, ``alloc.check()``, logits finite, flash attention launched once a
   superblock (2 a call) and grouped SwiGLU once a MoE layer (8 a call) in
   every prefill and decode call.  Then paged == contiguous on 4 requests.
   Then the hand-off (``phase_hybrid_handoff``) on those 4 prompts:
   prefill(p + [t]) against prefill(p) then decode_step(t), with each MoE
   layer's expert choice for the last token compared; in bf16 the
   distance on the logits against the reference's bound of 0.25 and the
   flipped layers are reported (a flipped expert choice puts it far past
   0.25); held in fp32 on 1 superblock at full width (its own weights,
   loaded alone), within 1e-3 of the largest |logit|.  Between the two,
   Jamba2-Mini's equations on the same 16 layers
   (``phase_jamba2_chunked``: ``mamba_inner_norm``,
   ``moe_renormalize=False``, as ``bench/families/hybrid.py`` sets them)
   served in 512-token chunks that carry each request's Mamba state: 8
   requests of 64-1024 prompt tokens, 16 new each; every request done,
   ``alloc.check()``, logits finite, the staged states all committed,
   grouped SwiGLU and the dispatch launched once a MoE layer in every
   chunk and decode call, flash once a superblock in every decode call
   and in no chunk call (a chunk's attention is the masked path), and no
   whole-prompt prefill.  The chunked path's logits are held against the
   plain reference by ``tests/test_torch_jamba2.py`` on the CPU and by
   the benchmark's ``correct`` on the card.

8. the prefix scan's own path (it is on no serving path: the reference
   runs it from its benchmarks and tests only): its public wrapper driven
   at the inputs the reference's benchmarks give it, each held against
   its plain version.

9. main paths 5-9, the remaining decoders at full width (random bf16
   weights from --seed), each served like path 1 (tokens/s, decode step
   ms, peak GB, launches held per call: flash once a layer, and for the
   MoE grouped SwiGLU once a layer), then paged == contiguous on 4
   requests (each engine freed before the next), then freed before the
   next path (``DECODERS``, and each path's follow-up phases written
   after it in ``main``): qwen3-8b whole (qk_norm, GQA 4:1), 16
   requests of 64-1024 tokens, 32 new, then ``phase_spec`` with a
   full-width qwen2-1.5b draft (the same vocab; acceptance recorded, no
   minimum); deepseek-coder-33b whole (62 layers, GQA 7:1); mistral-large-
   123b, 22 of its 88 layers (GQA 12:1); internvl2-26b's trunk and
   projector whole (48 layers), then its image prefix (``phase_vlm``: 2
   requests with random image_embeds [1, 256, 3200], 8 decode steps;
   other image_embeds change the logits; decode against a fresh prefill of
   the extended sequence, held in bf16 within the reference's 0.25 and in
   fp32 on 4 layers within PROBE_TOL_FP32 of the largest |logit|);
   kimi-k2-1t-a32b, 1 of its 61 layers (384 experts, top-8; s_max 1024,
   prompts of 64-512 tokens), then the grouped-SwiGLU rows at its shapes.

10. training (``phase_train``): (a) the launcher (``repro_torch.launch.
   train``, ``TRAIN_ARGS``) trains qwen2-1.5b at full width and depth
   (random bf16 weights from --seed, fp32 moments, 10 steps of 8 x 512
   tokens in 2 microbatches, remat): the mean of the last three losses
   below the first, every grad norm finite; step ms, tokens/s and peak GB
   printed; (b) no kernel launched during it (none has a backward pass);
   (d) its trained weights served through the paged engine with flash on,
   4 requests (flash once a layer a call), then paged == contiguous; (c)
   the checkpoint round trip at full width, 2 of 28 layers, after one
   step: {params, opt} saved and restored, every leaf ``torch.equal``
   (bf16 included), then two ``TrainSupervisor`` runs under
   ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG``
   set before the first CUDA call), one with a ``SimulatedFailure``: the
   same bits at the end; in a temporary directory, removed after; (e)
   mixtral-8x22b at full width, 1 of 56 layers, 2 steps with
   capacity-limited dispatch: the loss finite, ``moe_aux`` reported, no
   kernel launched (grouped SwiGLU included).

11. the encoder-decoder (``phase_encdec``): seamless-m4t-medium whole (12
   encoder and 12 decoder layers, random bf16 weights from --seed), which
   the engine cannot serve (no ``init_cache``, as in the reference), so it
   runs through ``make_prefill_step`` and ``make_decode_step``: (a) 8
   sources of 1024 frames (seeded source embeddings), target prompts of
   16 tokens, prefill at s_max 256, 128 greedy decode steps with flash on:
   logits finite, flash once a decoder layer in every decode step (the
   self-attention's split decode at d = 64, g = 1) and never in the
   prefill (the encoder, the prompt and every cross-attention take the
   plain route, as in the reference); tokens/s, prefill ms, the median
   step ms and peak GB printed; (b) the same with flash off on the same
   weights: the first decode step's logits within ENCDEC_BF16_REL of their
   largest |logit|, the share of equal tokens printed; (c) an fp32 copy of
   the weights, flash against plain over 32 steps: identical tokens (a
   difference passes only as a recorded tie, as in phase 4b); (d) 3
   ``make_train_step`` steps at full width (4 sources of 512 frames, 128
   target tokens, bf16 weights, fp32 moments, remat, flash off): the loss
   finite and falling, no kernel launched; step ms and peak GB printed.

12. multi-device (``phase_multidevice``): (a) an NCCL process group of
   one rank and ``make_host_mesh(1, 1)`` on the card; qwen2-1.5b at full
   width (phase 4's seed) placed as DTensors by ``param_shardings``, with
   ``activation_sharding`` on (``_pin`` redistributes), flash off: 8
   prompts of 512 tokens through ``train.step``'s prefill, then 16 greedy
   decode steps, against the same steps on the plain tensors (in turns:
   plain, DTensor, DTensor, plain): every step's logits bit-equal, the
   same tokens, no kernel launched; prefill and decode-step ms of each run
   printed (DTensor's dispatch cost); (b) ``compressed_allreduce`` over that group on seeded
   fp32 gradients of qwen2-1.5b's shapes: bf16(g + e) widened and its
   residual, bit for bit; ms printed; (c) in a subprocess (a fake group
   and NCCL cannot share the default group), the production dry run:
   qwen2-1.5b x decode_32k on 16x16 and mixtral-8x22b x decode_32k on
   2x16x16 traced whole, qwen2-1.5b x train_4k and x prefill_32k on 16x16
   through ``analyze_cell``'s 1- and 2-period points (their full-depth
   traces take minutes on the host); each ``status`` ok with
   ``param_bytes`` the tree's bytes; per-device argument bytes, collective
   bytes by kind and seconds printed.

13. the examples (``examples_torch/``, the counterparts of ``examples/``):
   (b) right after main path 1's phases, on its full-width qwen2-1.5b
   (bf16, flash, paged), the serving examples' own functions in-process
   (``serve_requests.serve``: 6 interactive and 10 batch requests and a
   cancelled one on one engine; ``serve_cluster.serve``: two replicas
   stealing half the work, 14 requests and a cancelled one): their asserts
   hold, ``alloc.check()`` on every engine, flash launched once a layer a
   call, the counts set to 0 just before each and read just after; (a)
   after phase 12, every example as a user runs it, in its own process on
   the card by default: quickstart, serve_requests, serve_cluster,
   compose_workloads --spec, train_lm --hundred-m (100 steps of the ~131M
   model: d_model 768, 12 layers) and again with --steps 120 on the same checkpoint directory
   (it must print "resumed from step 100" and reach step 119 with a
   finite loss); each exits 0; its wall seconds and last lines printed.

Every kernel launch of a path is counted by its wrapper, with the counts
set to 0 just before the path and read just after, and held per engine
call: each prefill and decode call launches a kernel once for every layer
that runs it (a hybrid's flash once a superblock, its grouped SwiGLU once
a MoE layer).  ``launches`` counts
wrapper calls that launched the kernel route: a flash decode (the split
pass and, with several splits, the combine pass) and a grouped SwiGLU (its
two phases) each count once.  ``kernel_launches`` counts the kernels those
calls launched.  ``moe_dispatch`` (route, dispatch and combine) counts
once a MoE layer call on every path with flash on, as grouped SwiGLU does.

Two lines before the last is the JSON record of the kernels, of the
speculative phases (``spec``), of the cluster phases (``cluster``), of the
image prefix (``vlm``), of main paths 5-9 (``decoders``), of training
(``train``), of the encoder-decoder (``encdec``), of phase 12
(``multidevice``) and of phase 13 (``examples``);
flash attention's rows at qwen2-1.5b's heads count the cluster runs'
launches too (the image-prefix runs are added to no row); every row lists
its kernel's launches on each path in ``launches_by_path`` (the trained
weights' serving run and the examples' full-width runs, ``example
serve_requests`` and ``example serve_cluster``, under their own names).
The fp32 rows of flash attention and grouped SwiGLU count instead the
calls on their route (``route_launches``, by wrapper) of the fp32 phases:
the KV-migration check, Mixtral's fp32 verify probe, Jamba's fp32
hand-off and the fp32 image prefix.  Then the
card's name and power limit; the last is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.cluster import (ClusterRouter, ClusterTelemetry,  # noqa: E402
                                 EngineReplica, StealPolicy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.device.request_scheduler import Request  # noqa: E402
from repro_torch.core.device.moe_balance import (  # noqa: E402
    gather_expert_inputs, priority_dispatch, route_topk)
from repro_torch.kernels.flash_attention import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.moe_dispatch import build as md_build  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as md_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ref as md_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import build as gmm_build  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    grouped_swiglu_plain)
from repro_torch.kernels.prefix_scan import build as scan_build  # noqa: E402
from repro_torch.kernels.prefix_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.prefix_scan.ref import (  # noqa: E402
    acc_dtype, prefix_scan_plain)
from repro_torch.kernels.wkv6 import build as wkv_build  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_plain  # noqa: E402
from repro_torch.data import DataPipeline, SyntheticCorpus  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import PagedKVCache  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim import compressed_allreduce  # noqa: E402
from repro_torch.runtime import (SimulatedFailure,  # noqa: E402
                                 TrainSupervisor)
from repro_torch.serving import ServingEngine, Speculator  # noqa: E402
from repro_torch.sharding import (batch_spec, distribute,  # noqa: E402
                                  param_shardings, placements_for)
from repro_torch.serving import speculative  # noqa: E402
from repro_torch.train import (make_decode_step,  # noqa: E402
                               make_prefill_step, make_train_step)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa: E402
                              tree_map)

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s
#: by input type (bf16 on the tensor cores, fp32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
#: a split-decode row's allowance against fp64, beyond twice the plain
#: version's error: ulps of the dtype at the row's largest |value|.  In
#: bf16 both round the output (half an ulp) and little else shows; in fp32
#: the T-term sums and exps leave both 6-22 ulps from fp64 (H100 80GB HBM3)
#: and another summation order may differ by that much
FP64_ULPS = {torch.bfloat16: 1, torch.float32: 16}
KERNEL = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:102")
GMM_KERNEL = dict(name="grouped_swiglu", route="cuda",
                  source="src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
                  replaces="src/repro/kernels/moe_gmm/kernel.py:53")
MOE_DISPATCH_KERNEL = dict(
    name="moe_dispatch", route="cuda",
    source="src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu",
    replaces="none: XLA fuses src/repro/models/moe.py::moe_fwd's dispatch")
WKV_KERNEL = dict(name="wkv6", route="cuda",
                  source="src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                  replaces="src/repro/kernels/wkv6/kernel.py:67")
SCAN_KERNEL = dict(name="prefix_scan", route="cuda",
                   source="src/repro_torch/kernels/prefix_scan/csrc/"
                          "prefix_scan.cu",
                   replaces="src/repro/kernels/prefix_scan/kernel.py:46")
#: each kernel's launch counters (plain integers on its wrapper): calls
#: that launched it, and, where a call launches more than one kernel, the
#: kernels launched
COUNTERS = {"flash_attention": ops.flash_attention,
            "grouped_swiglu": gmm_ops.grouped_swiglu,
            "moe_dispatch": md_ops.moe_dispatch,
            "wkv6": wkv_ops.wkv6,
            "prefix_scan": scan_ops.prefix_scan}
#: max |logit| difference the reference allows its bf16 path between two
#: computations of the same logits (tests/test_models.py)
BF16_LOGIT_TOL = 0.25
#: the prefix scan's own path: no serving path runs it
SCAN_PATH = "prefix-scan benchmarks"
#: the WKV routes (kernel and chunked scan) in fp32 at full depth: the same
#: fp32 products summed in other orders, ~1e-4 apart
ROUTE_TOL_FP32 = 1e-3
#: speculative decoding: the draft depth; the self draft's least acceptance
#: in bf16 (verify on the masked path, draft and decode on the split
#: kernel, whose roundings differ: qwen2-1.5b's logits by ~2 % of the
#: largest |logit|, so near-ties flip).  Mixtral's is lower: a rounding
#: difference that flips a token's top-2 experts moves its output far more,
#: and verify's dispatch takes the 128-row tile where decode takes the
#: 16-row one; 0.764 on an H100 80GB HBM3 at 700 W (the qwen bound failed
#: there).  The fp32 verify probe's bound on |verify - sequential decode|
#: relative to the row's largest |logit|; a top-2 logit gap under TIE_REL
#: of the largest |logit| is a tie; the partial draft's noise scales (of
#: each leaf's std), tried in order
SPEC_K = 4
SELF_ACCEPT_MIN = 0.9
MOE_SELF_ACCEPT_MIN = 0.6
PROBE_TOL_FP32 = 1e-4
TIE_REL = 1e-5
PARTIAL_NOISE = (0.05, 0.1, 0.2, 0.4)
#: the cluster phase: each replica's engine (the whole qwen2-1.5b, its
#: weights shared, a paged pool of its own) and the chunk that makes a
#: partly-prefilled request stealable with its KV; the router steps between
#: two arrivals; the launcher's autoscale
#: target: at 16 requests of 4-47 prompt tokens and 16 new, the reference's
#: default of 256 never scales up (the reference launcher neither), 128
#: does
CLUSTER_ENGINE = dict(max_batch=4, s_max=2048, block_size=16,
                      kv_mode="paged")
CLUSTER_CHUNK = 256
ARRIVAL_EVERY = 2
AUTOSCALE_TARGET = 128
#: main path 4: jamba-v0.1-52b's depth on one card (2 of its 4 superblocks:
#: 26.05B parameters, 52.1 GB in bf16; 3 would be 77.6 GB); the fp32
#: hand-off's bound on |prefill(p + [t]) - decode(t)| relative to the
#: largest |logit|
JAMBA_LAYERS = 16
HANDOFF_TOL_FP32 = 1e-3
#: Jamba2-Mini's path on those 16 layers: its own name in the launch
#: counts, and the benchmark cell's prefill chunk
JAMBA2 = "jamba2-mini-l16"
JAMBA2_CHUNK = 512
#: main paths 5-9, the remaining decoders at full width: arch -> (layers
#: on one card (None: all), s_max, requests, longest prompt, new tokens).
#: mistral-large-123b keeps 22 of 88 layers (62.5 GB in bf16), cut as
#: Mixtral is; kimi-k2-1t-a32b 1 of 61 (17.05B parameters a layer: two
#: would leave no room for the dropless [384, T, 7168] dispatch buffers)
DECODERS = {"qwen3-8b": (None, 2048, 16, 1024, 32),
            "deepseek-coder-33b": (None, 2048, 8, 1024, 16),
            "mistral-large-123b": (22, 2048, 8, 1024, 16),
            "internvl2-26b": (None, 2048, 8, 1024, 16),
            "kimi-k2-1t-a32b": (1, 1024, 8, 512, 16)}
#: the image-prefix check: text tokens after the image tokens, greedy
#: decode steps; experts a slice of the grouped-SwiGLU plain version at
#: Kimi's 384 (it widens the weights to fp32: all at once would not fit)
VLM_TEXT = 256
VLM_STEPS = 8
PLAIN_EXPERTS = 32
#: phase 10, training: the launcher's run of qwen2-1.5b at full width and
#: depth; the checkpoint round trip's depth (2 of 28 layers: 0.65 GB of
#: bf16 weights and 2.6 GB of fp32 moments) and its supervisor runs' batch,
#: sequence, steps, checkpoint period and failing step; Mixtral-8x22B's
#: depth (1 of 56 layers: 5.8 GB of bf16 weights), steps and lr
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--steps", "10", "--global-batch",
              "8", "--seq-len", "512", "--microbatches", "2"]
CKPT_LAYERS = 2
SUP_BATCH, SUP_SEQ, SUP_STEPS, SUP_EVERY, SUP_FAIL = 4, 256, 4, 2, 3
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_LR = 1, 2, 1e-4
#: phase 11, the encoder-decoder, seamless-m4t-medium whole (12 + 12
#: layers): sources, their frames and the target prompts' tokens; the
#: self-attention cache's capacity; greedy decode steps in bf16 and in the
#: fp32 check; the bf16 plain route's bound on the first decode step's
#: logits, relative to their largest |logit| (flash and plain round the
#: attention's output differently, about one bf16 ulp a layer over 12
#: layers); the training run's batch, source frames, target tokens, steps
#: and lr (bf16 weights: an AdamW step of 1e-3 is above their ulp); phase
#: 3's kv_valid at its heads.  Head dims other than 128, by path
ENCDEC_B, ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_S_MAX = 8, 1024, 16, 256
ENCDEC_STEPS, ENCDEC_EXACT_STEPS = 128, 32
ENCDEC_BF16_REL = 0.05
ENCDEC_TRAIN_B, ENCDEC_TRAIN_SRC, ENCDEC_TRAIN_TGT = 4, 512, 128
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_LR = 3, 1e-3
ENCDEC_KV_VALID = [17, 256, 1, 100, 144, 255, 64, 129]
HEAD_DIM = {"seamless-m4t-medium": 64}
#: phase 12, multi-device: qwen2-1.5b's prompts on the one-rank mesh
#: (batch, tokens each), greedy decode steps, the compression's timed
#: repeats; the dry run's cells (arch, shape, 2x16x16?), and those traced
#: through the 1- and 2-period points of ``analyze_cell`` (a full-depth
#: trace of the 32k prefill or the 4k train step takes minutes on the
#: host: the chunked attention runs as ~10^4 meta ops a layer)
MD_PROMPTS, MD_PROMPT_LEN, MD_STEPS, MD_REPS = 8, 512, 16, 3
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False),
                ("qwen2-1.5b", "prefill_32k", False),
                ("qwen2-1.5b", "decode_32k", False),
                ("mixtral-8x22b", "decode_32k", True))
DRYRUN_ANALYZED = ("train_4k", "prefill_32k")
#: phase 13, the examples (``examples_torch/``): their directory, and the
#: training example's steps (its default) and the resumed run's
EXAMPLES = ROOT / "examples_torch"
EXAMPLE_TRAIN_STEPS, EXAMPLE_RESUME_STEPS = 100, 120


def _zero_counts() -> None:
    for counter in COUNTERS.values():
        counter.launches = 0
        if hasattr(counter, "kernel_launches"):
            counter.kernel_launches = 0


def _route_counts() -> dict:
    """The wrapper calls so far of each kernel that has routes, by route:
    {(kernel, route): calls}.  Running totals, never set to 0 (phases that
    set the other counts to 0 run inside ``_fp32_run``), read by
    difference."""
    return {(name, route): n for name, c in COUNTERS.items()
            for route, n in getattr(c, "route_launches", {}).items()}


def _fp32_run(runs: dict, name: str, fn):
    """Runs one fp32 phase and records under ``name`` in ``runs`` the
    calls it made on each kernel route: what the fp32 rows' ``launches``
    count."""
    before = _route_counts()
    out = fn()
    runs[name] = {k: n - before[k] for k, n in _route_counts().items()}
    return out


def _kernel_launches() -> dict:
    """The kernels each wrapper launched: its own count where a call can
    launch more than one, else its count of calls."""
    return {k: getattr(c, "kernel_launches", c.launches)
            for k, c in COUNTERS.items()}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    # float32 matmuls in full float32 (not TF32) for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi.splitlines()[0]


def phase_build() -> None:
    """Every library at once: one nvcc each, started together."""
    libs = {"flash_attention": build.LIBRARY, "moe_gmm": gmm_build.LIBRARY,
            "wkv6": wkv_build.LIBRARY, "prefix_scan": scan_build.LIBRARY,
            "moe_dispatch": md_build.LIBRARY}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(lib.build) for name, lib in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, (path, seconds, log) in built.items():
        (path.parent / f"{name}.build.log").write_text(log)
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"build: {path.name} in {seconds} s; ptxas: {regs}; "
              f"spills: {spills or 'none'}")
        libs[name].load()


def _time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call: the time of every kernel (and memset) it
    launches, from torch.profiler over ``reps`` calls (L2 warm), without
    the host's launch gaps that a timed single call can include.  Now and
    then the profiler returns a window with no device events at all (once
    in three runs on the H100, on a window of torch.cumsum calls); such a
    window is taken again, ``tries`` times in all, before this fails."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", 0)
                  or getattr(e, "device_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"the profiler saw no device time in {tries} windows")


def _visible(b, s, t, causal, window, q_offset, kv_valid):
    """[B, S, T] bool: the kernel's mask on this case's data."""
    i = q_offset + torch.arange(s, device="cuda")[:, None]
    j = torch.arange(t, device="cuda")[None, :]
    m = torch.ones(s, t, dtype=torch.bool, device="cuda")
    if causal:
        m &= j <= i
    if window is not None:
        m &= i - j < window
    m = m.expand(b, s, t)
    if kv_valid is not None:
        m = m & (j < kv_valid[:, None, None])
    return m


def _bound(q, k, causal, window, q_offset, kv_valid):
    """Least time for this case's work: bytes (q and o once, the K/V rows
    some query may see once) and FLOPs (QK^T and PV over visible pairs)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vis = _visible(b, s, t, causal, window, q_offset, kv_valid)
    elt = q.element_size()
    kv_rows = int(vis.any(dim=1).sum())
    nbytes = 2 * q.numel() * elt + 2 * kv_rows * hkv * d * elt
    flops = 4 * d * h * int(vis.sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _attn_fp64(q, k, v, kv_valid, causal, window, q_offset, batch=1,
               heads=4):
    """Attention in fp64 for the first ``batch`` batch rows and ``heads``
    query heads (a fully masked row is 0, as in the kernel):
    [batch, S, heads, d]."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vis = _visible(b, s, t, causal, window, q_offset, kv_valid)
    kv = torch.arange(heads, device="cuda") // (h // hkv)
    outs = []
    for bb in range(batch):
        qd = q[bb, :, :heads].double().transpose(0, 1)      # heads, S, d
        kd, vd = (x[bb][:, kv].double().transpose(0, 1) for x in (k, v))
        logits = qd @ kd.transpose(1, 2) * d ** -0.5        # heads, S, T
        p = torch.softmax(logits.masked_fill(~vis[bb], float("-inf")), -1)
        outs.append((torch.nan_to_num(p) @ vd).transpose(0, 1))
    return torch.stack(outs)


def _row_errs(got, want, exact):
    """Each output row's (batch, query, head) max error against fp64, for
    the kernel and for the plain version, and the kernel's largest error
    over its row's allowance: twice the plain version's error plus
    FP64_ULPS ulps of the dtype at the row's largest |value|.  Long rows
    average to values of ~sqrt(e / T), under the absolute tolerance: a
    fault that biases them shows here.  A row over 1 fails the case."""
    ek = (got.double() - exact).abs().amax(-1)
    ep = (want.double() - exact).abs().amax(-1)
    scale = exact.abs().amax(-1)
    ulp = torch.ldexp(torch.full_like(scale, torch.finfo(got.dtype).eps
                                      * FP64_ULPS[got.dtype]),
                      torch.frexp(scale).exponent - 1)
    allow = 2 * ep + torch.where(scale > 0, ulp, 0)
    over = torch.where(allow > 0, ek / allow,
                       torch.where(ek > 0, float("inf"), 0.0))
    return ek.max().item(), ep.max().item(), over.max().item()


def phase_flash_probe() -> None:
    """The mma kernel's latency: one query tile of 64 rows over 1024
    columns (16 kv tiles, no mask) for 1 head, one head an SM and two
    (non-causal bf16, d = 128, one kv head a query head)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe = {}
    for heads in (1, sms, 2 * sms):
        q = torch.randn(1, 64, heads, 128, generator=g,
                        device="cuda").bfloat16()
        k = torch.randn(1, 1024, heads, 128, generator=g,
                        device="cuda").bfloat16()
        probe[f"ctas_{heads}"] = _device_ms(
            lambda: ops.flash_attention(q, k, k, causal=False))
    print("flash latency probe (device ms): " + json.dumps(probe))


def phase_kernels(seed: int) -> list:
    """flash_attention against its plain version at each main path's
    shapes: qwen2-1.5b's 12/2 heads, Mixtral-8x22B's 48/8 heads (whose
    prefill passes the 4096 window, decode the paged view of s_max 1024),
    jamba-v0.1-52b's 32/8 (GQA packing g = 4; no RoPE and no window,
    which the kernel never sees), deepseek-coder-33b's 56/8 (g = 7),
    mistral-large-123b's 96/8 (g = 12) and seamless-m4t-medium's 16/16
    (g = 1) of head dim 64; every other path's head dim is 128."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qwen, mixtral, jamba = "qwen2-1.5b", "mixtral-8x22b", "jamba-v0.1-52b"
    deepseek, mistral = "deepseek-coder-33b", "mistral-large-123b"
    seamless = "seamless-m4t-medium"
    cases = [
        # path, name, dtype, B, S, T, H, Hkv, causal, window, q_offset,
        # kv_valid
        (qwen, "prefill", torch.bfloat16, 1, 1024, 1024, 12, 2, True, None,
         0, None),
        (qwen, "decode", torch.bfloat16, 8, 1, 2048, 12, 2, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (qwen, "window_q_offset", torch.bfloat16, 2, 256, 1024, 12, 2, True,
         384, 768, None),
        (qwen, "decode_kv_valid_0", torch.bfloat16, 8, 1, 2048, 12, 2, False,
         None, 0, [0, 2048, 7, 300, 0, 2047, 64, 1500]),
        (qwen, "prefill", torch.float32, 1, 1024, 1024, 12, 2, True, None, 0,
         None),
        (qwen, "window_q_offset", torch.float32, 2, 256, 1024, 12, 2, True,
         384, 768, None),
        (qwen, "decode", torch.float32, 8, 1, 2048, 12, 2, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (mixtral, "mixtral_prefill", torch.bfloat16, 1, 512, 512, 48, 8,
         True, 4096, 0, None),
        (mixtral, "mixtral_decode", torch.bfloat16, 8, 1, 1024, 48, 8, False,
         None, 0, [65, 1024, 130, 513, 1, 300, 700, 529]),
        (jamba, "jamba_prefill", torch.bfloat16, 1, 1024, 1024, 32, 8, True,
         None, 0, None),
        # the fp32 hand-off's prefill (jamba's heads, fp32)
        (jamba, "jamba_prefill", torch.float32, 1, 1024, 1024, 32, 8, True,
         None, 0, None),
        (jamba, "jamba_decode", torch.bfloat16, 8, 1, 2048, 32, 8, False,
         None, 0, [65, 2048, 130, 1025, 1, 300, 1700, 529]),
        (deepseek, "deepseek_prefill", torch.bfloat16, 1, 1024, 1024, 56, 8,
         True, None, 0, None),
        (deepseek, "deepseek_decode", torch.bfloat16, 8, 1, 2048, 56, 8,
         False, None, 0, [65, 2048, 130, 1025, 1, 300, 1700, 529]),
        (mistral, "mistral_large_prefill", torch.bfloat16, 1, 1024, 1024, 96,
         8, True, None, 0, None),
        (mistral, "mistral_large_decode", torch.bfloat16, 8, 1, 2048, 96, 8,
         False, None, 0, [65, 2048, 130, 1025, 1, 300, 1700, 529]),
        (mistral, "split_S4_g12", torch.bfloat16, 8, 4, 2048, 96, 8, True,
         None, 2044, [2048, 4, 513, 1700, 64, 1025, 2047, 300]),
        # the split route's edges: T not a multiple of the chunk with
        # kv_valid 0, 1 and T in one batch; T under one chunk; S = 2..4
        # with causal and a bottom-right q_offset; a window that leaves the
        # early chunks empty; g = H / Hkv of 1, 6 and 8
        (qwen, "split_ragged_T_kv_valid_0_1_T", torch.bfloat16, 4, 1, 1000,
         12, 2, False, None, 0, [0, 1, 1000, 517]),
        (qwen, "split_T_under_one_chunk", torch.bfloat16, 8, 1, 50, 12, 2,
         False, None, 0, [50, 1, 0, 25, 50, 49, 2, 33]),
        (qwen, "split_S2_causal", torch.bfloat16, 8, 2, 2048, 12, 2, True,
         None, 2046, [2048, 1024, 2, 1, 700, 2048, 3, 1500]),
        (mixtral, "split_S4_causal", torch.bfloat16, 4, 4, 1024, 48, 8, True,
         None, 1020, [1024, 4, 513, 900]),
        (qwen, "split_S3_g8", torch.bfloat16, 4, 3, 1024, 64, 8, True, None,
         1021, None),
        (qwen, "split_g1", torch.bfloat16, 8, 1, 2048, 8, 8, False, None, 0,
         [1, 2048, 7, 300, 1024, 2047, 64, 1500]),
        (qwen, "split_window", torch.bfloat16, 8, 1, 2048, 12, 2, False, 300,
         2047, None),
        (qwen, "split_S4_causal", torch.float32, 4, 4, 1024, 12, 2, True,
         None, 1020, [1024, 4, 513, 0]),
        # seamless-m4t-medium's decoder self-attention decode (16/16 heads
        # of 64, g = 1) over phase 11's s_max of 256, mixed kv_valid
        (seamless, "seamless_decode", torch.bfloat16, 8, 1, 256, 16, 16,
         False, None, 0, ENCDEC_KV_VALID),
        (seamless, "seamless_decode", torch.float32, 8, 1, 256, 16, 16,
         False, None, 0, ENCDEC_KV_VALID),
        # the fp32 prefill route at head dim 64 (seamless-m4t-medium's
        # heads), a causal 256-token prefill with the same mixed kv_valid
        (seamless, "seamless_prefill", torch.float32, 8, 256, 256, 16, 16,
         True, None, 0, ENCDEC_KV_VALID),
    ]
    rows = []
    for (path, name, dt, b, s, t, h, hkv, causal, window, q_offset,
         valid) in cases:
        d = HEAD_DIM.get(path, 128)
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
        kv_valid = None if valid is None else torch.tensor(
            valid, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, kv_valid, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, kv_valid, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[dt]:
            raise AssertionError(f"flash_attention {name} {dt}: max error "
                                 f"{err} > {TOL[dt]}")
        route = ops.kernel_route(dt, s)
        if route != ("split" if s <= 4 else
                     "mma" if dt == torch.bfloat16 else "fma"):
            raise AssertionError(f"flash_attention {name}: route {route}")
        # no atomics and a plan fixed by the shapes: the same bits again
        if not torch.equal(got, ops.flash_attention(q, k, v, kv_valid, **kw)):
            raise AssertionError(f"flash_attention {name}: two calls differ")
        plan = ops.decode_plan(b, hkv, t) if route == "split" else None
        err64 = plain_err64 = row_over = None
        if route == "mma":
            exact = _attn_fp64(q, k, v, kv_valid, causal, window, q_offset)
            err64, plain_err64 = (
                (out[:1, :, :exact.shape[2]].double() - exact).abs().max()
                .item() for out in (got, want))
            del exact
        elif route == "split":
            exact = _attn_fp64(q, k, v, kv_valid, causal, window, q_offset,
                               batch=b, heads=h)
            err64, plain_err64, row_over = _row_errs(got, want, exact)
            del exact
            if not row_over <= 1:
                raise AssertionError(
                    f"flash_attention {name} {dt}: a row's error against "
                    f"fp64 is {row_over} times its allowance (kernel "
                    f"{err64}, plain {plain_err64})")
        if valid is not None:
            dead = kv_valid == 0
            if dead.any() and not torch.all(got[dead] == 0):
                raise AssertionError(f"{name}: kv_valid = 0 row is not 0")
        # SDPA in its own layout, with the same mask, as the yardstick
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if not (causal and window is None and q_offset == 0 and s == t):
            mask = _visible(b, s, t, causal, window, q_offset,
                            kv_valid)[:, None]
        scale = d ** -0.5
        bound_ms, bound_by = _bound(q, k, causal, window, q_offset, kv_valid)
        ms = _time_ms(lambda: ops.flash_attention(q, k, v, kv_valid, **kw))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                scale=scale, enable_gqa=True)
        rows.append(dict(
            KERNEL, case=f"{name}/{str(dt).split('.')[1]}", path=path,
            shape=dict(B=b, S=s, T=t, H=h, Hkv=hkv, d=d, window=window,
                       q_offset=q_offset, kv_valid=valid),
            kernel_route=route,
            decode_plan=None if plan is None else plan._asdict(),
            max_abs_err=err, max_err=err, tol=TOL[dt], err_fp64=err64,
            plain_err_fp64=plain_err64, fp64_row_over_allowance=row_over,
            ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: flash_attention_plain(
                q, k, v, kv_valid, **kw)),
            library_ms=_time_ms(sdpa),
            device_ms=_device_ms(lambda: ops.flash_attention(
                q, k, v, kv_valid, **kw)),
            library_device_ms=_device_ms(sdpa),
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel {rows[-1]['case']} ({path}, B={b} S={s} T={t} "
              f"H={h}/{hkv}, {route}"
              f"{'' if plan is None else f', {plan.splits} x {plan.chunk}'}): "
              f"max_err {err} (tol {TOL[dt]}; against fp64: kernel {err64}, "
              f"plain {plain_err64}, worst row {row_over} of its "
              f"allowance), {ms} ms, plain "
              f"{rows[-1]['plain_ms']} ms, sdpa {rows[-1]['library_ms']} ms; "
              f"device {rows[-1]['device_ms']} ms, sdpa "
              f"{rows[-1]['library_device_ms']} ms; bound {bound_ms} ms "
              f"({bound_by})")
    return rows


def _routed(g, n, e, d, dtype, k=2):
    """A real dropless top-k routing of n random tokens over e experts: the
    dispatch buffer [e, n, d] and the plan's load."""
    x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
    router = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    idx, gate, probs = route_topk(x.float() @ router, k)
    plan = priority_dispatch(idx, gate, probs, num_experts=e, capacity=n,
                             resteal=True)
    return gather_expert_inputs(x, plan, k), plan.load


def _gmm_bound(x, f, load):
    """Least time for this case's work: FLOPs on the kept rows and bytes of
    the loaded experts' weights, the kept rows read and the output written."""
    e, c, d = x.shape
    loads = load.tolist()
    elt = x.element_size()
    rows = sum(loads)
    nbytes = (sum(1 for n in loads if n > 0) * 3 * d * f + rows * d
              + e * c * d) * elt
    flops = 6 * rows * d * f
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _gmm_library(x, wg, wu, wd):
    """The yardstick: the same function composed of cuBLAS batched GEMMs on
    the dense buffer (no single PyTorch call computes it)."""
    h = (F.silu(torch.bmm(x, wg).float())
         * torch.bmm(x, wu).float()).to(x.dtype)
    return torch.bmm(h, wd)


def _fp64_err(x, wg, wu, wd, outs, rows=8):
    """Max error of each of ``outs`` against the function computed in fp64
    on the first ``rows`` rows of every expert (h rounded to x's type, the
    function's own rounding point): a yardstick independent of both."""
    errs = [0.0] * len(outs)
    for e in range(x.shape[0]):
        xe = x[e, :rows].double()
        h = (F.silu(xe @ wg[e].double()) * (xe @ wu[e].double())).to(
            x.dtype).double()
        y = h @ wd[e].double()
        for i, out in enumerate(outs):
            errs[i] = max(errs[i], (out[e, :rows].double() - y).abs().max()
                          .item())
        del xe, h, y
    return errs


def phase_gmm_kernel(seed: int) -> list:
    """grouped_swiglu against its plain version at Mixtral-8x22B's widths
    (E = 8, D = 6144, F = 16384), at a small fp32 shape, and at
    jamba-v0.1-52b's (E = 16, D = 4096, F = 14336); then in fp32 at the
    widths the fp32 phases run: Mixtral's at the verify probe's C = 8
    (decode) and C = 40 (verify), and Jamba's at C = 1024 (prefill), each
    weight set allocated after the previous one is freed."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    e, d, f = 8, 6144, 16384
    mixtral, jamba = "mixtral-8x22b", "jamba-v0.1-52b"

    def weights(e, d, f, dt):
        return [(torch.randn(s, generator=g, device="cuda") / s[1] ** 0.5
                 ).to(dt) for s in ((e, d, f), (e, d, f), (e, f, d))]

    w = weights(e, d, f, torch.bfloat16)
    decode_x, decode_load = _routed(g, 8, e, d, torch.bfloat16)
    empty_x, empty_load = decode_x.clone(), decode_load.clone()
    empty_x[0], empty_load[0] = 0, 0          # expert 0 receives nothing
    cases = [("decode", decode_x, decode_load, w),
             ("prefill_512", *_routed(g, 512, e, d, torch.bfloat16), w),
             ("prefill", *_routed(g, 1024, e, d, torch.bfloat16), w),
             ("empty_expert", empty_x, empty_load, w)]
    small_w = weights(4, 256, 512, torch.float32)
    small_x, small_load = _routed(g, 64, 4, 256, torch.float32)
    cases.append(("small", small_x, small_load, small_w))
    # the tensor-core path's edges: a decode slab of 16 rows (a real routing
    # of 16 tokens); loads of 0, 1 and C rows; D and F multiples of 8 but not
    # of 16 (the k edge inside a k-step), on the prefill tile
    cases.append(("decode_C16", *_routed(g, 16, e, d, torch.bfloat16), w))
    edge_load = torch.tensor([0, 1, 16, 0, 16, 1, 5, 16], dtype=torch.int32,
                             device="cuda")
    edge_x = torch.randn(e, 16, d, generator=g, device="cuda").bfloat16()
    edge_x[torch.arange(16, device="cuda")[None, :] >= edge_load[:, None]] = 0
    cases.append(("load_0_1_C", edge_x, edge_load, w))
    odd_load = torch.tensor([0, 1, 40], dtype=torch.int32, device="cuda")
    odd_x = torch.randn(3, 40, 264, generator=g, device="cuda").bfloat16()
    odd_x[torch.arange(40, device="cuda")[None, :] >= odd_load[:, None]] = 0
    cases.append(("D264_F520", odd_x, odd_load,
                  weights(3, 264, 520, torch.bfloat16)))
    cases = [(mixtral, *case) for case in cases]
    # Jamba's 16 experts (a second weight set, after Mixtral's are freed)
    rows = _gmm_rows(cases)
    del cases, w, small_w, edge_x, odd_x
    gc.collect()
    torch.cuda.empty_cache()
    w = weights(16, 4096, 14336, torch.bfloat16)
    cases = [(jamba, "jamba_decode",
              *_routed(g, 8, 16, 4096, torch.bfloat16), w),
             (jamba, "jamba_prefill",
              *_routed(g, 1024, 16, 4096, torch.bfloat16), w)]
    rows += _gmm_rows(cases)
    del cases, w
    gc.collect()
    torch.cuda.empty_cache()
    # fp32: Mixtral's 8 experts (9.66 GB), then Jamba's 16 (11.3 GB)
    w = weights(e, d, f, torch.float32)
    cases = [(mixtral, "decode", *_routed(g, 8, e, d, torch.float32), w),
             (mixtral, "verify_C40", *_routed(g, 40, e, d, torch.float32),
              w)]
    rows += _gmm_rows(cases)
    del cases, w
    gc.collect()
    torch.cuda.empty_cache()
    w = weights(16, 4096, 14336, torch.float32)
    cases = [(jamba, "jamba_prefill",
              *_routed(g, 1024, 16, 4096, torch.float32), w)]
    rows += _gmm_rows(cases)
    del cases, w
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _gmm_plain(x, wg, wu, wd, load, experts=None):
    """The plain version on the whole buffer, or (``experts``) on slices of
    that many experts at a time: every expert's rows are computed alone,
    so the slices give the same function on the same inputs."""
    if experts is None:
        return grouped_swiglu_plain(x, wg, wu, wd, load)
    return torch.cat([grouped_swiglu_plain(x[i:i + experts],
                                           wg[i:i + experts],
                                           wu[i:i + experts],
                                           wd[i:i + experts])
                      for i in range(0, x.shape[0], experts)])


def _gmm_rows(cases, plain_experts=None) -> list:
    """Each case (path, name, x, load, weights): the kernel against its
    plain version (on slices of ``plain_experts`` experts, if set), the
    same bits from a second call, fp64 errors, times and bound."""
    rows = []
    for path, name, x, load, (wg, wu, wd) in cases:
        got = gmm_ops.grouped_swiglu(x, wg, wu, wd, load)
        torch.cuda.synchronize()
        # no atomics and tiles fixed by the shapes: the same bits again
        if not torch.equal(got, gmm_ops.grouped_swiglu(x, wg, wu, wd, load)):
            raise AssertionError(f"grouped_swiglu {name}: two calls differ")
        want = _gmm_plain(x, wg, wu, wd, load, plain_experts)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[x.dtype]
        if not err <= tol:
            raise AssertionError(f"grouped_swiglu {name}: max error {err} "
                                 f"> {tol}")
        dead = (torch.arange(x.shape[1], device="cuda")[None, :]
                >= load[:, None])
        if not torch.all(got[dead] == 0):
            raise AssertionError(f"grouped_swiglu {name}: rows beyond the "
                                 "load are not 0")
        if name == "empty_expert" and not torch.all(got[0] == 0):
            raise AssertionError("grouped_swiglu: the empty expert is not 0")
        err64, plain_err64 = _fp64_err(x, wg, wu, wd, (got, want))
        bound_ms, bound_by = _gmm_bound(x, wg.shape[2], load)
        ms = _time_ms(lambda: gmm_ops.grouped_swiglu(x, wg, wu, wd, load))
        plan = None   # bf16 picks its own tiles
        if x.dtype == torch.float32:
            plan = gmm_ops.gmm_plan(*x.shape, wg.shape[2])._asdict()
        rows.append(dict(
            GMM_KERNEL, case=f"{name}/{str(x.dtype).split('.')[1]}",
            path=path, kernel_route=gmm_ops.kernel_route(x.dtype),
            tile_plan=plan,
            shape=dict(E=x.shape[0], C=x.shape[1], D=x.shape[2],
                       F=wg.shape[2], load=load.tolist()),
            max_abs_err=err, max_err=err, tol=tol, ms=ms, kernel_ms=ms,
            err_fp64=err64, plain_err_fp64=plain_err64,
            bitwise_equal=bool(torch.equal(got, want)),
            plain_ms=_time_ms(lambda: _gmm_plain(x, wg, wu, wd, load,
                                                 plain_experts),
                              reps=15 if plain_experts is None else 3,
                              warmup=3 if plain_experts is None else 1),
            plain_experts_a_call=plain_experts,
            library_ms=_time_ms(lambda: _gmm_library(x, wg, wu, wd)),
            library="torch.bmm x3 (cuBLAS) + silu*mul cast",
            device_ms=_device_ms(lambda: gmm_ops.grouped_swiglu(
                x, wg, wu, wd, load), reps=5),
            library_device_ms=_device_ms(
                lambda: _gmm_library(x, wg, wu, wd), reps=5),
            bound_ms=bound_ms, bound_by=bound_by))
        tiles = "" if plan is None else " " + json.dumps(plan)
        print(f"kernel grouped_swiglu {rows[-1]['case']} E={x.shape[0]} "
              f"C={x.shape[1]} D={x.shape[2]} F={wg.shape[2]}{tiles}: "
              f"max_err {err} "
              f"(tol {tol}; against fp64: kernel {err64}, plain "
              f"{plain_err64}; bitwise equal {rows[-1]['bitwise_equal']}), "
              f"{ms} ms, plain {rows[-1]['plain_ms']} ms, "
              f"bmm {rows[-1]['library_ms']} ms; device "
              f"{rows[-1]['device_ms']} ms, bmm "
              f"{rows[-1]['library_device_ms']} ms; bound {bound_ms} ms "
              f"({bound_by}), load {load.tolist()}")
    return rows


#: the MoE dispatch phase: (path, case, T, E, k, D, renormalise the top k)
MOE_DISPATCH_SHAPES = (
    ("mixtral-8x22b", "mixtral_decode", 32, 8, 2, 6144, True),
    ("mixtral-8x22b", "mixtral_chunk", 512, 8, 2, 6144, True),
    ("kimi-k2-1t-a32b", "kimi_decode", 8, 384, 8, 7168, True),
    ("kimi-k2-1t-a32b", "kimi_chunk", 1024, 384, 8, 7168, True),
    (JAMBA2, "jamba2_decode", 32, 16, 2, 4096, False),
    (JAMBA2, "jamba2_chunk", 512, 16, 2, 4096, False))


def _issue_us(fn, reps: int = 30) -> float:
    """Median host microseconds to issue one call (the device idle before
    each, so no full launch queue blocks the host)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _kernels_a_call(fn) -> int:
    """Kernels (and memsets, copies) one call puts on the card."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def phase_moe_dispatch(seed: int) -> list:
    """``moe_route``, ``moe_dispatch`` and ``moe_combine`` against the plain
    functions at ``MOE_DISPATCH_SHAPES``, bf16, dropless (capacity T) with
    restealing and the priority policy, as the configurations run them;
    the expert outputs random.  Fails unless the route's experts equal
    ``route_topk``'s with the same ``renormalize`` (the probabilities within
    1e-6; whether they are bitwise equal is reported), the plan equals ``priority_dispatch``'s on
    the kernel's routing (gates and aux loss within 1e-6), the buffer
    ``gather_expert_inputs``'s, and the combine the plain bits, twice."""
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    rows = []
    for path, case, t, e, k, d, renorm in MOE_DISPATCH_SHAPES:
        x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
        w = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
        logits = x.float() @ w
        y = torch.randn(e, t, d, generator=g, device="cuda").bfloat16()
        kw = dict(num_experts=e, capacity=t, resteal=True)

        def fused():
            r = md_ops.moe_route(logits, k, renormalize=renorm)
            sent = md_ops.moe_dispatch(x, r, **kw)
            return r, sent, md_ops.moe_combine(y, sent, t, k)

        def plain():
            r = md_ref.moe_route_plain(logits, k, renormalize=renorm)
            sent = md_ref.moe_dispatch_plain(x, r, **kw)
            return r, sent, md_ref.moe_combine_plain(y, sent, t, k)

        r, sent, got = fused()
        pr, psent, want = plain()
        torch.cuda.synchronize()
        if not torch.equal(r.expert_idx, pr.expert_idx):
            raise AssertionError(f"moe_route {case}: experts differ")
        route_err = max((r.gate - pr.gate).abs().max().item(),
                        (r.probs - pr.probs).abs().max().item())
        plan = priority_dispatch(*r[:3], **kw)
        same = {n: torch.equal(getattr(sent.plan, n), getattr(plan, n))
                for n in ("slot_src", "kept", "expert", "load")}
        aux = md_ref.aux_loss_plain(r.probs, plan.load, e)
        errs = dict(route=route_err,
                    gate=(sent.plan.gate - plan.gate).abs().max().item(),
                    aux=abs(sent.aux_loss.item() - aux.item()))
        combine_bits = torch.equal(
            got, md_ref.moe_combine_plain(y, sent._replace(plan=plan), t, k))
        buf_equal = torch.equal(sent.buf,
                                gather_expert_inputs(x, plan, k))
        if not (all(same.values()) and max(errs.values()) <= 1e-6
                and combine_bits and buf_equal
                and torch.equal(got, fused()[2])):
            raise AssertionError(f"moe_dispatch {case}: plan {same}, errors "
                                 f"{errs}, combine bits {combine_bits}, "
                                 f"buffer {buf_equal}")
        rows.append(dict(
            MOE_DISPATCH_KERNEL, case=f"{case}/bfloat16", path=path,
            shape=dict(T=t, E=e, k=k, C=t, D=d), renormalize=renorm,
            probs_bitwise=bool(torch.equal(r.probs, pr.probs)),
            gate_bitwise=bool(torch.equal(r.gate, pr.gate)),
            output_max_err=(got.float() - want.float()).abs().max().item(),
            max_err=max(errs.values()),
            kernels=_kernels_a_call(fused), plain_kernels=_kernels_a_call(
                plain),
            ms=_time_ms(fused), plain_ms=_time_ms(plain),
            device_ms=_device_ms(fused, reps=5),
            plain_device_ms=_device_ms(plain, reps=5),
            host_us=_issue_us(fused), plain_host_us=_issue_us(plain)))
        row = rows[-1]
        print(f"kernel moe_dispatch {row['case']} T={t} E={e} k={k} D={d} "
              f"renormalize={renorm}: "
              f"plan equal, combine bits equal; probs bitwise "
              f"{row['probs_bitwise']}, gate bitwise {row['gate_bitwise']}, "
              f"max err {row['max_err']}; kernels {row['kernels']} "
              f"(plain {row['plain_kernels']}); {row['ms']} ms (plain "
              f"{row['plain_ms']}), device {row['device_ms']} ms (plain "
              f"{row['plain_device_ms']}); host {row['host_us']} us to "
              f"issue (plain {row['plain_host_us']})")
        del x, y, logits, r, sent, got, pr, psent, want, plan
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _wkv_fp64(r, k, v, w, u, s0, heads):
    """The recurrence in fp64 for batch row 0 and ``heads``: (y, s_end)."""
    sl = (0, slice(None), heads)
    rd, kd, vd, wd = (a[sl].double() for a in (r, k, v, w))   # [T, h, N]
    ud = u[heads].double()
    s = s0[0, heads].double().clone()                         # [h, N, N]
    ys = torch.empty_like(rd)
    for t in range(rd.shape[0]):
        ys[t] = (torch.einsum("hk,hkv->hv", rd[t], s)
                 + (rd[t] * ud * kd[t]).sum(-1, keepdim=True) * vd[t])
        s = wd[t][..., None] * s + kd[t][..., None] * vd[t][:, None, :]
    return ys, s


def _within(got, want, rtol, atol=1e-4):
    """Elementwise |got - want| <= rtol |want| + atol."""
    return bool(torch.all((got.float() - want.float()).abs()
                          <= rtol * want.float().abs() + atol))


def _extreme_decay(b, t, h, n, g):
    """w = exp(-exp(x)), x ~ U(-6, 5) (fp32 w underflows to 0 past
    x ~ 4.6), with whole steps at exactly 0 and exactly 1."""
    w = torch.exp(-torch.exp(
        torch.rand(b, t, h, n, generator=g, device="cuda") * 11 - 6))
    w[:, 5:9] = 0
    w[:, 300:340] = 1
    w[:, 700] = 0
    return w


def phase_wkv6_kernel(seed: int) -> list:
    """wkv6 against its plain version at rwkv6-3b's heads (H = 40,
    N = 64).  Tolerances: y within one ulp of its type relative to the
    plain version's y (2^-7 relative for bf16, whose rounding point may fall
    either side of the two fp32 sums; 1e-4 for fp32), s_end (fp32) within
    1e-4 relative; each with 1e-4 absolute.  Every row runs twice and must
    give the same bits (each chunk takes its state from its predecessor, in
    a fixed order of operations)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    h, n = 40, 64
    cases = [("prefill", torch.bfloat16, 1, 1024, False, False),
             ("ragged_s0", torch.bfloat16, 1, 77, True, False),
             ("fp32", torch.float32, 2, 256, True, False),
             ("one_chunk", torch.bfloat16, 1, 64, True, False),
             ("chunk_and_one", torch.bfloat16, 1, 65, True, False),
             ("fast_decay", torch.bfloat16, 1, 1024, True, True)]
    rows = []
    for name, dt, b, t, nonzero_s0, extreme in cases:
        r, k, v = (torch.randn(b, t, h, n, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        w = _extreme_decay(b, t, h, n, g) if extreme else \
            0.45 + 0.5 * torch.sigmoid(
                torch.randn(b, t, h, n, generator=g, device="cuda"))
        u = 0.1 * torch.randn(h, n, generator=g, device="cuda")
        # the main path hands the kernel a zero state, not None
        s0 = torch.randn(b, h, n, n, generator=g, device="cuda") \
            if nonzero_s0 else torch.zeros(b, h, n, n, device="cuda")
        y, s = wkv_ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        y2, s2 = wkv_ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(y, y2) and torch.equal(s, s2))
        want_y, want_s = wkv6_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        rtol = 2 ** -7 if dt == torch.bfloat16 else 1e-4
        err = (y.float() - want_y.float()).abs().max().item()
        s_err = (s - want_s).abs().max().item()
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()
                and _within(y, want_y, rtol) and _within(s, want_s, 1e-4)):
            raise AssertionError(f"wkv6 {name}: y error {err}, s_end error "
                                 f"{s_err} beyond rtol {rtol} / 1e-4")
        if not same_bits:
            raise AssertionError(f"wkv6 {name}: a second call gave other "
                                 "bits")
        heads = slice(0, 4)
        y64, s64 = _wkv_fp64(r, k, v, w, u, s0, heads)
        errs64 = [(out[0, :, heads].double() - y64).abs().max().item()
                  for out in (y, want_y)]
        serrs64 = [(out[0, heads].double() - s64).abs().max().item()
                   for out in (s, want_s)]
        elt = r.element_size()
        nbytes = (4 * b * t * h * n * elt + 4 * b * t * h * n + 4 * h * n
                  + 2 * 4 * b * h * n * n)
        flops = b * t * h * (5 * n * n + 5 * n)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        ms = _time_ms(lambda: wkv_ops.wkv6(r, k, v, w, u, s0))
        rows.append(dict(
            WKV_KERNEL, case=f"{name}/{str(dt).split('.')[1]}",
            path="rwkv6-3b", shape=dict(B=b, T=t, H=h, N=n,
                                        s0="random" if nonzero_s0 else "0",
                                        decay="extreme" if extreme
                                        else "(0.45, 0.95)"),
            chunks=wkv_ops.wkv6_plan(b, t, h, n).chunks,
            max_abs_err=err, max_err=err, s_end_err=s_err,
            bitwise_equal=same_bits,
            tol=dict(y_rtol=rtol, s_end_rtol=1e-4, atol=1e-4),
            err_fp64=errs64[0], plain_err_fp64=errs64[1],
            s_end_err_fp64=serrs64[0], plain_s_end_err_fp64=serrs64[1],
            ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: wkv6_plain(r, k, v, w, u, s0), reps=5,
                              warmup=1),
            library_ms=None,
            library="none: no single PyTorch call computes WKV-6",
            device_ms=_device_ms(lambda: wkv_ops.wkv6(r, k, v, w, u, s0)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations"))
        print(f"kernel wkv6 {rows[-1]['case']} B={b} T={t}: y err {err}, "
              f"s_end err {s_err} (rtol {rtol}; against fp64 on 4 heads: "
              f"kernel {errs64[0]} / {serrs64[0]}, plain {errs64[1]} / "
              f"{serrs64[1]}; bitwise equal {same_bits}), {ms} ms, plain "
              f"{rows[-1]['plain_ms']} ms, "
              f"device {rows[-1]['device_ms']} ms, "
              f"bound {rows[-1]['bound_ms']} ms ({rows[-1]['bound_by']})")
    return rows


def phase_scan_kernel(seed: int) -> list:
    """prefix_scan against its plain version.  Tolerances: int32 exact;
    floats within 1e-6 of the row's sum of |x| (the same sums in another
    order, fp32), bf16 also within one bf16 ulp of the output (2^-7
    relative: each output is rounded to bf16).  Each case runs twice: a
    float carry's grouping follows the look-back's timing, so floats may
    differ in the last bits between runs; int32 may not."""
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases = [("bench_small", torch.float32, 4, 1024),
             ("bench_large", torch.float32, 8, 8192),
             ("many_rows", torch.float32, 4096, 4096),
             ("many_rows", torch.int32, 4096, 4096),
             ("many_rows", torch.bfloat16, 4096, 4096),
             ("few_long_rows", torch.float32, 4, 1 << 22),
             ("ragged_long_row", torch.float32, 1, (1 << 20) + 13),
             ("one_long_row", torch.float32, 1, 1 << 24),
             ("one_long_row", torch.int32, 1, 1 << 24)]
    rows = []
    for name, dt, r, n in cases:
        if dt == torch.int32:
            x = torch.randint(-50, 51, (r, n), generator=g, device="cuda",
                              dtype=torch.int32)
        else:
            x = torch.randn(r, n, generator=g, device="cuda").to(dt)
        got = scan_ops.prefix_scan(x)
        again = scan_ops.prefix_scan(x)
        torch.cuda.synchronize()
        want = prefix_scan_plain(x)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        rerun_diff = (got.double() - again.double()).abs().max().item()
        if dt == torch.int32 and not torch.equal(got, again):
            raise AssertionError(f"prefix_scan {name} int32: two runs differ "
                                 f"by {rerun_diff}")
        plan = scan_ops.scan_plan(r, n)
        err64 = plain_err64 = None
        if dt == torch.int32:
            ok, tol = torch.equal(got, want), "exact"
        else:
            bound = 1e-6 * x.float().abs().sum(-1, keepdim=True)
            rtol = 2 ** -7 if dt == torch.bfloat16 else 0.0
            ok = _within(got, want, rtol, bound)
            tol = dict(atol="1e-6 * row sum |x|", rtol=rtol)
            exact = torch.cumsum(x.double(), -1)
            err64, plain_err64 = ((out.double() - exact).abs().max().item()
                                  for out in (got, want))
            del exact
        if not ok:
            raise AssertionError(f"prefix_scan {name} {dt}: max error {err}")
        acc = acc_dtype(dt)
        nbytes = 2 * x.numel() * x.element_size()
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        # one add per element on the CUDA cores (int32 counted at the fp32
        # rate; the adds never bind here)
        t_ops = x.numel() / PEAK_FLOPS[torch.float32] * 1e3
        ms = _time_ms(lambda: scan_ops.prefix_scan(x))
        rows.append(dict(
            SCAN_KERNEL, case=f"{name}/{str(dt).split('.')[1]}",
            path=SCAN_PATH,
            shape=dict(R=r, N=n), tile=f"{plan.block}x{plan.items}",
            tiles_per_row=plan.tiles_per_row, max_abs_err=err, max_err=err,
            rerun_diff=rerun_diff, tol=tol,
            err_fp64=err64, plain_err_fp64=plain_err64, ms=ms, kernel_ms=ms,
            plain_ms=_time_ms(lambda: prefix_scan_plain(x)),
            library_ms=_time_ms(lambda: torch.cumsum(x, -1, dtype=acc)),
            library=f"torch.cumsum(x, -1, dtype={acc})",
            device_ms=_device_ms(lambda: scan_ops.prefix_scan(x)),
            library_device_ms=_device_ms(
                lambda: torch.cumsum(x, -1, dtype=acc)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations"))
        print(f"kernel prefix_scan {rows[-1]['case']} R={r} N={n} "
              f"({plan.tiles_per_row} tiles of {rows[-1]['tile']} a row): "
              f"max_err {err} ({tol}; against fp64: kernel {err64}, plain "
              f"{plain_err64}; between two runs {rerun_diff}), {ms} ms, "
              f"plain {rows[-1]['plain_ms']} ms, "
              f"cumsum {rows[-1]['library_ms']} ms; device "
              f"{rows[-1]['device_ms']} ms, cumsum "
              f"{rows[-1]['library_device_ms']} ms; bound "
              f"{rows[-1]['bound_ms']} ms ({rows[-1]['bound_by']})")
        del x, got, again, want
    torch.cuda.empty_cache()
    return rows


def phase_scan_path(seed: int) -> dict:
    """The prefix scan's path: ``prefix_scan`` on kernel_bench's fp32
    (4, 1024) and (8, 8192) and beyond_paper's int32 arange(2^14) as
    (4, 4096); int32 exact, fp32 within 1e-6 of the row's sum of |x|."""
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    inputs = [torch.randn(4, 1024, generator=g, device="cuda"),
              torch.randn(8, 8192, generator=g, device="cuda"),
              torch.arange(1 << 14, dtype=torch.int32,
                           device="cuda").reshape(4, -1)]
    _zero_counts()
    outs = [scan_ops.prefix_scan(x) for x in inputs]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    if launches != dict(dict.fromkeys(COUNTERS, 0),
                        prefix_scan=len(inputs)):
        raise AssertionError(f"prefix-scan path launches: {launches}")
    for x, out in zip(inputs, outs):
        want = prefix_scan_plain(x)
        ok = torch.equal(out, want) if x.dtype == torch.int32 else _within(
            out, want, 0.0, 1e-6 * x.abs().sum(-1, keepdim=True))
        if not ok:
            raise AssertionError(f"prefix-scan path {tuple(x.shape)} "
                                 f"{x.dtype}: wrong")
    stats = dict(arch=SCAN_PATH, inputs=[[*x.shape, str(x.dtype)]
                                         for x in inputs],
                 launches=launches)
    print("scan path: " + json.dumps(stats))
    return stats


def _prompts(rng, n, vocab, longest=1024):
    return [rng.integers(0, vocab, int(rng.integers(64, longest + 1)))
            for _ in range(n)]


class _Phase:
    """Wraps an engine call: device-synchronized seconds, calls, each
    kernel's launches (wrapper calls and kernels) inside it, and a
    finite-logits check.  While it runs, ``_Phase.current`` holds its
    ``name`` (read by ``_GmmTimer``)."""

    current = None

    def __init__(self, fn, name=None):
        self.fn, self.name, self.seconds, self.calls = fn, name, 0.0, 0
        self.launches = dict.fromkeys(COUNTERS, 0)
        self.kernel_launches = dict.fromkeys(COUNTERS, 0)

    def __call__(self, *args):
        n0 = {k: c.launches for k, c in COUNTERS.items()}
        k0 = _kernel_launches()
        t0 = time.perf_counter()
        _Phase.current = self.name
        logits, cache = self.fn(*args)
        _Phase.current = None
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        k1 = _kernel_launches()
        for k, c in COUNTERS.items():
            self.launches[k] += c.launches - n0[k]
            self.kernel_launches[k] += k1[k] - k0[k]
        return logits, cache


def phase_main_path(model, params, prompts, *, s_max, max_new, kv_mode,
                    kernels, prefill_chunk=None, name=None) -> dict:
    """Serve ``prompts`` through the engine in ``kv_mode``, in chunks of
    ``prefill_chunk`` prompt tokens if given.  ``kernels`` maps a kernel
    to its launches in one prefill call, in one decode call and, if a
    third is given, in one chunk call (0: never).  ``name`` (default the
    architecture's) names the path in the launch counts."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode=kv_mode,
                        prefill_chunk=prefill_chunk)
    prefill, decode = _Phase(eng._prefill), _Phase(eng._decode)
    eng._prefill, eng._decode = prefill, decode
    chunk = _Phase(eng._prefill_chunk or (lambda *a: None))
    if eng._prefill_chunk is not None:
        eng._prefill_chunk = chunk
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    kernel_launches = _kernel_launches()
    if not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError("not every request finished")
    if eng.paged:
        eng.alloc.check()
    layers = model.cfg.num_layers
    phases = (prefill, decode, chunk)
    for k, per_call in kernels.items():
        got = tuple(ph.launches[k] for ph in phases)
        want = tuple(n * ph.calls for n, ph in zip(per_call + (0,), phases))
        if got != want or not any(want) or launches[k] != sum(got):
            raise AssertionError(f"{k} launches: prefill, decode, chunk "
                                 f"{got}, total {launches[k]}; expected "
                                 f"{want}")
    tokens = sum(len(outs[r.rid]) for r in reqs)
    if tokens != max_new * len(reqs):
        raise AssertionError(f"{tokens} tokens for {len(reqs)} requests")
    stats = dict(arch=name or model.cfg.name, layers=layers,
                 kv_mode=eng.kv_mode,
                 requests=len(reqs), tokens=tokens, wall_s=wall,
                 tokens_per_s=tokens / wall, prefill_s=prefill.seconds,
                 prefill_calls=prefill.calls,
                 decode_steps=decode.calls,
                 decode_step_ms=decode.seconds / decode.calls * 1e3,
                 prefill_chunk=prefill_chunk, chunk_calls=chunk.calls,
                 chunk_s=chunk.seconds,
                 mamba_states={k: v for k, v in eng.io_stats.items()
                               if k.startswith("mamba_")},
                 launches_per_call=kernels,
                 launches=launches, launches_prefill=prefill.launches,
                 launches_decode=decode.launches,
                 launches_chunk=chunk.launches,
                 kernel_launches=kernel_launches,
                 kernel_launches_prefill=prefill.kernel_launches,
                 kernel_launches_decode=decode.kernel_launches,
                 kernel_launches_chunk=chunk.kernel_launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prompt_tokens=int(sum(len(p) for p in prompts)))
    print("main path: " + json.dumps(stats))
    return stats


def phase_jamba2_chunked(cfg, seed, prompts) -> dict:
    """Jamba2-Mini's equations on ``cfg``'s layers (the Mamba mixer's
    inner norms, the router's top 2 unrenormalised) served by the paged
    engine in chunks of ``JAMBA2_CHUNK``: every prompt goes through the
    chunk path, which carries each request's Mamba state from chunk to
    chunk; a prompt over one chunk takes two or more calls.  Each chunk
    call launches grouped SwiGLU and the dispatch once a MoE layer and
    flash never (a chunk attends over the paged pool through the masked
    ``_sdpa`` path, as the reference's chunk path does); each decode call
    launches flash once a superblock; every staged state is committed to
    its decode slot and none is left."""
    cfg = cfg.replace(mamba_inner_norm=True, moe_renormalize=False)
    model, params = _init(cfg, seed)
    n_sb = cfg.num_layers // cfg.attn_every
    moe = n_sb * (cfg.attn_every // cfg.moe_layer_period)
    stats = phase_main_path(
        model, params, prompts, s_max=2048, max_new=16, kv_mode="paged",
        prefill_chunk=JAMBA2_CHUNK, name=JAMBA2,
        kernels={"flash_attention": (n_sb, n_sb, 0),
                 "grouped_swiglu": (moe, moe, moe),
                 "moe_dispatch": (moe, moe, moe)})
    chunks = sum(-(-len(p) // JAMBA2_CHUNK) for p in prompts)
    want = dict(mamba_states_staged=len(prompts),
                mamba_states_committed=len(prompts), mamba_staged_bytes=0)
    if stats["chunk_calls"] != chunks or stats["prefill_calls"] \
            or stats["mamba_states"] != want:
        raise AssertionError(f"{JAMBA2}: {stats['chunk_calls']} chunk calls "
                             f"(expected {chunks}), {stats['prefill_calls']} "
                             f"whole prefills, states "
                             f"{stats['mamba_states']} (expected {want})")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_paged_equals_contiguous(model, params, prompts, s_max) -> None:
    """Each engine is freed before the next one starts (deepseek-coder-33b
    at full depth leaves room for one cache only)."""
    results = {}
    torch.cuda.reset_peak_memory_stats()
    for mode in ("contiguous", "paged"):
        eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                            block_size=16, kv_mode=mode)
        reqs = [eng.submit(p, max_new_tokens=16, priority=float(i % 3))
                for i, p in enumerate(prompts)]
        outs = eng.run_until_drained()
        if not all(r.state.name == "DONE" for r in reqs):
            raise AssertionError(f"{mode}: not every request finished")
        results[mode] = [outs[r.rid] for r in reqs]
        del eng, reqs, outs
        gc.collect()
        torch.cuda.empty_cache()
    if results["paged"] != results["contiguous"]:
        raise AssertionError(f"{model.cfg.name}: paged and contiguous "
                             "tokens differ")
    print(f"paged == contiguous ({model.cfg.name}): {len(prompts)} requests, "
          f"{sum(map(len, results['paged']))} identical tokens, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9} GB")


def _cluster_serve(model, params, prompts, *, max_new, prefill_chunk,
                   path) -> dict:
    """One live cluster run (phase_cluster (a)): two ``EngineReplica``s over
    ``model`` and its one set of weights, each engine its own paged pool,
    behind a ``ClusterRouter`` stealing half the work, placing round robin;
    a request arrives every ``ARRIVAL_EVERY`` router steps (all at once,
    every replica gets as many requests and as many decode steps, and no
    replica ever runs dry while another has a queue).
    Every engine call is wrapped in a ``_Phase`` and every replica step
    reads the counts before and after, so each launch is attributed to a
    replica and a phase; the counts are set to 0 just before the run and
    read just after.  A replica's ``submit`` is wrapped to record each
    migration: whether its payload carried KV and where its prefill
    resumed.  Checks: every request DONE with ``max_new`` tokens,
    ``alloc.check()`` on both engines, ``router.check()``, every launch
    inside a replica step, flash once a layer in every whole-prompt
    prefill and decode call of each replica (and never in a chunk prefill:
    the masked path, as in the reference), both replicas decoding."""
    engines = [ServingEngine(model, params, prefill_chunk=prefill_chunk,
                             **CLUSTER_ENGINE) for _ in range(2)]
    phases = []
    for eng in engines:
        ph = {"prefill": _Phase(eng._prefill, "prefill"),
              "decode": _Phase(eng._decode, "decode")}
        eng._prefill, eng._decode = ph["prefill"], ph["decode"]
        if eng._prefill_chunk is not None:
            ph["prefill_chunk"] = _Phase(eng._prefill_chunk, "prefill_chunk")
            eng._prefill_chunk = ph["prefill_chunk"]
        phases.append(ph)
    replicas = [EngineReplica(i, eng) for i, eng in enumerate(engines)]
    in_steps = [dict.fromkeys(COUNTERS, 0) for _ in replicas]
    steps = [0] * len(replicas)
    moves = []
    for i, rep in enumerate(replicas):
        def step(_inner=rep.step, _i=i):
            n0 = {k: c.launches for k, c in COUNTERS.items()}
            active = _inner()
            for k, c in COUNTERS.items():
                in_steps[_i][k] += c.launches - n0[k]
            steps[_i] += 1
            return active

        def submit(req, tokens=None, migrated=False, _inner=rep.submit,
                   _i=i):
            _inner(req, tokens, migrated=migrated)
            if migrated:
                moves.append(dict(thief=_i, tokens=req.prompt_len,
                                  kv=isinstance(tokens, dict)
                                  and "kv" in tokens,
                                  resumed_at=req.prefilled))
        rep.step, rep.submit = step, submit
    router = ClusterRouter(replicas, policy=StealPolicy(
        amount="half_work", placement="round_robin"),
        telemetry=ClusterTelemetry(len(replicas)))
    reqs = []
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for step in range(100_000):
        if len(reqs) < len(prompts) and step % ARRIVAL_EVERY == 0:
            p = prompts[len(reqs)]
            req = Request(prompt_len=len(p), max_new_tokens=max_new,
                          priority=float(len(reqs) % 3))
            router.submit(req, tokens=p)
            reqs.append(req)
        router.step()
        if len(reqs) == len(prompts) and router.drained():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    if not router.drained() or \
            not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError(f"{path}: not every request finished")
    for eng in engines:
        eng.alloc.check()
    router.check()
    streams = [[eng.outputs[r.rid] for eng in engines
                if r.rid in eng.outputs] for r in reqs]
    if any(len(s) != 1 or len(s[0]) != max_new for s in streams):
        raise AssertionError(f"{path}: token counts "
                             f"{[[len(x) for x in s] for s in streams]}")
    layers = model.cfg.num_layers
    per_replica = []
    for i, ph in enumerate(phases):
        got = {name: p.launches["flash_attention"] for name, p in ph.items()}
        want = {"prefill": layers * ph["prefill"].calls,
                "decode": layers * ph["decode"].calls,
                "prefill_chunk": 0}
        want = {k: v for k, v in want.items() if k in got}
        if got != want or ph["decode"].calls == 0 \
                or in_steps[i] != {k: sum(p.launches[k] for p in ph.values())
                                   for k in COUNTERS}:
            raise AssertionError(f"{path} replica {i}: flash launches "
                                 f"{got}, expected {want}; in its steps "
                                 f"{in_steps[i]}")
        per_replica.append(dict(
            steps=steps[i], launches=in_steps[i],
            phases={name: dict(calls=p.calls, seconds=p.seconds,
                               launches=p.launches)
                    for name, p in ph.items()}))
    for k in COUNTERS:
        if launches[k] != sum(r[k] for r in in_steps):
            raise AssertionError(f"{path}: {k} launched {launches[k]} "
                                 "times, not all inside replica steps")
    if prefill_chunk is None and not all(
            ph["prefill"].calls > 0 for ph in phases):
        raise AssertionError(f"{path}: a replica ran no flash prefill")
    summary = router.telemetry.summary()
    tokens = sum(len(s[0]) for s in streams)
    stats = dict(
        path=path, replicas=len(replicas), prefill_chunk=prefill_chunk,
        requests=len(reqs), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, launches=launches,
        steal_events=summary["steal_events"],
        requests_migrated=summary["requests_migrated"],
        chunk_migrations=summary["chunk_migrations"],
        weight_migrated=summary["weight_migrated"],
        kv_migrations=sum(m["kv"] and m["resumed_at"] > 0 for m in moves),
        migrations=moves, per_replica=per_replica,
        telemetry={k: summary[k] for k in ("finished", "cancelled",
                                           "rejected", "deadline_misses")},
        per_class={k: v.get("count") for k, v in
                   summary["per_class"].items()})
    print(f"cluster {path}: " + json.dumps(stats))
    return stats


def _launcher(*flags) -> tuple:
    """``repro_torch.launch.serve`` at full width in a subprocess; its
    output and seconds.  Fails unless it exits 0."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2-1.5b", *flags]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(flags)}: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, seconds


def _count(pattern: str, text: str) -> int:
    found = re.search(pattern, text)
    if found is None:
        raise AssertionError(f"no {pattern!r} in:\n{text[-3000:]}")
    return int(found.group(1))


def phase_cluster(model, params, prompts) -> dict:
    """(a) live work-stealing between two full-width engines, ``prompts``
    arriving one every ``ARRIVAL_EVERY`` router steps: chunked prefill
    (``CLUSTER_CHUNK``), so a stolen request carries its prefix KV
    (at least one must, and resume past token 0), then the same traffic
    with whole-prompt prefill, so flash runs in prefill and decode on both
    replicas; (c) the launcher's own gates at full width, as subprocesses:
    ``--chaos kill-one`` (crashes=1, replayed > 0) and ``--autoscale``
    (ups >= 1, at ``AUTOSCALE_TARGET``)."""
    out = {}
    chunked = _cluster_serve(model, params, prompts, max_new=32,
                             prefill_chunk=CLUSTER_CHUNK,
                             path="qwen2-1.5b cluster chunked")
    if chunked["requests_migrated"] == 0 or chunked["kv_migrations"] == 0:
        raise AssertionError("no migration carried prefix KV: "
                             f"{chunked['migrations']}")
    out["chunked"] = chunked
    out["whole"] = _cluster_serve(model, params, prompts, max_new=32,
                                  prefill_chunk=None,
                                  path="qwen2-1.5b cluster")
    text, seconds = _launcher("--replicas", "2", "--requests", "12",
                              "--chaos", "kill-one")
    if "OK: chaos/autoscale smoke — 12/12 finished" not in text:
        raise AssertionError(f"kill-one: no OK line\n{text[-3000:]}")
    kill = dict(seconds=seconds,
                crashes=_count(r"chaos: crashes=(\d+)", text),
                replayed=_count(r"replayed=(\d+)", text),
                tail=text.strip().splitlines()[-8:])
    if kill["crashes"] != 1 or kill["replayed"] == 0:
        raise AssertionError(f"kill-one: {kill}")
    text, seconds = _launcher("--replicas", "2", "--max-replicas", "4",
                              "--autoscale", "--requests", "16",
                              "--autoscale-target", str(AUTOSCALE_TARGET))
    if "OK: chaos/autoscale smoke — 16/16 finished" not in text:
        raise AssertionError(f"autoscale: no OK line\n{text[-3000:]}")
    auto = dict(seconds=seconds, ups=_count(r"autoscale: ups=(\d+)", text),
                peak=_count(r"peak=(\d+)", text),
                tail=text.strip().splitlines()[-8:])
    if auto["ups"] < 1:
        raise AssertionError(f"autoscale: {auto}")
    out["launcher"] = {"kill-one": kill, "autoscale": auto}
    print("cluster launcher: " + json.dumps(out["launcher"]))
    return out


def phase_cluster_kv(model, params, seed) -> list:
    """(b) the reference's ``test_paged_kv_migrates_with_stolen_chunk_
    request`` on the card: a request stolen mid-prefill with its prefix KV
    emits the tokens of an undisturbed single-engine run (a difference
    passes only as a recorded tie: a top-2 gap under TIE_REL of the
    largest |logit|).  At the reference's shape (s_max 48, chunks and
    blocks of 8, a 40-token prompt) and at the cluster's (s_max 2048,
    chunks of 256, blocks of 16, 1200 tokens)."""
    rng = np.random.default_rng(seed + 14)
    vocab = model.cfg.vocab_size
    out = []
    for s_max, chunk, bs, n in ((48, 8, 8, 40), (2048, CLUSTER_CHUNK, 16,
                                                  1200)):
        kw = dict(s_max=s_max, kv_mode="paged", prefill_chunk=chunk,
                  block_size=bs)
        long_p = rng.integers(0, vocab, n)
        victim = ServingEngine(model, params, max_batch=1, **kw)
        victim.submit(rng.integers(0, vocab, 4), 2, priority=0.0)
        req = victim.submit(long_p, 3, priority=1.0)
        for _ in range(3):
            victim.step()
        if not (0 < req.prefilled < n and req.state.name == "WAITING"):
            raise AssertionError(f"not stolen mid-prefill: {req}")
        (stolen, payload), = victim.export_waiting(target_weight=10_000)
        k, v = payload["kv"]
        if stolen is not req or not (k.is_cuda and v.is_cuda):
            raise AssertionError("the stolen request's KV did not travel "
                                 "on the card")
        victim.alloc.check()
        thief = ServingEngine(model, params, max_batch=2, **kw)
        resumed = req.prefilled
        thief.submit_request(req, payload)
        if req.prefilled != resumed:
            raise AssertionError("the thief recomputed the prefix")
        got = thief.run_until_drained()[req.rid]
        thief.alloc.check()
        victim.run_until_drained()
        ref = ServingEngine(model, params, max_batch=1, **kw)
        r = ref.submit(long_p, 3, priority=1.0)
        want = ref.run_until_drained()[r.rid]
        ties = []
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is not None:
            gap, top = _top2_gap(model, params, list(long_p) + want[:j])
            ties.append(dict(position=j, plain=want[j], migrated=got[j],
                             gap=gap, max_abs_logit=top))
            if not gap < TIE_REL * top:
                raise AssertionError(f"migrated tokens {got} against {want}"
                                     f": top-2 gap {gap}, max |logit| {top}")
        if len(got) != 3:
            raise AssertionError(f"{len(got)} tokens")
        row = dict(s_max=s_max, chunk=chunk, block_size=bs, prompt=n,
                   resumed_at=resumed, kv_shape=list(k.shape),
                   tokens=got, equal=got == want, ties=ties)
        print("cluster kv: " + json.dumps(row))
        out.append(row)
    return out


class _GmmTimer:
    """Stands in for ``models.moe.grouped_swiglu`` during a speculative
    run: calls the wrapper and records, by the ``_Phase`` it ran in, the
    dispatch rows C of each call and its device time (CUDA events around
    the call)."""

    def __init__(self, fn):
        self.fn = fn
        self.rows, self.events = {}, {}

    def __call__(self, x, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(x, *args)
        end.record()
        self.rows.setdefault(_Phase.current, set()).add(int(x.shape[1]))
        self.events.setdefault(_Phase.current, []).append((start, end))
        return out

    def summary(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, pairs in self.events.items():
            ms = [s.elapsed_time(e) for s, e in pairs]
            out[name] = dict(calls=len(ms), C=sorted(self.rows[name]),
                             mean_ms=statistics.fmean(ms),
                             median_ms=statistics.median(ms))
        return out


def _spec_run(model, params, prompts, *, s_max, max_new, spec):
    """Serve ``prompts`` through the paged engine, with ``spec`` (a
    Speculator) or without; every engine and speculator call wrapped in a
    ``_Phase``, the counts set to 0 just before the run and read just
    after.  Checks: every request DONE with ``max_new`` tokens, the
    allocator's invariants."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode="paged", speculator=spec)
    phases = {"prefill": _Phase(eng._prefill, "prefill"),
              "decode": _Phase(eng._decode, "decode")}
    eng._prefill, eng._decode = phases["prefill"], phases["decode"]
    if spec is not None:
        phases.update(warm=_Phase(spec._prefill, "warm"),
                      draft=_Phase(spec._decode, "draft"),
                      verify=_Phase(spec._verify, "verify"))
        spec._prefill, spec._decode, spec._verify = (
            phases["warm"], phases["draft"], phases["verify"])
    reqs = [eng.submit(p, max_new_tokens=max_new, priority=float(i % 3))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    if not all(r.state.name == "DONE" for r in reqs):
        raise AssertionError("not every request finished")
    eng.alloc.check()
    tokens = [outs[r.rid] for r in reqs]
    if any(len(t) != max_new for t in tokens):
        raise AssertionError(f"token counts {[len(t) for t in tokens]}, "
                             f"expected {max_new} each")
    for k in COUNTERS:
        if launches[k] != sum(ph.launches[k] for ph in phases.values()):
            raise AssertionError(f"{k}: {launches[k]} launches, not all "
                                 "inside the engine's calls")
    n = sum(map(len, tokens))
    stats = dict(tokens=n, wall_s=wall, tokens_per_s=n / wall,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=launches,
                 phases={name: dict(calls=ph.calls, seconds=ph.seconds,
                                    ms_per_call=ph.seconds / ph.calls * 1e3
                                    if ph.calls else None,
                                    launches=ph.launches,
                                    kernel_launches=ph.kernel_launches)
                         for name, ph in phases.items()})
    if spec is not None:
        stats["spec_stats"] = eng.spec_stats
    return tokens, stats, phases


def _same_share(got, want) -> float:
    """Share of tokens equal, position by position, to ``want``'s."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return same / sum(map(len, want))


def phase_spec(model, params, prompts, *, s_max, max_new, drafts,
               moe=False) -> dict:
    """Speculative decoding at full width: the plain paged engine, then one
    engine for each of ``drafts`` ((name, Speculator, least acceptance or
    None)) on the same prompts.  Checks, beyond ``_spec_run``'s: rounds >
    0; the self draft's acceptance at least its bound, a cross draft's
    wasted > 0; flash attention launched once a draft layer in every draft
    step and never in a verify call; with ``moe``, grouped SwiGLU once a layer
    in every verify call and its dispatch reaching C = B (k + 1).  The share
    of tokens equal to the plain engine's is printed, not asserted: verify
    takes the masked path, plain decode the split kernel (P rounded to
    bf16 before PV)."""
    layers = model.cfg.num_layers
    timer = _GmmTimer(moe_mod.grouped_swiglu) if moe else None
    out = {}
    plain = None
    for name, spec, least in [("plain", None, None)] + drafts:
        if timer is not None:
            timer.rows, timer.events = {}, {}
            moe_mod.grouped_swiglu = timer
        try:
            tokens, stats, ph = _spec_run(model, params, prompts,
                                          s_max=s_max, max_new=max_new,
                                          spec=spec)
        finally:
            if timer is not None:
                moe_mod.grouped_swiglu = timer.fn
        if timer is not None:
            stats["grouped_swiglu"] = timer.summary()
        if spec is None:
            plain = tokens
        else:
            s = stats["spec_stats"]
            stats["same_as_plain"] = _same_share(tokens, plain)
            if s["rounds"] == 0:
                raise AssertionError(f"{name}: no speculation round")
            if least is not None and not s["acceptance_rate"] >= least:
                raise AssertionError(f"{name}: acceptance "
                                     f"{s['acceptance_rate']} < {least}")
            if least is None and s["wasted"] == 0:
                raise AssertionError(f"{name}: the cross draft wasted "
                                     "nothing")
            draft, verify = ph["draft"], ph["verify"]
            if draft.launches["flash_attention"] != \
                    spec.draft_model.cfg.num_layers * draft.calls \
                    or verify.launches["flash_attention"] != 0:
                raise AssertionError(
                    f"{name}: flash launches {draft.launches} in "
                    f"{draft.calls} draft steps, {verify.launches} in "
                    f"{verify.calls} verify calls")
            if moe:
                want_c = len(spec.engine.slot_req) * (spec.adapt.k0 + 1)
                if verify.launches["grouped_swiglu"] != \
                        layers * verify.calls:
                    raise AssertionError(
                        f"{name}: grouped SwiGLU {verify.launches} in "
                        f"{verify.calls} verify calls")
                if want_c not in stats["grouped_swiglu"]["verify"]["C"]:
                    raise AssertionError(
                        f"{name}: verify's dispatch rows "
                        f"{stats['grouped_swiglu']['verify']['C']}, never "
                        f"{want_c}")
        out[name] = stats
        print(f"spec {model.cfg.name} {name}: " + json.dumps(stats))
    return out


def _top2_gap(model, params, context) -> tuple:
    """The target's (top-1 - top-2 logit, largest |logit|) after
    ``context``, from a prefill."""
    toks = torch.as_tensor(np.asarray(context)[None, :], device=model.device)
    logits = model.prefill(params, {"tokens": toks})[0][0, -1].float()
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def _noisy(params, scale, seed, device):
    """``params`` plus N(0, scale * std) noise on every leaf."""
    g = torch.Generator(device=device).manual_seed(seed)

    def go(tree):
        if isinstance(tree, dict):
            return {k: go(v) for k, v in tree.items()}
        std = tree.float().std().item() if tree.numel() > 1 else 0.0
        noise = torch.randn(tree.shape, generator=g, device=device)
        return (tree.float() + scale * std * noise).to(tree.dtype)
    return go(params)


def phase_spec_exact(model, params, prompts, *, s_max, max_new,
                     seed) -> dict:
    """The greedy contract on the card (fp32, flash off: plain decode and
    verify both take the masked path).  The plain engine, then a self, a
    cross (seed + 1) and a partial draft (the target's weights with seeded
    noise, the first of PARTIAL_NOISE that gives a round with 0 < matched
    < k); each must emit the plain engine's tokens.  At a request's first
    differing token the target's top-2 gap is taken: under TIE_REL of the
    row's largest |logit| it is recorded as a tie, else the phase fails.
    The self draft's acceptance must be 1."""
    plain, _, _ = _spec_run(model, params, prompts, s_max=s_max,
                            max_new=max_new, spec=None)
    out = dict(prompts=[len(p) for p in prompts], drafts={})
    rounds = []
    accept = speculative.accept_longest_prefix

    def record(proposals, target):
        accepted, matched = accept(proposals, target)
        rounds.append((matched, len(proposals)))
        return accepted, matched

    def run(name, dparams, **kw):
        rounds.clear()
        speculative.accept_longest_prefix = record
        try:
            tokens, stats, _ = _spec_run(
                model, params, prompts, s_max=s_max, max_new=max_new,
                spec=Speculator(model, dparams, k=SPEC_K, **kw))
        finally:
            speculative.accept_longest_prefix = accept
        ties = []
        for p, got, want in zip(prompts, tokens, plain):
            j = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            if j is None:
                continue
            gap, top = _top2_gap(model, params, list(p) + want[:j])
            ties.append(dict(position=j, plain=want[j], spec=got[j],
                             gap=gap, max_abs_logit=top))
            if not gap < TIE_REL * top:
                raise AssertionError(f"{name}: token {j} differs ({got[j]} "
                                     f"against {want[j]}) with a top-2 gap "
                                     f"of {gap} (max |logit| {top})")
        stats.update(ties=ties, partial_rounds=sum(
            1 for m, k in rounds if 0 < m < k), rounds_matched=list(rounds))
        out["drafts"][name] = stats
        print(f"spec exact {name}: " + json.dumps(
            dict(spec_stats=stats["spec_stats"], ties=ties,
                 partial_rounds=stats["partial_rounds"])))
        return stats

    s = run("self", params)
    if s["spec_stats"]["acceptance_rate"] != 1.0:
        raise AssertionError(f"fp32 self draft acceptance "
                             f"{s['spec_stats']['acceptance_rate']}")
    dparams = model.init(seed + 1)
    run("cross", dparams, adaptive=True)
    del dparams
    for scale in PARTIAL_NOISE:
        dparams = _noisy(params, scale, seed, model.device)
        s = run(f"partial_{scale}", dparams, adaptive=False)
        del dparams
        if s["partial_rounds"] > 0:
            break
    else:
        raise AssertionError(f"no noise of {PARTIAL_NOISE} gave a round "
                             "with 0 < matched < k")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_verify_probe(model, params, prompts, *, s_max, seed,
                       bound=None) -> dict:
    """One batch state (the prompts prefilled into the pool, every slot
    busy, mixed positions): ``verify_paged`` on c = SPEC_K + 1 tokens
    against as many sequential ``decode_step_paged`` calls, each on its own
    copy of the pool.  Per row i: max |difference| of the logits over its
    largest |logit|, and the share of equal argmaxes.  With ``bound``,
    every relative difference must be within it."""
    eng = ServingEngine(model, params, max_batch=8, s_max=s_max,
                        block_size=16, kv_mode="paged")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=16, priority=float(i % 3))
    for _ in range(64):
        if all(r is not None for r in eng.slot_req):
            break
        eng.step()
    else:
        raise AssertionError("slots never all busy")
    c = SPEC_K + 1
    b = len(eng.slot_req)
    dev = model.device
    pos = torch.as_tensor(eng.slot_pos, device=dev)
    if int(pos.max()) + c > eng.cap:
        raise AssertionError("probe positions past the ring")
    for i, r in enumerate(eng.slot_req):
        eng.alloc.ensure(r.rid, int(eng.slot_pos[i]) + c)
    table = torch.as_tensor(np.stack([eng._table_row(r.rid)
                                      for r in eng.slot_req]), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, c), generator=g,
                           device=dev)
    tokens[:, 0] = torch.as_tensor(eng.last_token[:, 0], device=dev)

    def pool():
        return PagedKVCache(eng.cache.k.clone(), eng.cache.v.clone())
    verify = model.verify_paged(params, tokens, pool(), table, pos)[0]
    cache = pool()
    rel, agree = [], []
    for i in range(c):
        step, cache = model.decode_step_paged(params, tokens[:, i:i + 1],
                                              cache, table, pos + i)
        a, d = verify[:, i].float(), step[:, 0].float()
        rel.append(((a - d).abs().max() / d.abs().max()).item())
        agree.append((a.argmax(-1) == d.argmax(-1)).float().mean().item())
    out = dict(dtype=str(model.cfg.dtype), use_flash=model.cfg.use_flash,
               positions=eng.slot_pos.tolist(), rel_max_abs_diff=rel,
               argmax_agree=agree, bound=bound)
    print(f"verify probe {model.cfg.name} {model.cfg.dtype} "
          f"flash={model.cfg.use_flash}: " + json.dumps(out))
    if bound is not None and not max(rel) <= bound:
        raise AssertionError(f"verify vs sequential decode: {rel} > {bound}")
    del eng, cache, verify
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def phase_rwkv_checks(model, params, prompts) -> dict:
    """The two checks that take paged == contiguous's place for RWKV-6 (no
    paged path), on the last logits of each prompt.

    * State hand-off, bf16: prefill(p + [t]) against prefill(p) then
      decode_step(t), within the reference's bf16 bound of 0.25.
    * Route: the kernel (use_flash) against the chunked scan.  In bf16 at
      32 layers the two routes' roundings differ by more than 0.25 on
      random weights, while each stays as far from the fp32 logits as the
      other; so the route is held in fp32 (the same weights, cast), where
      both sum the same fp32 products in other orders, within 1e-3; and in
      bf16 the kernel route's distance from the fp32 logits must stay
      within 1.5 times the scan route's."""
    cfg = model.cfg
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = _cast_tree(params, torch.float32)
    routes = {"kernel_bf16": (model, params),
              "scan_bf16": (build_model(cfg.replace(use_flash=False),
                                        model.device), params),
              "kernel_fp32": (build_model(cfg32, model.device), params32),
              "scan_fp32": (build_model(cfg32.replace(use_flash=False),
                                        model.device), params32)}
    out = dict(prompts=[len(p) for p in prompts], handoff_err=[],
               route_err_fp32=[], route_err_bf16=[],
               kernel_bf16_to_fp32=[], scan_bf16_to_fp32=[],
               handoff_bound=BF16_LOGIT_TOL, route_bound_fp32=ROUTE_TOL_FP32)
    for p in prompts:
        toks = torch.as_tensor(p[None, :], device="cuda")
        logits = {}
        for name, (m, prm) in routes.items():
            n0 = wkv_ops.wkv6.launches
            logits[name] = m.prefill(prm, {"tokens": toks})[0].float()
            launched = wkv_ops.wkv6.launches - n0
            if launched != (cfg.num_layers if m.cfg.use_flash else 0):
                raise AssertionError(f"{name}: wkv6 launched {launched} "
                                     "times in one prefill")
        _, state = model.prefill(params, {"tokens": toks[:, :-1]})
        stepped, _ = model.decode_step(params, toks[:, -1:], state,
                                       toks.shape[1] - 1)
        for x in (*logits.values(), stepped):
            if not torch.isfinite(x).all():
                raise AssertionError("non-finite logits")

        def dist(a, b):
            return (a - b).abs().max().item()
        exact = logits["kernel_fp32"]
        out["handoff_err"].append(dist(logits["kernel_bf16"],
                                       stepped.float()))
        out["route_err_fp32"].append(dist(exact, logits["scan_fp32"]))
        out["route_err_bf16"].append(dist(logits["kernel_bf16"],
                                          logits["scan_bf16"]))
        out["kernel_bf16_to_fp32"].append(dist(logits["kernel_bf16"], exact))
        out["scan_bf16_to_fp32"].append(dist(logits["scan_bf16"], exact))
    print("rwkv checks: " + json.dumps(out))
    if max(out["handoff_err"]) >= BF16_LOGIT_TOL:
        raise AssertionError(f"rwkv6-3b state hand-off: {out['handoff_err']}"
                             f" (bound {BF16_LOGIT_TOL})")
    if max(out["route_err_fp32"]) >= ROUTE_TOL_FP32:
        raise AssertionError(f"rwkv6-3b fp32 route: {out['route_err_fp32']}"
                             f" (bound {ROUTE_TOL_FP32})")
    if any(k > 1.5 * sc for k, sc in zip(out["kernel_bf16_to_fp32"],
                                         out["scan_bf16_to_fp32"])):
        raise AssertionError("rwkv6-3b bf16: the kernel route is farther "
                             "from the fp32 logits than 1.5x the scan's")
    del routes, params32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _last_token_experts(record: list):
    """Wraps ``models.moe.moe_route`` while it is in use: appends, for
    every MoE layer's routing, the last token's chosen experts (sorted)."""
    inner = moe_mod.moe_route

    def route(logits, k, alt=False, **kw):
        out = inner(logits, k, alt, **kw)
        record.append(sorted(out[0][-1].tolist()))
        return out
    return route


def phase_hybrid_handoff(model, params, prompts, bound_rel=None) -> dict:
    """The hybrid's prefill-to-decode hand-off: the last logits of
    prefill(p + [t]) against prefill(p) then decode_step(t) at position
    len(p), per prompt; prefill runs flash's
    ``mma`` route (fp32: ``fma``) and the Mamba scan, decode the ``split``
    route and the one-step recurrence.  Each MoE layer's choice of experts
    for the last token is recorded on both sides, and the layers where it
    differs (a flipped choice) are listed.  With ``bound_rel``, each
    distance must stay under ``bound_rel`` of the prompt's largest |logit|.
    In bf16 the two sides round differently (the conv's sums, the GEMMs'
    orders, flash's two routes), and at 16 layers of random weights that
    is enough to flip a near-tied expert choice, which moves the logits by
    up to their own scale, far past the reference's bf16 bound of 0.25:
    so the bf16 distances are reported, and the check is held in fp32."""
    cfg = model.cfg
    out = dict(dtype=cfg.dtype, layers=cfg.num_layers,
               prompts=[len(p) for p in prompts], err=[], max_abs_logit=[],
               flipped_moe_layers=[], bound_rel=bound_rel)
    for p in prompts:
        toks = torch.as_tensor(p[None, :], device="cuda")
        whole_route, step_route = [], []
        try:
            moe_mod.moe_route = _last_token_experts(whole_route)
            whole, _ = model.prefill(params, {"tokens": toks})
            moe_mod.moe_route = md_ops.moe_route
            _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                     toks.shape[1])
            moe_mod.moe_route = _last_token_experts(step_route)
            stepped, _ = model.decode_step(params, toks[:, -1:], cache,
                                           toks.shape[1] - 1)
        finally:
            moe_mod.moe_route = md_ops.moe_route
        if not (torch.isfinite(whole).all() and torch.isfinite(stepped).all()):
            raise AssertionError("non-finite logits")
        out["err"].append((whole.float() - stepped.float()).abs().max()
                          .item())
        out["max_abs_logit"].append(whole.float().abs().max().item())
        out["flipped_moe_layers"].append(
            [i for i, (a, b) in enumerate(zip(whole_route, step_route))
             if a != b])
    print(f"hybrid hand-off {cfg.dtype}: " + json.dumps(out))
    if bound_rel is not None and any(
            e >= bound_rel * t for e, t in zip(out["err"],
                                               out["max_abs_logit"])):
        raise AssertionError(f"{cfg.name} {cfg.dtype} hand-off: {out}")
    return out


def phase_vlm(model, params, seed, bound_abs=None, bound_rel=None) -> dict:
    """The image prefix (the engine serves a VLM text-only, as the
    reference's does): 2 requests of VLM_TEXT tokens, each with random
    ``image_embeds`` [1, num_image_tokens, vision_embed_dim] from the seed,
    prefilled in one ``Model.prefill`` call, then VLM_STEPS greedy steps of
    the contiguous ``decode_step``, with the counts set to 0 just before
    and read just after.  Checks: finite logits; flash attention once a
    layer in the prefill and in every step; other ``image_embeds`` change
    the prefill's logits (by more than 1e-3 of the largest |logit|); the
    last step's logits against a fresh prefill of the extended sequence
    (image, text and the tokens decoded), held within ``bound_abs`` (bf16:
    the reference's bound between two computations of the same logits)
    or within ``bound_rel`` of the largest |logit| (fp32)."""
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    n_img, layers = cfg.num_image_tokens, cfg.num_layers
    s_max = n_img + VLM_TEXT + VLM_STEPS
    toks = torch.randint(0, cfg.vocab_size, (2, VLM_TEXT), generator=g,
                         device="cuda")
    img, other = (torch.randn(2, n_img, cfg.vision_embed_dim, generator=g,
                              device="cuda") for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks,
                                           "image_embeds": img}, s_max)
    prefill_flash = ops.flash_attention.launches
    gen = [logits[:, -1].argmax(-1)]
    for i in range(VLM_STEPS):
        logits, cache = model.decode_step(params, gen[-1][:, None], cache,
                                          n_img + VLM_TEXT + i)
        gen.append(logits[:, -1].argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in COUNTERS.items()}
    want = dict(dict.fromkeys(COUNTERS, 0),
                flash_attention=layers * (1 + VLM_STEPS))
    if prefill_flash != layers or launches != want:
        raise AssertionError(f"image-prefix launches {launches} (prefill "
                             f"{prefill_flash}), expected {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    first = model.prefill(params, {"tokens": toks, "image_embeds": img},
                          s_max)[0].float()
    moved = (model.prefill(params, {"tokens": toks, "image_embeds": other},
                           s_max)[0].float() - first).abs().max().item()
    top0 = first.abs().max().item()
    extended = torch.cat([toks, torch.stack(gen[:-1], 1)], 1)
    fresh = model.prefill(params, {"tokens": extended, "image_embeds": img},
                          s_max)[0].float()
    err = (fresh - logits.float()).abs().max().item()
    top = fresh.abs().max().item()
    out = dict(arch=cfg.name, dtype=cfg.dtype, layers=layers,
               image_embeds=[2, n_img, cfg.vision_embed_dim], text=VLM_TEXT,
               steps=VLM_STEPS, wall_s=wall, launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               other_image_max_diff=moved, max_abs_logit_prefill=top0,
               decode_vs_prefill_err=err, max_abs_logit=top,
               same_argmax=bool(torch.equal(fresh[:, -1].argmax(-1),
                                            gen[-1])),
               bound_abs=bound_abs, bound_rel=bound_rel)
    print("vlm image prefix: " + json.dumps(out))
    if not moved > 1e-3 * top0:
        raise AssertionError(f"other image_embeds moved the logits by "
                             f"{moved} (max |logit| {top0})")
    if (bound_abs is not None and not err <= bound_abs) or \
            (bound_rel is not None and not err <= bound_rel * top):
        raise AssertionError(f"{cfg.name} {cfg.dtype}: decode after the "
                             f"image prefix is {err} from a fresh prefill "
                             f"(max |logit| {top}, bounds {bound_abs}, "
                             f"{bound_rel} relative)")
    return out


def phase_decoder(arch, rng, seed) -> tuple:
    """Main paths 5-9: ``arch`` at full width (its ``DECODERS`` depth),
    served paged with the counts held per call (flash once a layer;
    grouped SwiGLU once a layer for an MoE), then paged == contiguous on 4
    of its prompts.  Returns (model, params, prompts, stats)."""
    layers, s_max, n_req, longest, max_new = DECODERS[arch]
    cfg = get_config(arch).replace(use_flash=True)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model, params = _init(cfg, seed)
    prompts = _prompts(rng, n_req, cfg.vocab_size, longest=longest)
    n = cfg.num_layers
    kernels = {"flash_attention": (n, n)}
    if cfg.num_experts:
        kernels["grouped_swiglu"] = kernels["moe_dispatch"] = (n, n)
    stats = phase_main_path(model, params, prompts, s_max=s_max,
                            max_new=max_new, kv_mode="paged",
                            kernels=kernels)
    phase_paged_equals_contiguous(model, params, prompts[:4], s_max)
    return model, params, prompts, stats


def _no_launches(what: str) -> dict:
    """Every kernel's launch count since the last ``_zero_counts``, which
    must be 0: no kernel has a backward pass, so training runs none."""
    launches = _kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"{what}: kernels launched {launches}")
    return launches


def phase_train(seed) -> tuple:
    """Phase 10 (a, b): the launcher trains qwen2-1.5b at full width and
    depth (``TRAIN_ARGS``); the mean of the last three losses must be below
    the first, every grad norm finite, and no kernel launched.  Returns
    (stats, the model and trained params for (d))."""
    args = train_launcher.parse_args(TRAIN_ARGS + ["--seed", str(seed)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    run = train_launcher.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _no_launches("training")
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if not all(math.isfinite(g) for g in gnorms + losses):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, "
                             f"{gnorms}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_ms = [h["seconds"] * 1e3 for h in hist]
    tokens = args.global_batch * args.seq_len
    warm_ms = statistics.median(step_ms[1:])
    stats = dict(arch=run["model"].cfg.name,
                 layers=run["model"].cfg.num_layers,
                 steps=len(hist), global_batch=args.global_batch,
                 seq_len=args.seq_len, microbatches=args.microbatches,
                 losses=losses, grad_norms=gnorms,
                 lrs=[h["lr"] for h in hist], step_ms=step_ms,
                 first_step_ms=step_ms[0], step_ms_median=warm_ms,
                 tokens_per_s=tokens / warm_ms * 1e3,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 wall_s=wall, launches=launches)
    print("train: " + json.dumps(stats))
    model, params = run["model"], run["params"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return stats, model, params


def phase_train_serve(model, params, rng) -> dict:
    """Phase 10 (d): the trained weights served through the paged engine
    with flash on (4 requests, flash once a layer a call), then paged ==
    contiguous."""
    cfg = model.cfg.replace(use_flash=True, moe_dropless=True)
    serve = build_model(cfg, "cuda")
    prompts = _prompts(rng, 4, cfg.vocab_size)
    n = cfg.num_layers
    stats = phase_main_path(serve, params, prompts, s_max=2048, max_new=16,
                            kv_mode="paged",
                            kernels={"flash_attention": (n, n)})
    phase_paged_equals_contiguous(serve, params, prompts, 2048)
    return stats


def _same_trees(a, b, what: str) -> None:
    for (k, x), y in zip(tree_leaves_with_path(a), tree_leaves(b)):
        if x.dtype != y.dtype or x.device != y.device \
                or not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {k} differs")


def phase_checkpoint(seed) -> dict:
    """Phase 10 (c): qwen2-1.5b at full width, ``CKPT_LAYERS`` layers,
    after one train step: its {params, opt} saved and restored, every leaf
    ``torch.equal`` (bf16 included); then ``TrainSupervisor`` runs of
    ``SUP_STEPS`` steps under ``torch.use_deterministic_algorithms``, one
    with a ``SimulatedFailure`` at step ``SUP_FAIL``: both end with the
    same bits.  The checkpoints live in a temporary directory, removed
    after."""
    cfg = get_config("qwen2-1.5b").replace(num_layers=CKPT_LAYERS,
                                           use_flash=False)
    model = build_model(cfg, "cuda")
    params = model.init(seed)
    opt = adamw_init(params)
    step_fn = make_train_step(model)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=seed),
                        global_batch=SUP_BATCH, seq_len=SUP_SEQ)

    def batch_at(i):
        pipe.state.step = i
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in pipe.next_batch().items()}

    _zero_counts()
    params, opt, _ = step_fn(params, opt, batch_at(0), 1e-3)
    state = {"params": params, "opt": opt}
    stats = {"layers": CKPT_LAYERS}
    with tempfile.TemporaryDirectory() as tmp:
        stats["disk_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 1, state)
        stats["save_s"] = time.perf_counter() - t0
        stats["npz_gb"] = os.path.getsize(
            os.path.join(path, "state.npz")) / 1e9
        t0 = time.perf_counter()
        restored, manifest = restore_checkpoint(tmp, state)
        torch.cuda.synchronize()
        stats["restore_s"] = time.perf_counter() - t0
        if manifest["step"] != 1:
            raise AssertionError(f"manifest {manifest}")
        _same_trees(state, restored, "restored checkpoint")
        del restored
        shutil.rmtree(path)
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for tag, inject in (("clean", False), ("faulty", True)):
                start = {"params": tree_map(torch.clone, params),
                         "opt": tree_map(torch.clone, opt)}
                tripped = []

                def step(s, i, inject=inject, tripped=tripped):
                    if inject and i == SUP_FAIL and not tripped:
                        tripped.append(i)
                        raise SimulatedFailure("injected")
                    p, o, _ = step_fn(s["params"], s["opt"], batch_at(i),
                                      1e-3)
                    return {"params": p, "opt": o}

                mgr = CheckpointManager(os.path.join(tmp, tag), keep=1)
                sup = TrainSupervisor(mgr, step, start, ckpt_every=SUP_EVERY)
                t0 = time.perf_counter()
                final, end = sup.run(start, SUP_STEPS)
                torch.cuda.synchronize()
                runs[tag] = final
                stats[f"{tag}_s"] = time.perf_counter() - t0
                stats[f"{tag}_restarts"] = sup.restarts
                if end != SUP_STEPS or sup.restarts != int(inject):
                    raise AssertionError(f"{tag}: ended at {end} after "
                                         f"{sup.restarts} restarts")
                del start, final
                shutil.rmtree(os.path.join(tmp, tag))
        finally:
            torch.use_deterministic_algorithms(False)
    _same_trees(runs["clean"], runs["faulty"], "recovered run")
    stats["launches"] = _no_launches("checkpoint phase")
    print("checkpoint: " + json.dumps(stats))
    return stats


def phase_train_moe(seed) -> dict:
    """Phase 10 (e): mixtral-8x22b at full width, ``MOE_TRAIN_LAYERS``
    layer(s), ``MOE_TRAIN_STEPS`` steps with capacity-limited dispatch (as
    the launcher sets it): the loss finite, ``moe_aux`` among the metrics,
    no kernel launched (grouped SwiGLU included)."""
    cfg = get_config("mixtral-8x22b").replace(
        num_layers=MOE_TRAIN_LAYERS, moe_dropless=False, use_flash=False)
    model = build_model(cfg, "cuda")
    params = model.init(seed)
    opt = adamw_init(params)
    step_fn = make_train_step(model)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=seed),
                        global_batch=8, seq_len=512)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    metrics, step_ms = [], []
    for _ in range(MOE_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in pipe.next_batch().items()}
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, MOE_TRAIN_LR)
        metrics.append({k: float(v) for k, v in m.items()})
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _no_launches("MoE training")
    if not all(math.isfinite(m["loss"]) and "moe_aux" in m
               for m in metrics):
        raise AssertionError(f"MoE training metrics: {metrics}")
    stats = dict(arch=cfg.name, layers=cfg.num_layers,
                 params=sum(x.numel() for x in tree_leaves(params)),
                 metrics=metrics, step_ms=step_ms,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=launches)
    print("train moe: " + json.dumps(stats))
    return stats


def _encdec_batch(cfg, b, src, tgt, seed, dtype) -> dict:
    """Source embeddings [b, src, audio_embed_dim] and target tokens
    [b, tgt], from a seeded generator on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    embeds = torch.randn(b, src, cfg.audio_embed_dim, generator=g,
                         device="cuda").to(dtype)
    tokens = torch.randint(0, cfg.vocab_size, (b, tgt), generator=g,
                           device="cuda")
    return {"src_embeds": embeds, "tokens": tokens}


def _encdec_greedy(model, params, batch, steps) -> dict:
    """``make_prefill_step`` at ENCDEC_S_MAX, then ``steps`` greedy
    ``make_decode_step`` calls at a scalar position, with the counts set to
    0 just before the prefill and read around every call.  Returns the
    tokens [B, steps + 1], the first decode step's logits, each step's
    (top-1 - top-2, largest |logit|) per row, the prefill's and each
    step's seconds and the launches of the prefill and of each step."""
    prefill = make_prefill_step(model, ENCDEC_S_MAX)
    decode = make_decode_step(model)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: c.launches for k, c in COUNTERS.items()}
    if not torch.isfinite(logits).all():
        raise AssertionError("encdec prefill: non-finite logits")
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].int()
    toks, gaps, step_s, step_launches, first = [tok], [], [], [], None
    pos = batch["tokens"].shape[1]
    for i in range(steps):
        n0 = {k: c.launches for k, c in COUNTERS.items()}
        t0 = time.perf_counter()
        tok, logits, cache = decode(params, tok, cache, pos + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append({k: c.launches - n0[k]
                              for k, c in COUNTERS.items()})
        last = logits[:, -1].float()
        if not torch.isfinite(last).all():
            raise AssertionError(f"encdec decode step {i}: non-finite "
                                 "logits")
        if first is None:
            first = last.clone()
        top = torch.topk(last, 2).values
        gaps.append(torch.stack([top[:, 0] - top[:, 1],
                                 last.abs().amax(-1)], 1))
        toks.append(tok)
    return dict(tokens=torch.cat(toks, 1).cpu(), first=first,
                gaps=torch.stack(gaps).cpu(), prefill_s=prefill_s,
                step_s=step_s, prefill_launches=prefill_launches,
                step_launches=step_launches)


def _encdec_first_tie(flash, plain) -> list:
    """Each row's first differing token between two greedy runs, with the
    plain run's top-2 gap there; fails unless the gap is under TIE_REL of
    that row's largest |logit| (a tie)."""
    ties = []
    for row, (a, b) in enumerate(zip(flash["tokens"].tolist(),
                                     plain["tokens"].tolist())):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        if j == 0:
            raise AssertionError(f"fp32 row {row}: the prefill's tokens "
                                 "differ (no kernel runs there)")
        gap, top = plain["gaps"][j - 1, row].tolist()
        ties.append(dict(row=row, position=j, flash=a[j], plain=b[j],
                         gap=gap, max_abs_logit=top))
        if not gap < TIE_REL * top:
            raise AssertionError(f"fp32 row {row}: token {j} differs "
                                 f"({a[j]} against {b[j]}) with a top-2 "
                                 f"gap of {gap} (max |logit| {top})")
    return ties


def phase_encdec(seed) -> dict:
    """Phase 11: seamless-m4t-medium whole, random bf16 weights from
    ``seed``.  (a) B = 8 sources of 1024 frames, prompts of 16 tokens,
    prefill at s_max 256 and 128 greedy decode steps with flash on: logits
    finite, flash once a decoder layer in every decode step and never in
    the prefill (the reference's routing), no other kernel.  (b) The same
    with flash off on the same weights: the first decode step's logits
    within ENCDEC_BF16_REL of their largest |logit|, the share of equal
    tokens reported.  (c) An fp32 copy of the weights, flash against
    plain over 32 steps: identical tokens, a difference passing only as a
    tie (``phase_spec_exact``'s contract).  (d) 3 train steps (B = 4, 512
    source frames, 128 target tokens, bf16 weights, fp32 moments, remat,
    flash off as in the reference): the loss finite and falling, no kernel
    launched."""
    cfg = get_config("seamless-m4t-medium").replace(use_flash=True)
    model, params = _init(cfg, seed)
    layers = cfg.num_layers
    batch = _encdec_batch(cfg, ENCDEC_B, ENCDEC_SRC, ENCDEC_PROMPT, seed,
                          torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    flash = _encdec_greedy(model, params, batch, ENCDEC_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(flash["prefill_launches"].values()):
        raise AssertionError(f"encdec prefill launched "
                             f"{flash['prefill_launches']}")
    want = dict.fromkeys(COUNTERS, 0) | {"flash_attention": layers}
    bad = [i for i, n in enumerate(flash["step_launches"]) if n != want]
    if bad:
        raise AssertionError(f"encdec decode step {bad[0]} launched "
                             f"{flash['step_launches'][bad[0]]}, expected "
                             f"{want}")
    launches = {k: sum(n[k] for n in flash["step_launches"])
                for k in COUNTERS}
    wall = flash["prefill_s"] + sum(flash["step_s"])
    stats = dict(arch=cfg.name, layers=layers,
                 encoder_layers=cfg.num_encoder_layers, batch=ENCDEC_B,
                 src_frames=ENCDEC_SRC, prompt=ENCDEC_PROMPT,
                 s_max=ENCDEC_S_MAX, steps=ENCDEC_STEPS,
                 tokens=ENCDEC_B * ENCDEC_STEPS,
                 tokens_per_s=ENCDEC_B * ENCDEC_STEPS / wall, wall_s=wall,
                 prefill_ms=flash["prefill_s"] * 1e3,
                 decode_step_ms=statistics.median(flash["step_s"]) * 1e3,
                 decode_tokens_per_s=ENCDEC_B * ENCDEC_STEPS
                 / sum(flash["step_s"]),
                 peak_mem_gb=peak, launches=launches,
                 launches_prefill=flash["prefill_launches"])
    print("encdec serve: " + json.dumps(stats))

    plain = _encdec_greedy(build_model(cfg.replace(use_flash=False), "cuda"),
                           params, batch, ENCDEC_STEPS)
    if any(plain["prefill_launches"].values()) or any(
            any(n.values()) for n in plain["step_launches"]):
        raise AssertionError("encdec plain route launched a kernel")
    rel = ((flash["first"] - plain["first"]).abs().max()
           / plain["first"].abs().max()).item()
    if not rel <= ENCDEC_BF16_REL:
        raise AssertionError(f"encdec bf16 first decode step: flash and "
                             f"plain logits differ by {rel} of the largest "
                             f"|logit| > {ENCDEC_BF16_REL}")
    stats["plain"] = dict(
        first_step_rel_diff=rel, bound_rel=ENCDEC_BF16_REL,
        same_token_share=(flash["tokens"] == plain["tokens"]).float()
        .mean().item(),
        tokens_per_s=ENCDEC_B * ENCDEC_STEPS
        / (plain["prefill_s"] + sum(plain["step_s"])),
        decode_step_ms=statistics.median(plain["step_s"]) * 1e3)
    print("encdec plain route: " + json.dumps(stats["plain"]))
    del flash, plain

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = _cast_tree(params, torch.float32)
    batch32 = dict(batch, src_embeds=batch["src_embeds"].float())
    runs = {name: _encdec_greedy(build_model(cfg32.replace(use_flash=f),
                                             "cuda"),
                                 params32, batch32, ENCDEC_EXACT_STEPS)
            for name, f in (("flash", True), ("plain", False))}
    ties = _encdec_first_tie(runs["flash"], runs["plain"])
    stats["fp32_exact"] = dict(
        steps=ENCDEC_EXACT_STEPS, ties=ties,
        first_step_rel_diff=((runs["flash"]["first"]
                              - runs["plain"]["first"]).abs().max()
                             / runs["plain"]["first"].abs().max()).item(),
        flash_launches=sum(n["flash_attention"]
                           for n in runs["flash"]["step_launches"]))
    print("encdec fp32 exact: " + json.dumps(stats["fp32_exact"]))
    del params32, batch32, runs
    gc.collect()
    torch.cuda.empty_cache()

    stats["train"] = _encdec_train(build_model(cfg.replace(use_flash=False),
                                               "cuda"), params, seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _encdec_train(model, params, seed) -> dict:
    """Phase 11 (d): ENCDEC_TRAIN_STEPS steps of ``make_train_step`` on one
    batch (labels = the target tokens), updating ``params`` in place."""
    batch = _encdec_batch(model.cfg, ENCDEC_TRAIN_B, ENCDEC_TRAIN_SRC,
                          ENCDEC_TRAIN_TGT, seed + 11, torch.bfloat16)
    batch["labels"] = batch["tokens"]
    opt = adamw_init(params)
    step_fn = make_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for _ in range(ENCDEC_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, ENCDEC_TRAIN_LR)
        losses.append(float(m["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _no_launches("encdec training")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"encdec training losses {losses}")
    stats = dict(batch=ENCDEC_TRAIN_B, src_frames=ENCDEC_TRAIN_SRC,
                 target_tokens=ENCDEC_TRAIN_TGT, lr=ENCDEC_TRAIN_LR,
                 remat=model.cfg.remat, losses=losses, step_ms=step_ms,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=launches)
    print("encdec train: " + json.dumps(stats))
    del opt
    return stats


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _md_steps(model, params, batch, s_max):
    """``train.step``'s prefill, then ``MD_STEPS`` greedy decode steps:
    (every step's logits as plain tensors, tokens, prefill ms, decode ms
    of each step)."""
    prefill = make_prefill_step(model, s_max)
    decode = make_decode_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    full = [logits.full_tensor() if hasattr(logits, "full_tensor")
            else logits]
    nxt = torch.argmax(full[0][:, -1], -1)[:, None].int()
    if hasattr(logits, "full_tensor"):
        nxt = distribute_tensor(nxt, logits.device_mesh,
                                batch["tokens"].placements)
    toks, step_ms = [], []
    s = batch["tokens"].shape[1]
    for i in range(MD_STEPS):
        t0 = time.perf_counter()
        nxt, lg, cache = decode(params, nxt, cache, torch.tensor(s + i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        full.append(lg.full_tensor() if hasattr(lg, "full_tensor") else lg)
        toks.append(nxt.full_tensor() if hasattr(nxt, "full_tensor")
                    else nxt)
    return full, torch.cat(toks, 1), pre_ms, step_ms


def phase_multidevice(seed: int) -> dict:
    """Phase 12: (a) qwen2-1.5b at full width as DTensors on a one-rank
    NCCL mesh against the same steps on plain tensors; (b)
    ``compressed_allreduce`` over that group; (c) the production dry run
    in a subprocess (a fake world and NCCL cannot share the default
    group)."""
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        # (a) the steps on the mesh, bit for bit against plain tensors
        cfg = get_config("qwen2-1.5b").replace(activation_sharding=True,
                                               use_flash=False)
        model, params = _init(cfg, seed)
        placed = distribute(params, param_shardings(params, mesh))
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (MD_PROMPTS, MD_PROMPT_LEN),
            dtype=np.int32)).cuda()
        s_max = MD_PROMPT_LEN + MD_STEPS
        placed_tokens = distribute_tensor(tokens, mesh, list(placements_for(
            batch_spec(mesh) + (None,), mesh)))
        _zero_counts()
        runs = {}
        # in turns: plain, DTensor, DTensor, plain
        for route, p, tok in (("plain", params, tokens),
                              ("dtensor", placed, placed_tokens),
                              ("dtensor_again", placed, placed_tokens),
                              ("plain_again", params, tokens)):
            runs[route] = _md_steps(model, p, {"tokens": tok}, s_max)
        launches = _no_launches("phase 12 (a)")
        plain = runs["plain"]
        for route in ("dtensor", "dtensor_again", "plain_again"):
            other = runs[route]
            equal = [torch.equal(a, b) for a, b in zip(plain[0], other[0])]
            if not all(equal) or not torch.equal(plain[1], other[1]):
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(plain[0], other[0]))
                raise AssertionError(
                    f"phase 12 (a): {route} logits differ from the plain "
                    f"ones on a one-rank mesh: equal {equal}, max |diff| "
                    f"{diff}")
        out["qwen_one_rank"] = {
            "prompts": MD_PROMPTS, "prompt_len": MD_PROMPT_LEN,
            "steps": MD_STEPS, "logits_bit_equal": True,
            "launches": launches,
            **{f"{r}_prefill_ms": runs[r][2] for r in runs},
            **{f"{r}_decode_ms_median": statistics.median(runs[r][3])
               for r in runs}}
        print(f"phase 12 (a): qwen2-1.5b on a one-rank NCCL mesh, "
              f"{MD_PROMPTS} x {MD_PROMPT_LEN} prompts, {MD_STEPS} greedy "
              f"steps: logits bit-equal to plain tensors; prefill ms "
              + ", ".join(f"{r} {runs[r][2]}" for r in runs)
              + "; decode step ms (median) "
              + ", ".join(f"{r} {statistics.median(runs[r][3])}"
                          for r in runs))
        shapes = [(k, tuple(v.shape)) for k, v in tree_leaves_with_path(
            params)]
        out["qwen_one_rank"]["param_bytes"] = sum(
            v.numel() * v.element_size() for v in tree_leaves(params))
        del model, params, placed, placed_tokens, runs, plain, other
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the compressed all-reduce on qwen's full shapes, fp32
        g = torch.Generator(device="cuda").manual_seed(seed + 12)
        grads = {k: torch.randn(sh, generator=g, device="cuda")
                 for k, sh in shapes}
        error = {k: torch.randn(sh, generator=g, device="cuda") * 1e-3
                 for k, sh in shapes}
        times = []
        for _ in range(MD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduced, new_err = compressed_allreduce(grads, error, mesh,
                                                    "data")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        for k in grads:
            target = grads[k] + error[k]
            q = target.to(torch.bfloat16).float()
            if not (torch.equal(reduced[k], q)
                    and torch.equal(new_err[k], target - q)):
                raise AssertionError(f"phase 12 (b): {k} is not bf16(g + e)"
                                     f" and its residual")
        n = sum(x.numel() for x in grads.values())
        out["compress"] = {"elements": n, "ms_median": statistics.median(
            times), "ms": times, "bit_exact": True}
        print(f"phase 12 (b): compressed_allreduce over a one-rank NCCL "
              f"group, {n} fp32 gradients (qwen2-1.5b's shapes): bf16(g + "
              f"e) and its residual bit-exact; ms {times}")
        del grads, error, reduced, new_err
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (c) the production dry run on fake 256/512-rank worlds
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dryrun.json"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--dryrun-cells", str(path)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            raise AssertionError(f"phase 12 (c): the dry run failed:\n"
                                 f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
        cells = json.loads(path.read_text())
    for rec in cells:
        want = out["qwen_one_rank"]["param_bytes"] \
            if rec["arch"] == "qwen2-1.5b" else _tree_bytes(rec["arch"])
        if rec["status"] != "ok" or rec["param_bytes"] != want:
            raise AssertionError(f"phase 12 (c): {rec}")
        print(f"phase 12 (c): {rec['arch']} x {rec['shape']} on "
              f"{rec['mesh']} ({rec['route']}): ok, param bytes "
              f"{rec['param_bytes']}, per-device argument bytes "
              f"{rec['argument_bytes']}, collective bytes "
              f"{rec['collective_bytes']}"
              + (f" (by kind at one period: "
                 f"{rec['collective_kinds_one_period']})"
                 if "collective_kinds_one_period" in rec else "")
              + f", {rec['seconds']} s")
    out["dryrun"] = {"cells": cells,
                     "seconds": time.perf_counter() - t0}
    return out


def _tree_bytes(arch: str) -> int:
    """A config's parameter bytes from its shape-only init."""
    with FakeTensorMode():
        params = build_model(get_config(arch), "cpu").init(0)
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def dryrun_cells(path: str) -> None:
    """Phase 12 (c), in its own process: each of ``DRYRUN_CELLS`` traced on
    a fake world, whole or (``DRYRUN_ANALYZED``) through the 1- and
    2-period points of ``analyze_cell``, whose extrapolated counts it
    reports; per-device argument bytes from the placed full-depth step."""
    from repro_torch.launch import analyze, dryrun, input_specs
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    cells = []
    for arch, shape, multi in DRYRUN_CELLS:
        t0 = time.perf_counter()
        if shape not in DRYRUN_ANALYZED:
            rec = dryrun.run_cell(arch, shape, multi)
            rec["route"] = "whole step traced"
            rec["argument_bytes"] = rec["memory"]["argument_bytes"]
        else:
            cfg = get_config(arch)
            cell = input_specs.shape_by_name(shape)
            with fake_world(512 if multi else 256):
                mesh = make_production_mesh(multi_pod=multi)
                nbytes = _tree_bytes(arch)
                fsdp = dryrun.fsdp_axes(mesh, nbytes, "tp")
                n_micro = input_specs.train_microbatches(cfg, cell)
                _, args = dryrun.build_step(cfg, cell, mesh, fsdp, "tp",
                                            cell.global_batch, n_micro)
                res = analyze.analyze_cell(cfg, cell, mesh, fsdp)
            ex = res["extrapolated"]
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if multi else "16x16",
                   "kind": cell.kind, "status": "ok",
                   "route": "analyze_cell, 1- and 2-period points",
                   "param_bytes": nbytes, "fsdp": bool(fsdp),
                   "flops": ex["flops"], "bytes_accessed": ex["bytes"],
                   "collective_bytes": {"total": ex["coll_bytes"]},
                   "collective_kinds_one_period": ex["collective_kinds"],
                   "argument_bytes": dryrun._local_bytes(args),
                   "points": res["points"], "n_micro": res["n_micro"]}
        rec["seconds"] = time.perf_counter() - t0
        cells.append(rec)
        print(json.dumps(rec), flush=True)
    Path(path).write_text(json.dumps(cells))


def _example(name: str):
    """``examples_torch/<name>.py`` as a module (the examples are scripts,
    not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples_full_width(model, params) -> dict:
    """Phase 13 (b): the serving examples' own functions on main path 1's
    full-width qwen2-1.5b (bf16, flash, paged): their asserts hold (every
    request done, the cancelled one never computed, both replicas finished
    work, steals > 0), ``alloc.check()`` on every engine, and flash launched
    once a layer a call (a multiple of the layers), with the counts set to 0
    just before each example and read just after."""
    layers = model.cfg.num_layers
    out = {}
    for name in ("serve_requests", "serve_cluster"):
        serve = _example(name).serve
        _zero_counts()
        t0 = time.perf_counter()
        res = serve(model, params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _kernel_launches()
        calls = ops.flash_attention.launches
        if name == "serve_requests":
            engines = [res["eng"]]
            reqs = res["interactive"] + res["batchy"]
            m = res["eng"].batcher.metrics
            stats = {k: m[k] for k in ("merged_prefills", "evicted_dead",
                                       "steps")}
        else:
            engines = [rep.engine for rep in res["replicas"]]
            reqs = res["reqs"]
            summary = res["router"].telemetry.summary()
            stats = {"steal_events": summary["steal_events"],
                     "requests_migrated": summary["requests_migrated"],
                     "finished_per_replica": [
                         r["finished"] for r in summary["per_replica"]]}
        for eng in engines:
            if not eng.paged:
                raise AssertionError(f"example {name}: engine not paged")
            eng.alloc.check()
        if calls == 0 or calls % layers:
            raise AssertionError(f"example {name}: {calls} flash launches, "
                                 f"not once a layer a call ({layers})")
        tokens = sum(r.generated for r in reqs)
        out[name] = {"seconds": seconds, "tokens": tokens,
                     "tokens_per_s": tokens / seconds, "flash_calls": calls,
                     "launches": launches, **stats}
        print(f"phase 13 (b): example {name} at full width: {tokens} "
              f"tokens in {seconds} s, flash {calls} calls "
              f"({launches['flash_attention']} kernels), {stats}")
    return out


def _example_run(script: str, *args, timeout: int) -> dict:
    """Phase 13 (a): ``examples_torch/<script>`` as a user runs it, on the
    card by default.  Fails unless it exits 0."""
    cmd = [sys.executable, str(EXAMPLES / script), *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.perf_counter() - t0
    label = " ".join([script, *args])
    tail = out.stdout.strip().splitlines()[-4:]
    print(f"phase 13 (a): examples_torch/{label}: exit {out.returncode} in "
          f"{seconds} s")
    for line in tail:
        print(f"    {line}")
    if out.returncode != 0:
        raise AssertionError(f"examples_torch/{label}: exit "
                             f"{out.returncode}\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    return {"seconds": seconds, "stdout": out.stdout}


def _train_steps(stdout: str) -> dict:
    """The launcher's printed steps: step -> (loss, ms)."""
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in re.finditer(r"^step\s+(\d+) loss=(\S+) .* (\d+)ms ",
                                 stdout, re.M)}


def phase_examples() -> dict:
    """Phase 13 (a): every example as a user runs it, each in its own
    process on the card: quickstart, serve_requests, serve_cluster,
    compose_workloads --spec, then train_lm --hundred-m (the ~131M model,
    ``EXAMPLE_TRAIN_STEPS``) and again with ``EXAMPLE_RESUME_STEPS`` on the
    same checkpoint directory, which must resume and reach its last step
    with a finite loss."""
    runs = {}
    for script, *args in (("quickstart.py",), ("serve_requests.py",),
                          ("serve_cluster.py",),
                          ("compose_workloads.py", "--spec")):
        runs[" ".join([script, *args])] = {
            "seconds": _example_run(script, *args, timeout=300)["seconds"]}
    ckpt = tempfile.mkdtemp(prefix="example_ckpt_")
    try:
        for steps, resumed in ((EXAMPLE_TRAIN_STEPS, None),
                               (EXAMPLE_RESUME_STEPS, EXAMPLE_TRAIN_STEPS)):
            res = _example_run("train_lm.py", "--hundred-m", "--steps",
                               str(steps), "--ckpt-dir", ckpt, timeout=600)
            text = res["stdout"]
            printed = _train_steps(text)
            last = printed.get(steps - 1)
            if last is None or not math.isfinite(last[0]):
                raise AssertionError(f"train_lm --steps {steps}: step "
                                     f"{steps - 1} not printed with a finite "
                                     f"loss:\n{text[-3000:]}")
            said = re.search(r"resumed from step (\d+)", text)
            if (int(said.group(1)) if said else None) != resumed:
                raise AssertionError(f"train_lm --steps {steps}: expected "
                                     f"resume from {resumed}, printed "
                                     f"{said and said.group(0)}")
            params = re.search(r"params=([\d,]+)", text)
            runs[f"train_lm.py --hundred-m --steps {steps}"] = {
                "seconds": res["seconds"], "resumed_from": resumed,
                "params": int(params.group(1).replace(",", "")),
                "steps_printed": {s: {"loss": loss, "ms": ms}
                                  for s, (loss, ms) in printed.items()}}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return runs


def _init(cfg, seed):
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"model: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"d_ff={cfg.d_ff} experts={cfg.num_experts}/"
          f"{cfg.num_experts_per_tok} window={cfg.sliding_window} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, {n_params} params, init "
          f"{time.perf_counter() - t0} s, allocated "
          f"{torch.cuda.memory_allocated() / 1e9} GB")
    return model, params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun-cells", metavar="PATH",
                    help="phase 12 (c)'s own process: trace the dry run's "
                         "cells and write them to PATH")
    args = ap.parse_args()
    if args.dryrun_cells:
        dryrun_cells(args.dryrun_cells)
        return 0
    # cuBLAS's deterministic workspace (read when its first handle is made)
    # for phase 10's bit-exact recovery under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = phase_device()
    phase_build()
    flash_rows = phase_kernels(args.seed)
    phase_flash_probe()
    gmm_rows = phase_gmm_kernel(args.seed)
    moe_rows = phase_moe_dispatch(args.seed)
    wkv_rows = phase_wkv6_kernel(args.seed)
    scan_rows = phase_scan_kernel(args.seed)
    scan_path = phase_scan_path(args.seed)
    rng = np.random.default_rng(args.seed)

    # main path 1: qwen2-1.5b at full depth
    cfg = get_config("qwen2-1.5b").replace(use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 16, cfg.vocab_size)
    layers = cfg.num_layers
    qwen = phase_main_path(model, params, prompts, s_max=2048, max_new=32,
                           kv_mode="paged",
                           kernels={"flash_attention": (layers, layers)})
    phase_paged_equals_contiguous(model, params, prompts[:4], 2048)
    cluster = phase_cluster(model, params, prompts)
    spec = dict(probe={})
    cross = model.init(args.seed + 1)
    spec["qwen2-1.5b"] = phase_spec(
        model, params, prompts[:8], s_max=2048, max_new=32, drafts=[
            ("self", Speculator(model, params, k=SPEC_K), SELF_ACCEPT_MIN),
            ("cross", Speculator(model, cross, k=SPEC_K, adaptive=True),
             None)])
    del cross
    spec["probe"]["bf16_flash"] = phase_verify_probe(
        model, params, prompts[:8], s_max=2048, seed=args.seed)
    # phase 13 (b): the serving examples at full width, with the kernels
    examples = {"full_width": phase_examples_full_width(model, params)}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # the greedy contract on the card: qwen2-1.5b at full width, 4 layers,
    # fp32, flash off (verify and plain decode on the same masked path)
    cfg = get_config("qwen2-1.5b").replace(
        num_layers=4, dtype="float32", param_dtype="float32",
        use_flash=False)
    model, params = _init(cfg, args.seed)
    spec["qwen2-1.5b_fp32_exact"] = phase_spec_exact(
        model, params, prompts[:4], s_max=2048, max_new=16, seed=args.seed)
    # KV migration keeps the tokens: the same weights, flash on
    fp32_runs = {}
    cluster["kv_exact"] = _fp32_run(
        fp32_runs, "qwen2-1.5b fp32 kv migration",
        lambda: phase_cluster_kv(build_model(cfg.replace(use_flash=True),
                                             "cuda"), params, args.seed))
    spec["probe"]["fp32"] = phase_verify_probe(
        model, params, prompts[:8], s_max=2048, seed=args.seed,
        bound=PROBE_TOL_FP32)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main path 2: Mixtral-8x22B at full width, 8 of its 56 layers
    cfg = get_config("mixtral-8x22b").replace(num_layers=8, use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 8, cfg.vocab_size, longest=512)
    layers = cfg.num_layers
    mixtral = phase_main_path(model, params, prompts, s_max=1024,
                              max_new=16, kv_mode="paged",
                              kernels={"flash_attention": (layers, layers),
                                       "grouped_swiglu": (layers, layers),
                                       "moe_dispatch": (layers, layers)})
    phase_paged_equals_contiguous(model, params, prompts[:4], 1024)
    spec["mixtral-8x22b"] = phase_spec(
        model, params, prompts, s_max=1024, max_new=16, moe=True, drafts=[
            ("self", Speculator(model, params, k=SPEC_K, adaptive=False),
             MOE_SELF_ACCEPT_MIN)])
    spec["probe"]["mixtral_bf16_flash"] = phase_verify_probe(
        model, params, prompts, s_max=1024, seed=args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # the same probe in fp32 at full width, 2 of 56 layers, through the
    # kernels (fp32 grouped SwiGLU at verify's C = 40 and decode's C = 8,
    # flash's split decode): what bf16 rounding hides must hold here
    cfg = get_config("mixtral-8x22b").replace(
        num_layers=2, dtype="float32", param_dtype="float32", use_flash=True)
    model, params = _init(cfg, args.seed)
    spec["probe"]["mixtral_fp32_flash"] = _fp32_run(
        fp32_runs, "mixtral-8x22b fp32 verify probe",
        lambda: phase_verify_probe(model, params, prompts, s_max=1024,
                                   seed=args.seed, bound=PROBE_TOL_FP32))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main path 3: rwkv6-3b at full depth and width, contiguous state cache
    cfg = get_config("rwkv6-3b").replace(use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 8, cfg.vocab_size)
    rwkv = phase_main_path(model, params, prompts, s_max=2048, max_new=32,
                           kv_mode="contiguous",
                           kernels={"wkv6": (cfg.num_layers, 0)})
    phase_rwkv_checks(model, params, prompts[:4])
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main path 4: jamba-v0.1-52b at full width, 2 of its 4 superblocks
    cfg = get_config("jamba-v0.1-52b").replace(num_layers=JAMBA_LAYERS,
                                               use_flash=True)
    model, params = _init(cfg, args.seed)
    prompts = _prompts(rng, 8, cfg.vocab_size)
    n_sb = cfg.num_layers // cfg.attn_every
    moe = n_sb * (cfg.attn_every // cfg.moe_layer_period)
    jamba = phase_main_path(model, params, prompts, s_max=2048, max_new=16,
                            kv_mode="paged",
                            kernels={"flash_attention": (n_sb, n_sb),
                                     "grouped_swiglu": (moe, moe),
                                     "moe_dispatch": (moe, moe)})
    phase_paged_equals_contiguous(model, params, prompts[:4], 2048)
    handoff = {"bf16": phase_hybrid_handoff(model, params, prompts[:4]),
               "bf16_bound": BF16_LOGIT_TOL}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # the same 16 layers with Jamba2-Mini's equations, prefilled in chunks
    jamba2 = phase_jamba2_chunked(cfg, args.seed, prompts)
    # the hand-off held in fp32: 1 superblock at full width (53 GB, alone)
    cfg = cfg.replace(num_layers=cfg.attn_every, dtype="float32",
                      param_dtype="float32")
    model, params = _init(cfg, args.seed)
    handoff["fp32"] = _fp32_run(
        fp32_runs, "jamba-v0.1-52b fp32 hand-off",
        lambda: phase_hybrid_handoff(model, params, prompts[:4],
                                     bound_rel=HANDOFF_TOL_FP32))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # main paths 5-9: the remaining decoders at full width, each freed
    # before the next, with its own follow-up phases
    decoders, vlm = {}, {}
    arch = "qwen3-8b"      # then speculation with a qwen2-1.5b draft
    model, params, prompts, decoders[arch] = phase_decoder(arch, rng,
                                                           args.seed)
    dcfg = get_config("qwen2-1.5b").replace(use_flash=True)
    dmodel = build_model(dcfg, "cuda")
    dparams = dmodel.init(args.seed + 1)
    _, s_max, _, _, max_new = DECODERS[arch]
    spec[arch] = phase_spec(
        model, params, prompts[:8], s_max=s_max, max_new=max_new,
        drafts=[("qwen2-1.5b", Speculator(dmodel, dparams, k=SPEC_K,
                                          adaptive=True), None)])
    del model, params, dmodel, dparams
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("deepseek-coder-33b", "mistral-large-123b"):
        model, params, _, decoders[arch] = phase_decoder(arch, rng,
                                                         args.seed)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    arch = "internvl2-26b"   # then its image prefix
    model, params, _, decoders[arch] = phase_decoder(arch, rng, args.seed)
    vlm["bf16"] = phase_vlm(model, params, args.seed,
                            bound_abs=BF16_LOGIT_TOL)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    arch = "kimi-k2-1t-a32b"   # then grouped SwiGLU's rows at 384 experts
    model, params, _, decoders[arch] = phase_decoder(arch, rng, args.seed)
    moe = _layer(params["blocks"], 0)["moe"]
    w = (moe["w_gate"], moe["w_up"], moe["w_down"])
    e, d = model.cfg.num_experts, model.cfg.d_model
    k = model.cfg.num_experts_per_tok
    g = torch.Generator(device="cuda").manual_seed(args.seed + 21)
    gmm_rows += _gmm_rows(
        [(arch, "kimi_decode", *_routed(g, 8, e, d, torch.bfloat16, k=k), w),
         (arch, "kimi_prefill_512",
          *_routed(g, 512, e, d, torch.bfloat16, k=k), w)],
        plain_experts=PLAIN_EXPERTS)
    del model, params, moe, w
    gc.collect()
    torch.cuda.empty_cache()
    # the image-prefix check held in fp32: 4 of 48 layers at full width
    cfg = get_config("internvl2-26b").replace(
        num_layers=4, dtype="float32", param_dtype="float32", use_flash=True)
    model, params = _init(cfg, args.seed)
    vlm["fp32"] = _fp32_run(
        fp32_runs, "internvl2-26b fp32 image prefix",
        lambda: phase_vlm(model, params, args.seed,
                          bound_rel=PROBE_TOL_FP32))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # phase 10: training, then the trained weights served
    train, model, params = phase_train(args.seed)
    train["served"] = phase_train_serve(model, params, rng)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    train["checkpoint"] = phase_checkpoint(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    train["moe"] = phase_train_moe(args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11: the encoder-decoder, served through the step functions
    encdec = phase_encdec(args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 12: multi-device (a one-rank mesh, and the fake-world dry run)
    multidevice = phase_multidevice(args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 13 (a): every example as a user runs it
    examples["runs"] = phase_examples()

    # each row carries its kernel's launches on the path it was sized for
    # (the synthetic-mask rows: the path whose heads they use; the fp32
    # flash and grouped-SwiGLU rows: the fp32 phases' calls on their route);
    # the cluster runs serve qwen2-1.5b, so their launches are added into
    # the qwen rows' count; the image-prefix runs, the trained weights'
    # serving run and the serving examples' full-width runs are listed
    # under their own names only
    by_path = {p["arch"]: p["launches"]
               for p in (qwen, mixtral, rwkv, jamba, jamba2,
                         *decoders.values(),
                         scan_path, encdec)}
    cluster_runs = {cluster[k]["path"]: cluster[k]["launches"]
                    for k in ("chunked", "whole")}
    own_runs = {f"internvl2-26b image prefix {k}": v["launches"]
                for k, v in vlm.items()}
    own_runs["qwen2-1.5b trained, served"] = train["served"]["launches"]
    for name, run in examples["full_width"].items():
        own_runs[f"example {name}"] = run["launches"]
    rows = flash_rows + gmm_rows + moe_rows + wkv_rows + scan_rows
    for row in rows:
        if "kernel_route" in row and row["case"].endswith("/float32"):
            n = {run: c[(row["name"], row["kernel_route"])]
                 for run, c in fp32_runs.items()}
            row["launches"] = sum(n.values())
            row["launches_by_path"] = {r: k for r, k in n.items() if k}
            continue
        row["launches"] = by_path[row["path"]][row["name"]]
        row["launches_by_path"] = {
            p: n[row["name"]]
            for p, n in {**by_path, **cluster_runs, **own_runs}.items()
            if n[row["name"]]}
        if row["path"] == "qwen2-1.5b":
            row["launches"] += sum(n[row["name"]]
                                   for n in cluster_runs.values())
    print(json.dumps({"kernels": rows, "spec": spec, "cluster": cluster,
                      "hybrid_handoff": handoff, "vlm": vlm,
                      "decoders": decoders, "train": train,
                      "encdec": encdec, "multidevice": multidevice,
                      "examples": examples}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpu_nexus_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,parity  # a subset, for quick checks

Phases, one JSON line each (in the order of ``PHASES``); any failure
raises and exits non-zero:

1. device       — the card's name, count and power limit; TF32 is switched
   off for matmuls and cuDNN so f32 comparisons mean f32.
2. build        — compile the CUDA kernels from ``tpu_nexus_torch/csrc``
   (one ``nvcc`` per source, all started together); the bf16 flash
   kernels' (forward, dQ, dK/dV) and kernel #4's bf16 and int8-KV
   instantiations' (at D 64 and 128), the bf16 grouped-matmul kernels'
   (#7 with either rhs layout, #8), #5's int8 and #6's int4 ring kernels'
   (and the first design they keep for other shapes) and #9's registers, local memory
   (spills and stack), shared memory and the count of ``HGMMA`` (wgmma),
   ``HMMA`` (mma.sync), ``UTMALDG`` (TMA load), ``LDGSTS`` (cp.async),
   ``I2F``/``I2FP`` (int -> float) and 128-bit global load and store
   instructions in their SASS, read by the toolkit's ``cuobjdump``; fails
   without it, where a flash or grouped-matmul kernel lacks wgmma or TMA
   or has mma.sync, where #4 or a ring kernel of #5 or #6 lacks an
   asynchronous ring or tensor-core dots, where #5's ring kernel converts
   weights with I2F, where #9 lacks 128-bit loads or stores, or where any of
   them (every instantiation of #4 and #9) spills.
3. parity       — the forward and decode kernels against their plain
   PyTorch versions at the training and serving paths' shapes, bf16 and
   f32 (the forward also at S 1, 127, 129 and 383, GQA groups 1, 4 and 8,
   D 64, causal and full; each forward case run twice, bit-identical);
   the int8 and int4 dequant-matmul kernels at the Llama-3-8B decode
   step's (K, N) with M = 8, at nexus_moe's (K 1024, N 1024 and 512), at
   M = 1, 40 and 256 and at unaligned shapes,
   int4 at groups 64 and 128 (and 2 and K), each run twice bit-identical,
   each case naming the kernel its launch counter saw (int8 bf16: the ring
   kernel, or the first design for N 200 and 71; int4 bf16: the ring
   kernel, or the pitch branch for N 200 and 71 and group 2; each of the
   four must be reached);
   the decode kernel's int8-KV mode at the serve shape, kv_len 4096, q_len
   4 and ragged.  Every decode case runs twice, bit-identical; they cover
   q_len 8 x GQA 8 (64 query rows), GQA 1 and 8, D 64, and one row's 8 kv
   heads over 4096 slots (a launch that merges >= 8 splits).
4. train_parity — the backward kernels (dQ, dK/dV) against the plain
   backward: nexus_1b's B8 S2048 Hq16 Hkv8 D128, Llama-3-8B heads at S512,
   S200 (unaligned), D64 and non-causal, and S 64, 65, 127, 129 and 200 at
   GQA groups 1, 2 and 4, D 64 and 128, causal and not; bf16 and f32; each
   backward run twice is bit-identical.
5. moe_parity   — the grouped-matmul kernels (#7 gmm, also on rhsᵀ as the
   backward's d_lhs call; #8 tgmm) against their plain versions at the
   nexus_moe train step's shapes (m_pad 36864, bm 512, uneven expert runs,
   one expert holding only its padding tile), a bm-128 layout and
   Mixtral-8x7B's gate (K 4096, N 14336), bf16 and f32, each run twice
   bit-identical; tgmm writes zeros for an expert with no tile.  Edge
   cases, all three calls in bf16 and f32, each twice bit-identical: K and
   N not multiples of 64 (K 200 N 72; K 1000 N 1336), K of one slab (64)
   and under one (8), M of one tile (fewer work units than SMs), an
   unsorted tile_expert, expert ids outside [0, E) (gmm writes zeros),
   and 300 experts (tgmm past its ranked table).
6. times        — per-launch time (CUDA events) at the main paths' shapes
   (the kernels line reports the flash forward and backward at nexus_1b's
   training shape, decode at the serve step's), the bound, the plain
   version's time and the ``library_ms`` yardstick
   (``scaled_dot_product_attention`` and its backward, timed here only;
   the port never calls them).  The backward is also timed whole
   (``flash_attention_bwd``: dsum, q̃ and both kernels) and at nexus_moe's
   attention shape (Hq8 Hkv4).  For the dequant-matmul kernels the shape is
   the step's largest launch (K4096 x N14336, M8; both also at w_down,
   wq/wo and wk/wv, and at nexus_moe's wq/wo and wk/wv) and the yardstick
   is ``torch.matmul`` with the
   pre-dequantized bf16 weight; for int8-KV
   decode, ``scaled_dot_product_attention`` on a dequantized cache.  For
   the grouped matmul, the nexus_moe train step's four products and
   Mixtral's gate; the yardstick is ``torch._grouped_mm`` with group
   offsets where this PyTorch takes the layout, else a loop of
   ``torch.matmul`` over the expert runs.
7. e2e          — Llama-3-8B widths at 2 layers in f32: greedy ``generate``
   with the kernels is token-identical to ``generate`` with the plain
   versions — with plain weights, with int8 weights + an int8 KV cache,
   and with int4 weights.
8. train_e2e    — nexus_1b widths at 2 layers in f32: 3 training steps
   through the kernels agree with 3 steps through dense attention.
9. moe_train_e2e — nexus_moe widths at 2 layers in f32, dispatch gmm: 3
   training steps through the kernels agree with 3 steps through the
   plain versions (dense attention, plain grouped matmul); nothing dropped;
   the derived launches.
10. serve        — ``run_serving`` on ``llama3_8b`` at full width and depth
   with bf16 params (batch 8, prompt 128, 32 new tokens, 3 rounds) into an
   in-memory ledger; the launch counters, zeroed just before, show the
   path went through the forward and decode kernels.
11. serve_quant  — ``run_serving`` on ``llama3_8b`` at full width and depth
   (bf16 params, batch 8, prompt 128, 32 new tokens, 3 rounds), once with
   ``quantize="int8", quantize_kv="int8"`` and once with
   ``quantize="int4"``: COMPLETED, exactly 7 x layers x decode-steps
   dequant-matmul launches each, all of the int8 or int4 ring kernel,
   decoded tokens/s, weight bytes, peak memory.
12. serve_moe   — ``run_serving`` on ``nexus_moe`` at full width and depth
   (batch 8, prompt 128, 32 new tokens, 3 rounds): COMPLETED with exact
   flash and decode launches; greedy ``generate`` at 2 layers in f32 is
   token-identical between kernels and plain.
13. train       — ``run_workload`` on ``nexus_1b`` at full width and depth
   (bf16, adamw, remat attn_out, batch 8, seq 2048, 20 steps) into an
   in-memory ledger: COMPLETED, tokens/s, MFU against the 989 TFLOP/s bf16
   peak, peak memory, and 14 launches per step of each of the flash
   forward, dQ and dK/dV kernels.
14. train_moe   — ``run_workload`` on ``nexus_moe`` at full width and depth
   (bf16, dispatch gmm, adamw, remat attn_out, batch 8, seq 2048, 20
   steps): COMPLETED, exactly 72 gmm, 24 tgmm and 8 of each flash kernel
   per step, ``dropped_frac`` 0, tokens/s, MFU, peak memory.
15. engine_parity — kernel #4's paged (block-table) and ``q_starts`` modes
   against ``decode_attention_plain`` at Llama-3-8B heads: pages 4, 16, 32
   and 64, shuffled tables with a scratch block, staggered per-row lengths,
   q_len 1-5, every combination of paged x ragged x int8-KV in bf16 and
   f32, each run twice bit-identical, and f32 at 4096 slots and q_len 5
   against the plain version evaluated in f64; kernel #9 (RMSNorm) at [1024, 4096]
   and [16384, 2048], H 8192, H 100 and 2056, one row and 100 rows, an f32
   and a bf16 weight, bf16 and f32 x, each run twice bit-identical.
   (``times`` adds paged decode and ragged verify at q_len 5, each at
   kv_len 144 and 4096, and RMSNorm at [16384, 2048] and [1024, 4096].)
16. engine_e2e  — Llama-3-8B widths at 2 layers in f32, greedy:
   ``ServingEngine`` is token-identical to one-shot ``generate`` through
   the kernels and through the plain path — contiguous, paged (page 16),
   paged + int8-KV, speculative (spec_k 4, ngram) and decode_steps 4.
17. serve_engine — ``run_serve_engine`` on ``llama3_8b`` at full width and
   depth, bf16 (8 slots, prompt 128, 32 new tokens, 3 rounds): (a)
   contiguous, (b) page 32 with a shared 120-token prefix (prefix hits,
   extend through the paged kernel), (c) page 32 with spec_k 4 (ngram):
   COMPLETED, tokens/s, TTFT/TPOT p50/p99, prefix hits and kernel #4's
   launches by mode (paged > 0 in (b) and (c), ragged > 0 in (c)).
18. train_ckpt  — tensor checkpoints through ``run_workload`` on nexus_1b at
   full width, 2 of its 14 layers (bf16, adamw, remat attn_out, batch 8, seq 2048) in
   a temporary directory: 12 steps uninterrupted; checkpoint_every 4 and
   cancelled after step 6 (PREEMPTED, emergency save at 6); resumed from 6
   to COMPLETED at 12; step 12 bit-flipped and restarted (rolled back to 8,
   ``12.corrupt``).  Resumed per-step losses equal the uninterrupted run's
   bit for bit; a launch a layer and step of each flash kernel; the bytes and
   seconds of every save, commit and verified restore.
19. serve_reload — ``run_serving`` on nexus_1b from that directory restores
   step 12 (equal to the resumed run's params in memory, and its greedy
   tokens equal to theirs); then an engine over step 12 hot-swaps a newly
   committed step 13 through ``_reload_if_newer``: one swap, 16 requests
   FINISHED, pre- and post-swap tokens each the own of their params.
20. fleet        — three fused paged replicas of nexus_1b at full width and
   depth (bf16, page 32, 32 slots) behind the ``pressure`` router, then
   ``round-robin``: the reference's 48-request fan-out (a shared 96-token
   prefix, unique 32-token tails, 32 new tokens) all FINISHED with the
   tokens of an engine given the same requests in the same order as its
   replica, 47 fleet-wide prefix hits on one replica under ``pressure``;
   then ``kill_replica`` mid-burst accounts every live request with its
   cause.
21. disagg       — llama3_8b at full width, 8 of its 32 layers (bf16 params), one
   prefill and two decode replicas on one params tree, bf16 KV and int8
   KV: 8 requests of the reference's long-prompt / long-generation mix,
   each prefilled, handed through the host and installed: tokens equal a
   fused engine's, 8 handoffs, 0 fallbacks (uninstrumented: tokens/s
   and launches); payload bytes and extract / seal / validate / install
   ms per handoff from a separate timed run; then ``handoff-drop`` and
   ``kill-mid-handoff`` drills (the retry, the hop, no silent drop).  The
   handoff of a sharded replica runs in serve_sharded (f), on that
   phase's ranks.
22. fleet_rollout — nexus_1b (bf16, 2 of 14 layers), three paged replicas rolled from step
   1 to step 2 through ``CheckpointWatcher`` + ``start_rollout`` while 24
   requests are in flight: converged, every request FINISHED on one step's
   own tokens, post-swap tokens step 2's own; a step 3 flipped between
   poll and load aborts with ``rollout_error``, the fleet stays at 2.
23. serve_moe_quant — ``run_serving`` on nexus_moe at full width and depth
   (bf16 params, batch 8, prompt 128, 32 new tokens, 3 rounds) with int8
   weights + int8 KV and with int4 weights (group 64), then Mixtral-8x7B
   widths at 4 of its 32 layers with int4 weights (one round): COMPLETED,
   exactly 4 x layers x decode steps ring launches of #5 or #6 (wq, wk,
   wv, wo; the expert stacks are dequantized), weight bytes, peak memory;
   the time of dequantizing one Mixtral expert stack; greedy ``generate``
   at nexus_moe widths, 2 layers, f32, int8 + int8 KV and int4: kernels
   against plain, token-identical.
24. quant_gate   — nexus_moe trained on the gates' corpus (batch 32 x 2048,
   ``QUANT_GATE_STEPS``), then both gates' measurements
   (``tpu_nexus_torch/tools``): fails unless the model trained (ppl < 256)
   and every gate passes.  With control_plane it runs on a thread beside
   that phase's last three containers and cql_ledger's (the card busy,
   the host starting them).
25. profile_hook — ``NEXUS_PROFILE_DIR`` through the entry points:
   ``run_serve_engine`` on nexus_moe (int8 weights, page 32, 8 slots, 24
   requests, window [4, 12)) and ``run_workload`` training nexus_moe (6
   steps, window [2, 4)): each window DONE with no failure, one Chrome
   trace whose kernels name the path's hand-written kernels (#4 and the
   int8 ring; gmm, tgmm and the flash backward); the card's busy share and
   device ms by group from each trace.
26. control_plane — the launch-to-verdict chain (``Launcher`` -> a
   ``FakeKubeClient`` plane with the real informers -> a supervisor built by
   ``ApplicationServices`` from ``load_config(SupervisorConfig)`` over an
   sqlite ledger) around four real containers, ``python -m
   tpu_nexus_torch.workload`` subprocesses on the card with the composed
   manifest's command and env, nexus_1b at full width and depth, in this
   order: (b) a real CUDA out-of-memory -> ``TO_FAIL_HBM_OOM`` from the
   pod's termination message and from the raw torch line alone, FAILED
   with the trace ref, Job deleted; (d) a clean 4-step train run COMPLETED
   with nothing flagged, and its peak memory, by which (b)'s batch needed
   at least twice the card; (a) a fault exit 137 at step 3 of 6 -> FAILED
   (fatal), Job deleted, its trace naming #1-#3; (c) serve-engine, 16
   requests, COMPLETED, its trace naming #1 and #4 ((d), (a) and (c)
   beside quant_gate).  Then a line of numbers:
   launch-to-RUNNING, the supervisor's decision latency, each container's
   wall seconds and start-up share, tokens/s (reported, not claimed).
27. cql_ledger   — a serve-engine container (nexus_1b, 16 requests) on the
   reference's default ``cql-store-type: scylla`` (no
   ``NEXUS__CQL_STORE_TYPE``), pointed at ``CqlResponder``: exit 0, its row
   COMPLETED with heartbeats, its wall seconds and ledger round trips.
28. fleet_supervisor — ``FleetSupervisor`` reconciling three nexus_1b
   replicas (full width and depth, bf16, page 32, 32 slots) over a
   ``FakeKubeClient`` plane, fleet and supervisor built from a
   ``ServeConfig`` env by ``build_fleet_supervisor``, its ledger the port's ``ScyllaCqlStore``
   against ``CqlResponder`` (a CQL v4 responder on 127.0.0.1): (a) the pod
   holding the most live requests deleted mid-traffic -> every casualty
   FAILED with the replica-lost cause, the pod recreated, later requests
   FINISHED; (b) a real CUDA out-of-memory's text in a pod's termination
   message -> HBM OOM, the pod recreated with its KV blocks halved, serving
   through the smaller pool; (c) ``NEXUS_SLO_*`` and
   ``NEXUS_AUTOSCALE_MIN/MAX`` 3/4: a paused replica's sheds -> SATURATED
   -> scale up, the new replica serves, idle -> scale down with nothing
   evicted.  Tokens equal engines given the same requests alone; the
   ledger rows read back over the wire; one line of numbers (reconcile ms,
   seconds from the deletion and from the scale-up decision to a routed
   request's first token on the new pod while the whole fleet ticks, ms a
   ledger write, launches, peak memory).
29. serve_sharded — one serve-engine replica across tensor/expert-parallel
   ranks (``serving/sharded.py``): three ranks, every one on cuda:0 over
   gloo under the explicit one-device rehearsal map (``nvidia-smi -L``
   names the cards; which collectives gloo takes on CUDA tensors is
   probed first, and the seam's must be among them). (a) llama3_8b at
   full width, 8 of its 32 layers, bf16, page 32, 8 slots, 8 requests of 128 + 32
   through ``run_serve_engine`` with ``serve_mesh="tp=2"``: COMPLETED,
   per-rank launches of #1 and #4 paged and peak memory, tokens/s and TPOT
   p50 (two ranks sharing one card through host memory: not a
   tensor-parallel speed); then the first 8 requests again with the
   collectives timed (per step: calls, bytes, ms), the share of their
   greedy tokens equal to the one-device engine's, and their logits
   teacher-forced along the one-device stream, no farther from the f32
   evaluation of the weights than the one-device run's; (b) nexus_1b at 4
   of 14 layers, f32 compute, contiguous and paged with int8 KV: tokens
   identical to one device; (c) llama3_8b at 8 of 32 layers with int8 +
   int8 KV and int4: every rank's products on #5/#6's ring kernels,
   logits as in (a); (d) nexus_moe at ep 2 (logits equal to one device's)
   and tp 2; (e) nexus_1b at 4 layers: a mid-traffic swap to a committed
   step by reference and a fleet of two tp-2 replicas rolled 1 -> 2 (the
   serve-engine container whose spawned worker is killed runs in
   serve_multiprocess (e), beside that phase's other drills); (f) the KV
   handoff of a sharded pool: llama3_8b (bf16, ``DISAGG_LAYERS`` layers,
   page 32) from a tp-2 prefill replica to a tp-2 decode replica, tokens
   equal to the fused tp-2 replica's, one handoff a request, no fallback,
   each rank's #1 and #4 launches, the payload bytes and the extract /
   seal / validate / install ms a handoff; nexus_1b f32 (4 layers) from a
   tp-2 to a one-device replica and back, tokens identical to one device's;
   (g) ``run_serve_engine`` at tp 2 with the model drafter (self-draft,
   spec_k 4, page 32): nexus_1b f32 tokens equal to one device's, llama3_8b
   (8 layers) COMPLETED with its acceptance rate and each rank's #4
   ``q_starts`` launches; then #5/#6 at every rank shape against plain
   (ring, twice bit-identical) and #1, #4 paged, #4 ``q_starts`` (the
   verify, held against plain twice bit-identical), #5, #6 timed there.
30. train_sharded — parallel training (``parallel/{mesh,collectives,ring,
   ulysses}.py``, ``workload/train.py``'s ``Layout``): ranks on cuda:0 over
   gloo under the rehearsal map, the collectives gloo refuses on CUDA
   tensors probed and staged through host memory (the probe and (b) run
   while (a)'s containers do). (b) nexus_1b at 4 of 14
   layers in f32: fsdp 2, tp 2, sp 2 ring, sp 2 Ulysses and fsdp 2 x tp 2
   each match the one-device step (loss and grad norm within 1e-5
   relative, the gradients within 1e-5 x max|ref|); (a) the main
   path: two ``python -m tpu_nexus_torch.workload`` containers
   (``NEXUS_NUM_PROCESSES=2``, the default mesh: fsdp over both) train
   nexus_1b at full width and depth, bf16, 2 steps of 8 x 2048 with a save
   at the last: ledger COMPLETED with ``host0/chip0`` and ``host1/chip0``,
   #1-#3 launched 14 a step on each rank, step 1's loss against one
   device's, the collectives and bytes a step, peak memory, tokens/s (a
   rehearsal), and the saved step restored onto fsdp 2 equal leaf for
   leaf to its one-device restore; (c) #1-#3 at the rank shapes (fsdp 2
   B4 S2048, the ring's B8 S1024 diagonal and off-diagonal blocks,
   Ulysses' B8 S2048 Hq8 Hkv4) against plain, twice bit-identical, timed.
31. train_pp_ep — pipeline- and expert-parallel training on cuda:0 over
   gloo: (a) nexus_1b pp 2 and (b) nexus_moe gmm ep 2, two containers
   each, (c) seven meshes' f32 gradients against one device beside them,
   (d) #1-#3 at the pipeline's microbatch and #7/#8 at an ep-2 rank's
   layout against plain, timed.
32. serve_multiprocess — serving across launched processes and over a
   replicate axis, every rank on cuda:0 over gloo: (a) the main path,
   llama3_8b (bf16 params, 8 of 32 layers) as one tp-2 replica over two
   containers (``NEXUS_NUM_PROCESSES=2``, one rank each): the row
   COMPLETED with host0/chip0 and host1/chip0, written once by the
   coordinator, each rank's #1 and #4 launches and the greedy tokens equal
   to the in-container tp-2 replica's on the same requests, slots and seed;
   (b) nexus_moe (4 of 8 layers) ``dp=2,ep=2`` in one container: tokens equal ep 2's, the
   copies' launches equal, each expert sum over its copy's region; (c)
   nexus_1b f32 (4 layers) tp 2 over two containers and ``pp=2,tp=2`` in
   one: tokens identical to one device's, and, in a separate step before
   the leading container's entry point closes its pool, teacher-forced
   logits within 1e-5 x max|ref|; (d) the lockstep loop over two
   containers: each process's tokens equal a one-process run's; (e)
   SIGTERM to both containers of a tp-2 replica lands PREEMPTED, both exit
   0; a SIGKILLed worker container fails the leader's within
   ``NEXUS_DIST_TIMEOUT_S``, and a SIGKILLed spawned shard worker of a
   one-container tp-2 replica fails that container, each row FAILED naming
   rank 1.  Every container of (a)-(d) runs the workload's own ``main()``
   (``serve_container``: recording around it), those of (e) ``python -m
   tpu_nexus_torch.workload``.

Opt-in: ``profile`` — one warm ``generate`` round of the serve shape under
``torch.profiler``: device time by kernel group and the device's busy
share (``python3 chip_smoke.py --phases build,profile``); ``train_profile``
— the same for two warm steps of the train phase's shape
(``--phases build,train_profile``); ``profile_int8`` and ``profile_int4`` —
``profile`` with the serve_quant phase's two configurations (no finalize
kernel may be among their top kernels);
``train_moe_profile`` — ``train_profile`` for train_moe's shape;
``decode_probe`` — kernel #4 (bf16, contiguous) across q_len x GQA at kv_len
144 and 4096, then built again from copies of its source with one and two
producer warps in place of four, timed at the serve step's and kv 4096's
shapes in every mode (``--phases build,decode_probe``); ``quant_rms_times``
— only the dequant-matmul and RMSNorm rows of ``times``, to compare two
trees of the package in one call (``--phases device,quant_rms_times``);
``int4_probe`` and ``int8_probe`` — what sets the pace of #6's and #5's ring
kernels: edited rebuilds (stage geometries, ring-only streams) timed beside
the shipped build (``--phases build,int8_probe``); ``ckpt_probe`` — where a
nexus_1b checkpoint's seconds go (device-to-host copies, ``torch.save``,
fsync, one SHA-256 pass, ``torch.load``, host-to-device copies;
``--phases device,ckpt_probe``).

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``tpu_nexus_torch`` beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "parity", "train_parity", "moe_parity", "engine_parity", "times", "e2e", "train_e2e",
          "moe_train_e2e", "engine_e2e", "serve", "serve_quant", "serve_moe", "serve_engine", "train", "train_moe",
          "train_ckpt", "serve_reload", "fleet", "disagg", "fleet_rollout", "serve_moe_quant", "quant_gate",
          "profile_hook", "control_plane", "cql_ledger", "fleet_supervisor", "serve_sharded", "train_sharded",
          "train_pp_ep", "serve_multiprocess")
#: the phases quant_gate runs beside when control_plane runs (see ``main``)
BESIDE_QUANT_GATE = ("control_plane", "cql_ledger")
#: phases run only when named in --phases
OPT_IN = ("profile", "profile_int8", "profile_int4", "train_profile", "train_moe_profile", "decode_probe",
          "quant_rms_times", "int4_probe", "int8_probe", "ckpt_probe")
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, f32 CUDA
# core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {  # dtype -> (out, lse) max-abs tolerance
    "bfloat16": (2e-2, 1e-3),
    "float32": (1e-5, 1e-5),
}
#: bf16 limit on the worst query row's relative L2 error, |out-ref|/|ref|
#: over head_dim.  At long KV the outputs are averages over thousands of
#: rows and shrink to ~0.02, where the max-abs limit is a typical value;
#: dropping or mis-rescaling one 64-row KV tile moves a row by ~10%.
ROW_REL_TOL = 1e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card, measured
    once with CUDA events (the spin counts clock cycles, and the clock is
    the card's own)."""
    import torch

    if spin_cycles_per_ms.value is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        spin_cycles_per_ms.value = 20_000_000 / start.elapsed_time(end)
    return spin_cycles_per_ms.value


spin_cycles_per_ms.value = None


def timed(fns, iters: int = 40, warmup: int = 4):
    """``(ms, enqueue_ms)`` per call over ``iters`` calls, cycling through
    ``fns`` (one closure per input copy, so a working set larger than L2
    stays cold the way a per-layer caller finds it).  ``ms`` is time on the
    card: a spin kernel holds the stream while the host enqueues all the
    timed calls, so a wrapper whose host side takes longer than its kernel
    (allocations, the ctypes call) is not timed by its host side.
    ``enqueue_ms`` is that host side, per call.  The reading is kept only if
    the spin was still running when the last call had been enqueued;
    otherwise the spin is lengthened and the run repeated, and a reading
    that cannot be taken that way raises."""
    import torch

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 * iters + 1.0
    for _ in range(4):
        torch.cuda.synchronize()
        gate, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        gate.record()
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        held = not gate.query()  # the spin outlasted the enqueueing
        end.record()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters, enqueue_ms / iters
        spin_ms = 2.0 * enqueue_ms + 1.0
    raise RuntimeError(
        f"enqueueing {iters} calls ({enqueue_ms:.1f} ms) outlasted the spin four times: "
        "the reading would be the host's time, not the card's"
    )


def cuda_ms(fns, iters: int = 40, warmup: int = 4) -> float:
    """Mean ms on the card per call (see :func:`timed`)."""
    return timed(fns, iters, warmup)[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref, floor_frac: float = 0.0) -> float:
    """Worst relative L2 error over the last (head_dim) axis.  With
    ``floor_frac`` each row's norm is floored at that fraction of the
    largest row norm: a gradient row that cancels to ~0 in exact arithmetic
    (dQ of the first causal query, where dP equals dsum) has no scale of
    its own, and the max-abs limit judges it."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norms = ref.float().norm(dim=-1)
    floor = max(floor_frac * float(norms.max()), 1e-30)
    return float((diff / norms.clamp_min(floor)).max())


# -- kernels: inputs, parity and bounds ---------------------------------------


def flash_inputs(b, s, hq, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, max_len, hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, max_len, hkv, d), generator=g, device="cuda").to(dtype)
    return q, k, v


def flash_bound(b, s, hq, hkv, d, dtype, causal=True):
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 4 * b * hq * s * s * d / (2 if causal else 1)
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * itemsize + b * hq * s * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_bound(b, sq, kv_len, hq, hkv, d, dtype):
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * kv_len * hkv * d * 2 + 2 * b * sq * hq * d) * itemsize
    flops = 4 * b * hq * sq * kv_len * d
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def decode_splits(b, sq, hq, hkv, d, kv_len, dtype, int8=False) -> int:
    """The split count kernel #4's wrapper plans for a contiguous launch of
    these shapes (bf16: by the CTAs the card holds)."""
    import torch

    from tpu_nexus_torch.ops.decode_attention import f32_split_plan, resident_ctas, split_plan

    if dtype == torch.bfloat16:
        device = torch.device("cuda", torch.cuda.current_device())
        return split_plan(b, hkv, kv_len, resident_ctas(device, d, sq * (hq // hkv), int8))[1]
    return f32_split_plan(b, hkv, kv_len)[1]


def zero_rms_norm_launches() -> None:
    """Kernel #9 (RMSNorm) is on no main path, as in the JAX package: every
    main-path run sets its count to 0 just before and reads it just after
    (:func:`read_rms_norm_launches`), so the kernels line's 0 is measured."""
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    rms_norm_kernel.launches = 0


def read_rms_norm_launches(results, path: str) -> None:
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    results.setdefault("rms_norm_launches", {})[path] = rms_norm_kernel.launches


#: the Hopper kernels the build phase reads from the library's SASS: report
#: key -> (mangled-name prefix with {v} for the instantiation, the dynamic
#: shared memory of a launch of instantiation v, the instructions its path
#: needs, the instantiations read: row label -> v).  "tma+wgmma": wgmma
#: (HGMMA) fed by TMA loads (UTMALDG) and no mma.sync (HMMA);
#: "ring+tensor": an asynchronous ring (UTMALDG or LDGSTS) and tensor-core
#: dots (HGMMA or HMMA); "vector": 128-bit global loads and stores
#: (LDG.E.128, STG.E.128); "report": read, nothing required.  The attention
#: kernels are read at head dims 64 and 128, #4 at the serve step's shape,
#: q_len 1 x GQA 4 (N 8); #7 with rhs [E,K,N] (read MN-major) and [E,N,K]
#: (d_lhs, K-major), #8 once; #5's and #6's ring kernels (bf16 activations)
#: and the first design they keep for other shapes; #9 at the widths of its
#: timed rows (bf16 and f32 x, 16-byte accesses).  ``sass_i2f`` counts the
#: int -> float conversions (I2F, I2FP).
HEAD_DIMS = {"d64": 64, "d128": 128}
HOPPER_KERNELS = {
    "flash_forward_bf16": ("flash_fwd_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_fwd_smem_bytes(d),
                           "tma+wgmma", HEAD_DIMS),
    "flash_bwd_dq_bf16": ("flash_bwd_dq_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_bwd_smem_bytes(0, d),
                          "tma+wgmma", HEAD_DIMS),
    "flash_bwd_dkv_bf16": ("flash_bwd_dkv_bf16_kernelILi{v}E", lambda lib, d: lib.nexus_flash_bwd_smem_bytes(1, d),
                           "tma+wgmma", HEAD_DIMS),
    "decode_bf16": ("decode_hopper_kernelILi{v}ELb0ELi8E", lambda lib, d: lib.nexus_decode_smem_bytes(d, 4, 0),
                    "ring+tensor", HEAD_DIMS),
    "decode_int8kv": ("decode_hopper_kernelILi{v}ELb1ELi8E", lambda lib, d: lib.nexus_decode_smem_bytes(d, 4, 1),
                      "ring+tensor", HEAD_DIMS),
    "gmm_bf16": ("gmm_bf16_kernelILb{v}E", lambda lib, _: lib.nexus_gmm_smem_bytes(0), "tma+wgmma",
                 {"rhs_ekn": 0, "rhs_enk_transposed": 1}),
    "tgmm_bf16": ("tgmm_bf16_kernel{v}", lambda lib, _: lib.nexus_gmm_smem_bytes(1), "tma+wgmma", {"all": ""}),
    "quant_int4_ring": ("quant_int4_ring_kernel{v}", lambda lib, _: lib.nexus_quant_int4_smem_bytes(), "ring+tensor",
                        {"bf16": ""}),
    "quant_int4_pitch_branch": ("quant_matmul_mma_kernelILb{v}E", lambda lib, _: 0, "report", {"bf16": 1}),
    "quant_int8_ring": ("quant_int8_ring_kernel{v}", lambda lib, _: lib.nexus_quant_int8_smem_bytes(),
                        "ring+tensor", {"bf16": ""}),
    "quant_int8_first_design": ("quant_matmul_mma_kernelILb{v}E", lambda lib, _: 0, "report", {"bf16": 0}),
    "rms_norm": ("rms_kernelI{v}", lambda lib, _: 0, "vector",
                 {"bf16_h2048": "13__nv_bfloat16Li2ELb1E", "bf16_h4096": "13__nv_bfloat16Li4ELb1E",
                  "f32_h2048": "fLi2ELb1E", "f32_h8192": "fLi8ELb1E"}),
}
#: kernels whose every instantiation must be free of local memory and stack: name -> how many
ALL_INSTANTIATIONS = {"decode_hopper_kernel": 16, "rms_kernel": 16, "quant_int4_ring_kernel": 1,
                      "quant_int8_ring_kernel": 1}
#: the most int -> float conversions the int8 ring kernel may hold: those of its run bounds' 32-bit
#: divisions (a conversion on the weights would be one a widened value, hundreds in the SASS)
INT8_RING_MAX_I2F = 16


def hopper_kernel_resources(_build):
    """The kernels of :data:`HOPPER_KERNELS` (the bf16 flash kernels, #4's
    bf16 and int8-KV instantiations, the bf16 grouped matmul kernels, #6's
    int4 ring kernel and the first design it keeps, #9) read from the built
    library by the toolkit's ``cuobjdump -res-usage -sass``: registers a
    thread at entry, stack and local memory (spills) a thread, static shared
    memory, and the SASS counts that show the path — wgmma (``HGMMA``),
    ``mma.sync`` (``HMMA``), TMA loads (``UTMALDG``), cp.async (``LDGSTS``),
    int -> float conversions (``I2F``/``I2FP``), 128-bit global loads and
    stores; and the dynamic shared memory a launch asks for, from the
    library's own layouts.  Fails without cuobjdump, where a kernel lacks
    what its path needs, where any of them but a "report" row has local
    memory or stack, or where any instantiation of a kernel in
    :data:`ALL_INSTANTIATIONS` has."""
    import re

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        raise RuntimeError(f"no cuobjdump beside nvcc ({cuobjdump}): the build phase reads the kernels' SASS")
    dump = subprocess.run([str(cuobjdump), "-res-usage", "-sass", str(_build.library_path())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    lib = _build.library()
    report = {}
    for key, (pattern, dynamic_smem, needs, variants) in HOPPER_KERNELS.items():
        for label, v in variants.items():
            name = pattern.format(v=v)
            usage = re.search(rf"Function \S*{name}\S*:\s*\n(.*)", dump)
            fields = dict(re.findall(r"(\w+):(\d+)", usage.group(1))) if usage else {}
            sass = next((f for f in dump.split("Function : ")[1:] if re.match(rf"\S*{name}", f)), "")
            row = dict(
                registers=int(fields.get("REG", 0)), stack_bytes=int(fields.get("STACK", 0)),
                local_bytes=int(fields.get("LOCAL", 0)), static_smem=int(fields.get("SHARED", 0)),
                dynamic_smem=dynamic_smem(lib, v),
                sass_hgmma=len(re.findall(r"\bHGMMA\.", sass)),
                sass_hmma=len(re.findall(r"\bHMMA\.", sass)),
                sass_utmaldg=len(re.findall(r"\bUTMALDG\b", sass)),
                sass_ldgsts=len(re.findall(r"\bLDGSTS\b", sass)),
                sass_i2f=len(re.findall(r"\bI2FP?(?:\.|\s)", sass)),
                sass_ldg128=len(re.findall(r"\bLDG\.E(?:\.\w+)*\.128\b", sass)),
                sass_stg128=len(re.findall(r"\bSTG\.E(?:\.\w+)*\.128\b", sass)),
            )
            report.setdefault(key, {})[label] = row
            if needs == "tma+wgmma":
                path_ok = row["sass_hgmma"] and row["sass_utmaldg"] and not row["sass_hmma"]
            elif needs == "ring+tensor":
                path_ok = (row["sass_utmaldg"] or row["sass_ldgsts"]) and (row["sass_hgmma"] or row["sass_hmma"])
            elif needs == "vector":
                path_ok = row["sass_ldg128"] and row["sass_stg128"]
            else:
                path_ok = True
            spills = needs != "report" and (row["local_bytes"] or row["stack_bytes"])  # "report": as it is
            if not (fields and path_ok) or spills:
                raise AssertionError(f"{name}: no resource usage, its path ({needs}) missing, or local memory or "
                                     f"stack in cuobjdump's output: {row}\n{dump[:4000]}")
    # every instantiation of #4's Hopper kernel (D x int8-KV x N 8/16/32/64), of #9 (x dtype x warps a
    # row x aligned) and #6's ring kernel: none spills
    for kernel, count in ALL_INSTANTIATIONS.items():
        spills = {f: dict(re.findall(r"(\w+):(\d+)", u)) for f, u in
                  re.findall(rf"Function (\S*{kernel}\S*):\s*\n(.*)", dump)}
        worst = {f: (int(u.get("REG", 0)), int(u.get("LOCAL", 0)), int(u.get("STACK", 0))) for f, u in spills.items()}
        if len(worst) != count or any(local or stack for _, local, stack in worst.values()):
            raise AssertionError(f"{kernel}: {len(worst)} instantiations (want {count}), or one spills: {worst}")
        report[f"{kernel}_all_instantiations"] = dict(
            count=len(worst), max_registers=max(r for r, _, _ in worst.values()), local_or_stack_bytes=0)
    i2f = report["quant_int8_ring"]["bf16"]["sass_i2f"]
    if i2f > INT8_RING_MAX_I2F:
        raise AssertionError(f"quant_int8_ring_kernel: {i2f} I2F, more than its run bounds need "
                             f"({INT8_RING_MAX_I2F}): a conversion on the weights?")
    return report


def phase_parity(results):
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    flash_cases = [  # (B, S, Hq, Hkv, D, dtype, causal)
        (8, 2048, 16, 8, 128, torch.bfloat16, True),  # the train phase's shape (GQA group 2)
        (8, 2048, 16, 8, 128, torch.float32, True),
        (8, 128, 32, 8, 128, torch.bfloat16, True),  # the serve phase's prefill
        (1, 2048, 32, 8, 128, torch.bfloat16, True),
        (1, 200, 32, 8, 128, torch.bfloat16, True),
        (2, 256, 32, 8, 64, torch.bfloat16, True),
        (2, 128, 32, 8, 128, torch.bfloat16, False),
        (8, 128, 32, 8, 128, torch.float32, True),
        (1, 2048, 32, 8, 128, torch.float32, True),
        (1, 200, 32, 8, 128, torch.float32, True),
        (2, 256, 32, 8, 64, torch.float32, False),
        # the 128-row tiles' edges: one row, a tile short of full, a tile
        # and one row, three tiles with a ragged end; GQA groups 1, 4, 8; D 64
        (2, 1, 32, 8, 128, torch.bfloat16, True),
        (2, 127, 32, 8, 128, torch.bfloat16, True),
        (2, 129, 32, 8, 128, torch.bfloat16, True),
        (2, 383, 32, 8, 128, torch.bfloat16, True),
        (2, 383, 32, 8, 128, torch.bfloat16, False),
        (2, 383, 32, 8, 64, torch.bfloat16, True),
        (2, 129, 32, 8, 64, torch.bfloat16, True),
        (1, 383, 8, 8, 128, torch.bfloat16, True),
        (1, 383, 64, 8, 128, torch.bfloat16, False),
        (2, 1, 32, 8, 64, torch.bfloat16, False),
        (2, 1, 32, 8, 128, torch.float32, True),
        (2, 383, 32, 8, 64, torch.float32, True),
    ]
    for i, (b, s, hq, hkv, d, dtype, causal) in enumerate(flash_cases):
        q, k, v = flash_inputs(b, s, hq, hkv, d, dtype, seed=10 + i)
        out, lse = flash_attention(q, k, v, causal=causal)
        out2, lse2 = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        e_row = row_rel_err(out, ref_out)
        tol_out, tol_lse = TOL[str(dtype).split(".")[-1]]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        ok = (same and e_out <= tol_out and e_lse <= tol_lse and (tol_row is None or e_row <= tol_row)
              and bool(torch.isfinite(out).all()))
        emit("parity", kernel="flash_attention", shape=[b, s, hq, hkv, d], dtype=str(dtype),
             causal=causal, max_abs_err_out=e_out, max_abs_err_lse=e_lse, max_row_rel_err=e_row,
             tol_out=tol_out, tol_lse=tol_lse, tol_row_rel=tol_row, bit_identical_twice=same, ok=ok)
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with its plain version: {flash_cases[i]}")
        if dtype == torch.bfloat16 and (b, s, hq) == (8, 2048, 16):
            worst["flash_attention"] = e_out
        del q, k, v, out, lse, out2, lse2, ref_out, ref_lse
        torch.cuda.empty_cache()

    # (B, q_len, max_len, kv_len, ragged, dtype, Hq, Hkv, D): Llama-3-8B heads (32, 8, 128) unless named
    decode_cases = []
    for max_len, kv_lens in ((160, (4, 100, 160)), (4096, (129, 2000, 4096))):
        for sq in (1, 4):
            for kv_len in kv_lens:
                decode_cases.append((8, sq, max_len, kv_len, False, torch.bfloat16, 32, 8, 128))
        decode_cases.append((8, 1, max_len, max_len // 2 + 7, True, torch.bfloat16, 32, 8, 128))
        decode_cases.append((8, 4, max_len, max_len - 3, True, torch.float32, 32, 8, 128))
        decode_cases.append((8, 1, max_len, max_len, False, torch.float32, 32, 8, 128))
    decode_cases += [
        # q_len 8 x GQA 8: 64 query rows (wgmma N 64)
        (8, 8, 4096, 4096, False, torch.bfloat16, 64, 8, 128), (8, 8, 160, 150, True, torch.bfloat16, 64, 8, 128),
        (2, 8, 4096, 4096, False, torch.float32, 64, 8, 128),
        # GQA 1 and 8
        (8, 1, 4096, 4000, True, torch.bfloat16, 8, 8, 128), (8, 5, 4096, 4096, False, torch.bfloat16, 8, 8, 128),
        (8, 1, 4096, 4096, False, torch.bfloat16, 64, 8, 128), (8, 2, 160, 144, False, torch.bfloat16, 64, 8, 128),
        # one row's 8 kv heads over 4096 slots: the launch merges >= 8 splits
        (1, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 128), (1, 4, 4096, 3001, True, torch.bfloat16, 32, 8, 128),
        # head_dim 64 (nexus_moe's attention is 128; D 64 is the kernel's other width)
        (8, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 64), (8, 3, 160, 144, False, torch.bfloat16, 16, 8, 64),
    ]
    for i, (b, sq, max_len, kv_len, ragged, dtype, hq, hkv, d) in enumerate(decode_cases):
        q, k, v = decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed=100 + i)
        lens = width = None
        if ragged:
            width = max_len // 2
            g = torch.Generator(device="cuda").manual_seed(500 + i)
            lens = torch.randint(1, width + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        before = decode_attention.launches
        out = decode_attention(q, k, v, kv_len, lens, width)
        again = decode_attention(q, k, v, kv_len, lens, width)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, again)) and decode_attention.launches == before + 2
        ref = decode_attention_plain(q, k, v, kv_len, lens, width)
        err, e_row = max_err(out, ref), row_rel_err(out, ref)
        tol = TOL[str(dtype).split(".")[-1]][0]
        tol_row = ROW_REL_TOL if dtype == torch.bfloat16 else None
        n_splits = decode_splits(b, sq, hq, hkv, d, kv_len, dtype)
        merged = n_splits >= 8 if (b, max_len, sq) == (1, 4096, 1) else True
        ok = (same and merged and err <= tol and (tol_row is None or e_row <= tol_row)
              and bool(torch.isfinite(out).all()))
        emit("parity", kernel="decode_attention", b=b, q_len=sq, max_len=max_len, kv_len=kv_len, heads=[hq, hkv, d],
             ragged=ragged, dtype=str(dtype), n_splits=n_splits, max_abs_err=err, max_row_rel_err=e_row, tol=tol,
             tol_row_rel=tol_row, bit_identical_twice=same, ok=ok)
        if not ok:
            raise AssertionError(f"decode_attention kernel disagrees with its plain version: {decode_cases[i]}")
        if dtype == torch.bfloat16 and max_len == 160 and sq == 1 and hq == 32:
            worst["decode_attention"] = max(worst["decode_attention"], err)
        del q, k, v, out, again, ref
    results.setdefault("max_abs_err", {}).update(worst)
    quant_matmul_parity(results)
    decode_int8kv_parity(results)


#: limits of the dequant-matmul and int8-KV cases: f32 max-abs relative to
#: the reference's largest magnitude (the sums differ in order only), bf16
#: the worst row's relative L2 (one rounding of the output apart)
QUANT_F32_MAXABS_REL = 1e-4
#: the llama3_8b decode step's distinct weight shapes (K, N): wq/wo, wk/wv,
#: w_gate/w_up, w_down
LLAMA8B_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
#: nexus_moe's decode-step products on the ring (wq/wo, wk/wv); its expert
#: stacks keep their lead dim and are dequantized before their einsum
NEXUS_MOE_KN = ((1024, 1024), (1024, 512))


def quant_weight(k, n, mode, group, seed):
    """A random [K, N] weight quantized on the card: QTensor or QTensor4."""
    import torch

    from tpu_nexus_torch.models.quant import quantize_tensor, quantize_tensor_int4

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * k**-0.5
    return quantize_tensor(w, (-2,)) if mode == "int8" else quantize_tensor_int4(w, (-2,), group, name="w")


def quant_bound(m, k, n, w, dtype):
    """Least time: the packed weight, its scales, x and y moved once at the
    HBM rate, or 2MKN operations at the peak of x's type."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = w.q.numel() + w.s.numel() * 4 + (m * k + m * n) * itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def quant_matmul_parity(results):
    """Kernels #5 (int8) and #6 (int4) against ``quant_matmul_plain``."""
    import torch

    from tpu_nexus_torch.ops.quant_matmul import (
        int4_ring_route, int8_ring_route, quant_matmul, quant_matmul_plain,
    )

    cases = [(8, k, n, (64, 128)) for k, n in LLAMA8B_KN]  # (M, K, N, int4 groups)
    cases += [(8, k, n, (64,)) for k, n in NEXUS_MOE_KN]
    cases += [(1, 4096, 4096, (64,)), (256, 4096, 4096, (64,)), (40, 4096, 14336, (64,)), (256, 4096, 14336, (64,)),
              (8, 4096, 1024, (4096, 2)), (5, 448, 200, (64, 2)), (3, 640, 71, (128, 640))]
    worst = {"quant_matmul_int8": 0.0, "quant_matmul_int4": 0.0}
    routes = {}
    seed = 2000
    for m, k, n, groups in cases:
        for mode, group in [("int8", 0)] + [("int4", g) for g in groups]:
            w = quant_weight(k, n, mode, group, seed)
            for dtype in (torch.bfloat16, torch.float32):
                seed += 1
                x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(seed),
                                device="cuda").to(dtype)
                before = dict(quant_matmul.launches_by_route)
                out, again = quant_matmul(x, w), quant_matmul(x, w)
                torch.cuda.synchronize()
                launched = {r: c - before[r] for r, c in quant_matmul.launches_by_route.items()
                            if c != before[r]}
                ref = quant_matmul_plain(x, w)
                same = bool(torch.equal(out, again))
                err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
                ok = same and bool(torch.isfinite(out).all()) and (
                    e_row <= ROW_REL_TOL if dtype == torch.bfloat16 else err <= QUANT_F32_MAXABS_REL * ref_max)
                # the kernel that ran: int4 bf16 takes the ring kernel or the pitch branch, int8 the ring
                # kernel or the first design (as f32 does)
                if mode == "int4" and dtype == torch.bfloat16:
                    route = "ring" if int4_ring_route(x, w.q, w.s, n, group) else "pitch_branch"
                elif mode == "int8":
                    route = "ring" if int8_ring_route(x, w.q, w.s, n) else "first_design"
                else:
                    route = "first_design"
                ok = ok and launched == {f"{mode}_{'ring' if route == 'ring' else 'first_design'}": 2}
                routes.setdefault(f"{mode}_{str(dtype)[6:]}_{route}", []).append([m, k, n, group or None])
                emit("parity", kernel=f"quant_matmul_{mode}", m=m, k=k, n=n, group=group or None,
                     dtype=str(dtype), route=route, launches_by_route=launched, max_abs_err=err,
                     ref_max_abs=ref_max, max_row_rel_err=e_row,
                     bit_identical_twice=same, tol_f32_max_abs_rel=QUANT_F32_MAXABS_REL,
                     tol_bf16_row_rel=ROW_REL_TOL, ok=ok)
                if not ok:
                    raise AssertionError(f"quant_matmul {mode} kernel disagrees with its plain version: "
                                         f"M{m} K{k} N{n} group {group} {dtype}")
                if dtype == torch.bfloat16 and (m, k, n) == (8, 4096, 14336) and group in (0, 64):
                    worst[f"quant_matmul_{mode}"] = err
            del w
    torch.cuda.empty_cache()
    emit("parity", kernel="quant_matmul", routes=routes)
    if not routes.get("int4_bfloat16_ring") or not routes.get("int4_bfloat16_pitch_branch"):
        raise AssertionError(f"the int4 bf16 cases missed the ring kernel or the pitch branch: {routes}")
    if not routes.get("int8_bfloat16_ring") or not routes.get("int8_bfloat16_first_design"):
        raise AssertionError(f"the int8 bf16 cases missed the ring kernel or the first design: {routes}")
    results.setdefault("max_abs_err", {}).update(worst)


def int8_cache(k, v):
    """(k8, v8, k_scale, v_scale): a cache quantized the way decode writes it."""
    from tpu_nexus_torch.models.generate import _quantize_kv

    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, ks, vs


def decode_int8kv_parity(results):
    """Kernel #4's int8-KV mode against ``decode_attention_plain`` with scales."""
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain

    cases = []  # (B, q_len, max_len, kv_len, ragged, dtype, Hq, Hkv, D)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(8, 1, 160, 144, False, dtype), (8, 1, 4096, 4096, False, dtype), (8, 4, 160, 144, False, dtype),
                  (8, 4, 4096, 3000, False, dtype), (8, 1, 160, 150, True, dtype), (8, 4, 4096, 4000, True, dtype)]
    cases = [c + (32, 8, 128) for c in cases] + [
        (8, 8, 4096, 4096, False, torch.bfloat16, 64, 8, 128),  # 64 query rows
        (8, 1, 4096, 4000, True, torch.bfloat16, 8, 8, 128),  # GQA 1
        (1, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 128),  # a merge of >= 8 splits
        (8, 1, 4096, 4096, False, torch.bfloat16, 32, 8, 64),  # D 64
    ]
    worst = 0.0
    for i, (b, sq, max_len, kv_len, ragged, dtype, hq, hkv, d) in enumerate(cases):
        q, k, v = decode_inputs(b, sq, max_len, hq, hkv, d, dtype, seed=3000 + i)
        k8, v8, ks, vs = int8_cache(k, v)
        lens = width = None
        if ragged:
            width = max_len // 2
            g = torch.Generator(device="cuda").manual_seed(3500 + i)
            lens = torch.randint(1, width + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        before = decode_attention.launches_by_mode["contiguous+int8"]
        out = decode_attention(q, k8, v8, kv_len, lens, width, ks, vs)
        again = decode_attention(q, k8, v8, kv_len, lens, width, ks, vs)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k8, v8, kv_len, lens, width, ks, vs)
        same = bool(torch.equal(out, again)) and decode_attention.launches_by_mode["contiguous+int8"] == before + 2
        err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
        if dtype == torch.bfloat16:
            ok = err <= TOL["bfloat16"][0] and e_row <= ROW_REL_TOL
        else:
            ok = err <= QUANT_F32_MAXABS_REL * ref_max
        n_splits = decode_splits(b, sq, hq, hkv, d, kv_len, dtype, int8=True)
        merged = n_splits >= 8 if (b, max_len, sq) == (1, 4096, 1) else True
        ok = ok and same and merged and bool(torch.isfinite(out).all())
        emit("parity", kernel="decode_attention_int8kv", b=b, q_len=sq, max_len=max_len, kv_len=kv_len,
             heads=[hq, hkv, d], ragged=ragged, dtype=str(dtype), n_splits=n_splits, max_abs_err=err,
             ref_max_abs=ref_max, max_row_rel_err=e_row,
             bit_identical_twice=same, tol_bf16_max_abs=TOL["bfloat16"][0], tol_bf16_row_rel=ROW_REL_TOL,
             tol_f32_max_abs_rel=QUANT_F32_MAXABS_REL, ok=ok)
        if not ok:
            raise AssertionError(f"int8-KV decode kernel disagrees with its plain version: {cases[i]}")
        if dtype == torch.bfloat16 and (sq, max_len, hq) == (1, 160, 32) and not ragged:
            worst = err
    results.setdefault("max_abs_err", {})["decode_attention_int8kv"] = worst


#: bf16 backward limits: max-abs relative to the reference's largest
#: magnitude (gradients have no fixed scale), and the worst row's relative L2
BWD_BF16_MAXABS_REL = 2e-2
BWD_F32_MAXABS = 1e-5
#: row norms below this fraction of the largest are floored to it in the
#: row-relative check (see row_rel_err)
BWD_ROW_FLOOR = 1e-3


def bwd_inputs(b, s, hq, hkv, d, dtype, causal, seed):
    """q, k, v, dout and the forward kernel's (out, lse) on them."""
    import torch

    from tpu_nexus_torch.ops.flash_attention import flash_attention

    q, k, v = flash_inputs(b, s, hq, hkv, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    return q, k, v, out, lse, dout


def phase_train_parity(results):
    """Kernels #2 (dQ) and #3 (dK/dV) against the plain backward, and the
    backward run twice is bit-identical: the training shapes, and every
    tile edge at GQA groups 1, 2 and 4, D 64 and 128, causal and not."""
    import torch

    from tpu_nexus_torch.ops.flash_attention import flash_attention_bwd, flash_attention_bwd_plain

    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    cases = []  # (B, S, Hq, Hkv, D, causal, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(8, 2048, 16, 8, 128, True, dtype), (2, 512, 32, 8, 128, True, dtype),
                  (2, 200, 16, 8, 128, True, dtype), (2, 256, 16, 8, 64, True, dtype),
                  (2, 384, 16, 8, 128, False, dtype)]
        # the tile edges of the bf16 kernels' 64-row streamed and 128-row
        # resident tiles, GQA groups 1, 2 and 4, D 64 and 128, causal and not
        cases += [(2, s, 2 * group, 2, d, causal, dtype) for s in (64, 65, 127, 129, 200)
                  for group in (1, 2, 4) for d in (64, 128) for causal in (True, False)]
    for i, (b, s, hq, hkv, d, causal, dtype) in enumerate(cases):
        q, k, v, out, lse, dout = bwd_inputs(b, s, hq, hkv, d, dtype, causal, seed=200 + i)
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        ref = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
        row = {}
        ok = deterministic
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            e_abs, ref_max = max_err(a, r), float(r.float().abs().max())
            e_row = row_rel_err(a, r, BWD_ROW_FLOOR)
            finite = bool(torch.isfinite(a).all())
            if dtype == torch.bfloat16:
                good = e_abs <= BWD_BF16_MAXABS_REL * ref_max and e_row <= ROW_REL_TOL
            else:
                good = e_abs <= BWD_F32_MAXABS
            ok = ok and good and finite
            row[name] = {"max_abs_err": e_abs, "ref_max_abs": ref_max, "max_row_rel_err": e_row}
        emit("train_parity", shape=[b, s, hq, hkv, d], dtype=str(dtype), causal=causal,
             deterministic=deterministic, tol_bf16_max_abs_rel=BWD_BF16_MAXABS_REL,
             tol_bf16_row_rel=ROW_REL_TOL, row_norm_floor=BWD_ROW_FLOOR, tol_f32_max_abs=BWD_F32_MAXABS, ok=ok, **row)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with the plain version: {cases[i]}")
        if dtype == torch.bfloat16 and (b, s, hq) == (8, 2048, 16):
            worst["flash_attention_bwd_dq"] = row["dq"]["max_abs_err"]
            worst["flash_attention_bwd_dkv"] = max(row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])
        del q, k, v, out, lse, dout, got, again, ref
        torch.cuda.empty_cache()
    results.setdefault("max_abs_err", {}).update(worst)


def phase_times(results):
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    times = {}
    dt = torch.bfloat16
    # prefill, bf16 causal: the train phase's shape (the kernels line's row),
    # the serve phase's prefill and a long Llama-3-8B prompt; one input set
    # per layer-sized copy, so inputs come from HBM as a per-layer caller finds them
    for b, s, hq, hkv, d, n_sets, iters, key in ((8, 2048, 16, 8, 128, 2, 20, "flash_attention"),
                                                 (8, 128, 32, 8, 128, 8, 40, None),
                                                 (1, 2048, 32, 8, 128, 1, 20, None)):
        sets = [flash_inputs(b, s, hq, hkv, d, dt, seed=900 + i) for i in range(n_sets)]
        kern = [lambda x=x: flash_attention(*x, causal=True) for x in sets]
        plain = [lambda x=x: flash_attention_plain(*x, causal=True) for x in sets]
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True)
               for x in lib_sets]
        bound, by = flash_bound(b, s, hq, hkv, d, dt)
        ms, enqueue_ms = timed(kern, iters=iters)
        row = dict(shape=[b, s, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms(plain, iters=max(iters // 4, 4)), library_ms=cuda_ms(lib, iters=iters),
                   bound_ms=bound, bound_by=by)
        if key:
            times[key] = row
        emit("times", kernel="flash_attention", **row)
        del sets, lib_sets, kern, plain, lib
        torch.cuda.empty_cache()

    # decode: the serve phase's step (B 8, q_len 1, cache 160 = 128 + 32) at
    # its mean live length, cycling 32 per-layer caches so K/V come from HBM
    hq, hkv, d = 32, 8, 128
    for b, max_len, kv_len, n_layers, key in ((8, 160, 144, 32, "decode_attention"), (8, 4096, 4096, 4, None)):
        layers = [decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=1000 + i) for i in range(n_layers)]
        kern = [lambda x=x: decode_attention(*x, kv_len) for x in layers]
        plain = [lambda x=x: decode_attention_plain(*x, kv_len) for x in layers]
        lib_sets = [
            (q.transpose(1, 2), k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2))
            for q, k, v in layers
        ]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, enable_gqa=True) for x in lib_sets]
        bound, by = decode_bound(b, 1, kv_len, hq, hkv, d, dt)
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(
            shape=[b, 1, max_len, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
            plain_ms=cuda_ms(plain, iters=32), library_ms=cuda_ms(lib, iters=64),
            bound_ms=bound, bound_by=by,
        )
        if key:
            times[key] = row
        emit("times", kernel="decode_attention", **row)
        del layers, lib_sets
    bwd_times(times)
    quant_times(times)
    moe_times(times)
    engine_times(times)
    results["times"] = times


#: the timed dequant-matmul launches: (times key, M, K, N, mode, group).  The
#: first two are the kernels line's rows (the decode step's largest launch,
#: w_gate/w_up); #5 and #6 also at w_down, wq/wo and wk/wv, and at
#: nexus_moe's wq/wo and wk/wv (its decode step's only ring launches).
QUANT_TIMED = (("quant_matmul_int8", 8, 4096, 14336, "int8", 0), ("quant_matmul_int4", 8, 4096, 14336, "int4", 64),
               ("quant_matmul_int8_down", 8, 14336, 4096, "int8", 0),
               ("quant_matmul_int8_wq", 8, 4096, 4096, "int8", 0),
               ("quant_matmul_int8_wk", 8, 4096, 1024, "int8", 0),
               ("quant_matmul_int4_down", 8, 14336, 4096, "int4", 64),
               ("quant_matmul_int4_wq", 8, 4096, 4096, "int4", 64),
               ("quant_matmul_int4_wk", 8, 4096, 1024, "int4", 64),
               ("quant_matmul_int8_moe_wq", 8, 1024, 1024, "int8", 0),
               ("quant_matmul_int8_moe_wk", 8, 1024, 512, "int8", 0),
               ("quant_matmul_int4_moe_wq", 8, 1024, 1024, "int4", 64),
               ("quant_matmul_int4_moe_wk", 8, 1024, 512, "int4", 64))


def quant_times(times):
    """Kernels #5 (int8) and #6 (int4, group 64) at the Llama-3-8B decode
    step's four launches, M 8, bf16 (:data:`QUANT_TIMED`), cycling enough weight
    copies (at least four, over 128 MB in all) that the packed bytes come
    from HBM as a per-layer caller finds them; and kernel #4's int8-KV mode
    at the two decode shapes.  ``library_ms``: ``torch.matmul`` with the
    pre-dequantized bf16 weight, ``scaled_dot_product_attention`` on a
    dequantized cache."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    dt = torch.bfloat16
    for key, m, k, n, mode, group in QUANT_TIMED:
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda").to(dt)
        first = quant_weight(k, n, mode, group, 4001)
        copies = max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, mode, group, 4001 + i) for i in range(1, copies)]
        dense = [w.to(dt) for w in weights[: max(4, -(-copies // 4))]]  # 4x the bytes each: as many over L2
        bound, by = quant_bound(m, k, n, weights[0], dt)
        ms, enqueue_ms = timed([lambda w=w: quant_matmul(x, w) for w in weights], iters=64)
        row = dict(
            shape=[m, k, n], group=group or None, dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
            plain_ms=cuda_ms([lambda w=w: quant_matmul_plain(x, w) for w in weights[:4]], iters=8, warmup=2),
            library_ms=cuda_ms([lambda w=w: torch.matmul(x, w) for w in dense], iters=64),
            bound_ms=bound, bound_by=by, weight_copies=copies,
        )
        times[key] = row
        emit("times", kernel=key, library_ms_is="torch.matmul, pre-dequantized bf16 weight", **row)
        del weights, dense, first
        torch.cuda.empty_cache()

    hq, hkv, d = 32, 8, 128
    for b, max_len, kv_len, n_layers, key in ((8, 160, 144, 32, "decode_attention_int8kv"), (8, 4096, 4096, 4, None)):
        layers = []
        for i in range(n_layers):
            q, kk, vv = decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=4100 + i)
            layers.append((q, *int8_cache(kk, vv)))
        kern = [lambda a=a: decode_attention(a[0], a[1], a[2], kv_len, None, None, a[3], a[4]) for a in layers]
        plain = [lambda a=a: decode_attention_plain(a[0], a[1], a[2], kv_len, None, None, a[3], a[4])
                 for a in layers]
        lib_sets = [(q.transpose(1, 2), (k8[:, :kv_len].to(dt) * ks[:, :kv_len].to(dt)).transpose(1, 2),
                     (v8[:, :kv_len].to(dt) * vs[:, :kv_len].to(dt)).transpose(1, 2))
                    for q, k8, v8, ks, vs in layers]
        lib = [lambda a=a: F.scaled_dot_product_attention(*a, enable_gqa=True) for a in lib_sets]
        nbytes = 2 * b * kv_len * hkv * (d + 4) + 2 * b * hq * d * 2  # int8 K/V + f32 scales, q and out
        flops = 4 * b * hq * kv_len * d
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(shape=[b, 1, max_len, kv_len, hq, hkv, d], dtype="bfloat16 q, int8 cache",
                   ms=ms, enqueue_ms=enqueue_ms, plain_ms=cuda_ms(plain, iters=32), library_ms=cuda_ms(lib, iters=64),
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")
        if key:
            times[key] = row
        emit("times", kernel="decode_attention_int8kv",
             library_ms_is="scaled_dot_product_attention, dequantized bf16 cache", **row)
        del layers, lib_sets
    torch.cuda.empty_cache()


def bwd_bound(b, s, hq, hkv, d, dtype, n_matmuls, outputs, causal=True):
    """Least time for the backward or a kernel's share of it: ``n_matmuls``
    products of S·S·D per head (halved by causality) at the tensor-core peak, or its bytes
    (q, k, v, dO and the lse/dsum rows read once, ``outputs`` written once)
    at the HBM rate, whichever is larger."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = n_matmuls * 2 * b * hq * s * s * d / (2 if causal else 1)
    out_elems = {"dq": b * s * hq * d, "dkv": 2 * b * s * hkv * d,
                 "all": b * s * hq * d + 2 * b * s * hkv * d}[outputs]
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d + out_elems) * itemsize + 2 * b * hq * s * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_times(times):
    """Kernels #2 (dQ) and #3 (dK/dV) at the nexus_1b training shape (B8
    S2048 Hq16 Hkv8 D128 causal, bf16) and at nexus_moe's (Hq8 Hkv4): ms per
    launch (q̃ made beforehand), the whole ``flash_attention_bwd`` (dsum, q̃
    and both kernels: the number to set beside the library's), the plain
    backward's ms (dQ, dK and dV together) and, as a yardstick only, the
    backward of ``scaled_dot_product_attention`` on the same inputs (all
    three grads, its own preprocessing included)."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_bwd_qt,
        flash_dsum,
    )

    b, s, d, dt = 8, 2048, 128, torch.bfloat16
    for hq, hkv, suffix in ((16, 8, ""), (8, 4, "_moe")):
        sets = [bwd_inputs(b, s, hq, hkv, d, dt, True, seed=1200 + i) for i in range(2)]
        pre = [(flash_dsum(x[3], x[5]), flash_bwd_qt(x[0], d**-0.5)) for x in sets]
        dq_fns = [lambda x=x, p=p: flash_attention_bwd_dq(x[0], x[1], x[2], x[5], x[4], p[0], qt=p[1])
                  for x, p in zip(sets, pre)]
        dkv_fns = [lambda x=x, p=p: flash_attention_bwd_dkv(x[0], x[1], x[2], x[5], x[4], p[0], qt=p[1])
                   for x, p in zip(sets, pre)]
        whole_fns = [lambda x=x: flash_attention_bwd(*x) for x in sets]
        plain = [lambda x=sets[0]: flash_attention_bwd_plain(*x)]
        lib = []
        for q, k, v, _, _, dout in sets:
            ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
            g = dout.transpose(1, 2)
            lib.append(lambda out=out, g=g, leaves=(ql, kl, vl): torch.autograd.grad(
                out, leaves, g, retain_graph=True))
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(lib, iters=20)
        # the function's 5 products split between the kernels: dQ = dS·K and one
        # of the two both kernels need (S = q̃·Kᵀ, dP = dO·Vᵀ); dV, dK and the
        # other.  The split design recomputes both shared products in each
        # kernel (3 and 4 products), which the bound does not count.
        for key, fns, n_matmuls, outputs in (
            ("flash_attention_bwd_dq", dq_fns, 2, "dq"), ("flash_attention_bwd_dkv", dkv_fns, 3, "dkv"),
        ):
            bound, by = bwd_bound(b, s, hq, hkv, d, dt, n_matmuls, outputs)
            ms, enqueue_ms = timed(fns, iters=20)
            times[key + suffix] = dict(shape=[b, s, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                                       bound_matmuls=f"{n_matmuls} of the function's 5")
            emit("times", kernel=key, plain_ms_is="plain backward, dQ+dK+dV",
                 library_ms_is="scaled_dot_product_attention backward, dQ+dK+dV", **times[key + suffix])
        whole, whole_by = bwd_bound(b, s, hq, hkv, d, dt, 5, "all")
        wrapper_ms, wrapper_enqueue_ms = timed(whole_fns, iters=20)
        times["flash_attention_bwd" + suffix] = dict(
            shape=[b, s, hq, hkv, d], dtype="bfloat16",
            ms=times["flash_attention_bwd_dq" + suffix]["ms"] + times["flash_attention_bwd_dkv" + suffix]["ms"],
            wrapper_ms=wrapper_ms, wrapper_enqueue_ms=wrapper_enqueue_ms,
            bound_ms=whole, bound_by=whole_by, library_ms=lib_ms, plain_ms=plain_ms)
        emit("times", kernel="flash_attention_bwd (ms: dQ + dK/dV; wrapper_ms: flash_attention_bwd, "
             "dsum + q̃ + both kernels)", **times["flash_attention_bwd" + suffix])
        del sets, pre, lib, dq_fns, dkv_fns, whole_fns, plain
        torch.cuda.empty_cache()


def phase_e2e(results):
    import torch

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention

    cfg = dataclasses.replace(
        LlamaConfig.llama3_8b(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32
    )
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), generator=g, device="cuda", dtype=torch.int32)
    f0, d0 = flash_attention.launches, decode_attention.launches
    with_kernels = generate(params, prompt, cfg, max_new_tokens=32)
    launched = (flash_attention.launches - f0, decode_attention.launches - d0)
    plain = generate(params, prompt, cfg, max_new_tokens=32, attn_impl="plain", decode_kernel="plain")
    torch.cuda.synchronize()
    same = bool(torch.equal(with_kernels, plain))
    mismatch = int((with_kernels != plain).sum())
    emit("e2e", config="llama3_8b widths, 2 layers, f32", batch=4, prompt=128, new_tokens=32,
         token_identical=same, mismatched_tokens=mismatch, flash_launches=launched[0],
         decode_launches=launched[1])
    if not same or launched[0] != cfg.n_layers or launched[1] != cfg.n_layers * 31:
        raise AssertionError("kernel path is not token-identical to the plain path (or skipped a kernel)")

    # quantized trees: the dequant-matmul kernels (and the int8-KV decode
    # mode) against the dequantize-then-einsum path and the plain attention
    _quantized_generate_parity("e2e", cfg, params, (("int8", "int8"), ("int4", "")), 7)
    del params
    torch.cuda.empty_cache()


def _bwd_counters():
    from tpu_nexus_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    return flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv


def phase_train_e2e(results):
    """nexus_1b widths at 2 layers in f32: 3 train steps through the
    kernels against 3 steps through dense attention under autograd
    (``attn_impl="plain"``) on the card, same init and batches.  Loss and
    grad norm agree within 1e-4 and 1e-3 relative: the f32 kernels differ
    from dense attention only in summation order (~1e-6 relative), which
    Adam can amplify on near-zero gradient elements over the steps."""
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig, llama_head, llama_hidden
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.train import (
        TrainConfig,
        chunked_next_token_loss,
        init_train_state,
        make_train_step,
    )

    class DenseAttentionAdapter(LlamaAdapter):
        """LlamaAdapter whose loss runs the model on dense attention."""

        def make_loss(self, train_cfg, mesh=None, rules=None):
            def loss_fn(params, tokens):
                hidden = llama_hidden(params, tokens, self.config, attn_impl="plain")
                return chunked_next_token_loss(hidden, llama_head(params, self.config), tokens,
                                               train_cfg.z_loss, chunk=train_cfg.ce_chunk)

            return loss_fn

    cfg = dataclasses.replace(LlamaConfig.nexus_1b(), n_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32)
    runs = {}
    counters = _bwd_counters()
    tcfg = TrainConfig(warmup_steps=1, total_steps=3)
    for impl, model in (("auto", LlamaAdapter(config=cfg)), ("plain", DenseAttentionAdapter(config=cfg))):
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), model, tcfg, device="cuda")
        step_fn = make_train_step(model, tcfg)
        data = synthetic_tokens(2, 512, cfg.vocab_size, seed=3)
        before = [c.launches for c in counters]
        rows = []
        for _ in range(3):
            state, m = step_fn(state, torch.as_tensor(next(data), device="cuda").long())
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        runs[impl] = (rows, [c.launches - b for c, b in zip(counters, before)])
        del state
    (got, launched), (ref, plain_launched) = runs["auto"], runs["plain"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    emit("train_e2e", config="nexus_1b widths, 2 layers, f32; batch 2, seq 512, 3 adamw steps",
         kernels=got, plain=ref, max_loss_rel_err=loss_rel, max_grad_norm_rel_err=gn_rel,
         tol_loss_rel=1e-4, tol_grad_norm_rel=1e-3, launches_fwd_dq_dkv=launched,
         plain_launches=plain_launched)
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        raise AssertionError("kernel training steps disagree with the plain path")
    if launched != [cfg.n_layers * 3] * 3 or plain_launched != [0, 0, 0]:
        raise AssertionError(f"launches {launched} (plain {plain_launched}) != {cfg.n_layers} x 3 each")
    torch.cuda.empty_cache()


def phase_train(results):
    """``run_workload`` on nexus_1b at full width and depth: bf16 params,
    adamw, remat attn_out, batch 8, seq 2048, 20 steps, in-memory ledger.
    The counters, zeroed just before, must show 14 launches per step of
    each of the flash forward, dQ and dK/dV kernels: the remat keeps the
    forward's outputs, so the backward never re-runs it."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.llama import LlamaConfig, param_count
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.goodput import model_flops_per_token
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    torch.cuda.empty_cache()
    model = LlamaConfig.nexus_1b()
    steps, batch, seq = 20, 8, 2048
    cfg = WorkloadConfig(model=LlamaAdapter(config=model),
                         train=TrainConfig(warmup_steps=10, total_steps=steps, optimizer="adamw"),
                         batch_size=batch, seq_len=seq, steps=steps, heartbeat_every=5, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-train", algorithm="train", process_id=0, num_processes=1,
                         coordinator=None)
    counters = _bwd_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_workload(cfg, store=store, ctx=ctx, telemetry=NullMetrics())
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "train")
    launches = {c.__name__: c.launches for c in counters}
    row = store.read_checkpoint("train", "chip-smoke-train")
    stage = row.lifecycle_stage if row else None
    flops_per_token = model_flops_per_token(model, seq)
    # steady state: the goodput meter books the first step (allocator and
    # library warm-up) under init_compile; steps 2..N are data + step time
    buckets = summary["goodput"]["buckets_s"]
    steady_tps = (steps - 1) * batch * seq / (buckets["data_draw"] + buckets["step_dispatch"])
    emit("train", config="nexus_1b full width and depth, bf16 params, adamw, remat attn_out",
         batch=batch, seq=seq, steps=steps, params=param_count(model), stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         model_flops_per_token=flops_per_token, peak_flops=PEAK_BF16_FLOPS,
         steady_tokens_per_second=steady_tps,
         steady_mfu=steady_tps * flops_per_token / PEAK_BF16_FLOPS, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    want = model.n_layers * steps
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches} != {model.n_layers} x {steps} each")
    results.setdefault("launches", {})["train"] = launches
    results["train"] = summary


def phase_serve(results):
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    torch.cuda.empty_cache()
    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_serving(cfg, store=store, ctx=ctx)
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "serve")
    launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    row = store.read_checkpoint("serve", "chip-smoke")
    stage = row.lifecycle_stage if row else None
    emit("serve", config="llama3_8b full width and depth, bf16 params", stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, **summary)
    n_layers = model.n_layers
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches["flash_attention"] != n_layers * summary["prefill_calls"]:
        raise AssertionError(f"flash launches {launches['flash_attention']} != {n_layers} x prefill calls")
    if launches["decode_attention"] < n_layers * summary["decode_steps"]:
        raise AssertionError(f"decode launches {launches['decode_attention']} < {n_layers} x decode steps")
    results.setdefault("launches", {})["serve"] = launches


class WeightBytes(logging.Handler):
    """Reads the quantized tree's footprint from the line the serve workload logs."""

    value = None

    def emit(self, record):
        if "weight bytes" in str(record.msg):
            self.value = record.args[1]


def _serve_quantized(results, name, model, quantize, quantize_kv, ring_per_layer, label, rounds=3):
    """One ``run_serving`` with quantized weights (bf16 params, batch 8,
    prompt 128, 32 new tokens): COMPLETED, and the counters, zeroed just
    before, at exactly ``ring_per_layer`` x layers x decode steps
    dequant-matmul launches, all of the int8 or int4 ring kernel (prefill's
    1024 rows take the dense matmul), layers x prefill calls flash launches
    and, with an int8 cache, layers x decode steps of #4's int8-KV mode.
    Returns the summary with the weight bytes and the peak memory."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    serve_log = logging.getLogger("tpu_nexus_torch.workload.serve")
    n_layers = model.n_layers
    torch.cuda.empty_cache()
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=rounds, device="cuda",
                      quantize=quantize, quantize_kv=quantize_kv)
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id=name, algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    reset_launches()
    quant_matmul.launches_int8 = quant_matmul.launches_int4 = 0
    quant_matmul.launches_by_route.update(dict.fromkeys(quant_matmul.launches_by_route, 0))
    weight_bytes = WeightBytes(level=logging.INFO)
    serve_log.addHandler(weight_bytes)
    level = serve_log.level
    serve_log.setLevel(logging.INFO)
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    try:
        summary = run_serving(cfg, store=store, ctx=ctx)
    finally:
        serve_log.removeHandler(weight_bytes)
        serve_log.setLevel(level)
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, name)
    launches = {
        "flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
        "decode_attention_int8kv": decode_attention.launches_by_mode["contiguous+int8"],
        "quant_matmul_int8": quant_matmul.launches_int8, "quant_matmul_int4": quant_matmul.launches_int4,
        **{f"quant_matmul_{r}": c for r, c in quant_matmul.launches_by_route.items()},
    }
    row = store.read_checkpoint("serve", name)
    stage = row.lifecycle_stage if row else None
    peak = torch.cuda.max_memory_allocated()
    emit(label, run=name, config=f"{model.__class__.__name__} {n_layers} layers, hidden {model.hidden}, bf16 params, "
         f"quantize={quantize!r} quantize_kv={quantize_kv!r}", stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall, max_memory_allocated=peak,
         launches=launches, weight_bytes=weight_bytes.value, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"{name}: ledger row is {stage}, not COMPLETED")
    rings = ring_per_layer * n_layers * summary["decode_steps"]
    want = {
        "flash_attention": n_layers * summary["prefill_calls"],
        "decode_attention_int8kv": n_layers * summary["decode_steps"] if quantize_kv else 0,
        "quant_matmul_int8": rings if quantize == "int8" else 0,
        "quant_matmul_int4": rings if quantize == "int4" else 0,
        # every decode-step product of the quantized configurations goes through a ring kernel
        "quant_matmul_int8_ring": rings if quantize == "int8" else 0,
        "quant_matmul_int4_ring": rings if quantize == "int4" else 0,
    }
    wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if wrong or launches["decode_attention"] < n_layers * summary["decode_steps"]:
        raise AssertionError(f"{name}: launches (got, want) {wrong or launches}")
    results.setdefault("launches", {})[name] = launches
    return dict(summary, weight_bytes=weight_bytes.value, max_memory_allocated=peak)


def phase_serve_quant(results):
    """``run_serving`` on llama3_8b at full width and depth with quantized
    weights: int8 weights + int8 KV cache, then int4 weights (group 64);
    exactly 7 dequant-matmul launches per layer per decode step (wq, wk,
    wv, wo, w_gate, w_up, w_down), all of them of the ring kernel."""
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig

    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    for name, quantize, quantize_kv in (("serve_int8", "int8", "int8"), ("serve_int4", "int4", "")):
        _serve_quantized(results, name, model, quantize, quantize_kv, 7, "serve_quant")


def _quantized_generate_parity(label, cfg, params, kv_modes, ring_per_layer, prompt_len=128, new_tokens=32):
    """Greedy ``generate`` of quantized trees (f32) through the kernels
    against the plain path (dequantize-then-einsum, plain attention):
    token-identical, with exactly ``ring_per_layer`` x layers x decode
    steps dequant-matmul launches and, with an int8 cache, layers x
    decode steps of #4's int8-KV mode."""
    import torch

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.quant import quantize_params
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul

    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, prompt_len), generator=g, device="cuda", dtype=torch.int32)
    steps = new_tokens - 1
    for mode, kv_quant in kv_modes:
        qparams = quantize_params(params, mode=mode)
        counter = f"launches_{mode}"
        counts = lambda: (getattr(quant_matmul, counter), decode_attention.launches_by_mode["contiguous+int8"])  # noqa: E731
        before = counts()
        with_kernels = generate(qparams, prompt, cfg, max_new_tokens=new_tokens, kv_quant=kv_quant)
        launched = tuple(n - b for n, b in zip(counts(), before))
        os.environ["NEXUS_QUANT_KERNEL"] = "plain"
        try:
            plain = generate(qparams, prompt, cfg, max_new_tokens=new_tokens, kv_quant=kv_quant, attn_impl="plain",
                             decode_kernel="plain")
        finally:
            del os.environ["NEXUS_QUANT_KERNEL"]
        torch.cuda.synchronize()
        same = bool(torch.equal(with_kernels, plain))
        emit(label, config=f"{cfg.__class__.__name__} hidden {cfg.hidden}, {cfg.n_layers} layers, f32, {mode} weights, "
             f"kv_quant={kv_quant!r}", batch=4, prompt=prompt_len, new_tokens=new_tokens, token_identical=same,
             mismatched_tokens=int((with_kernels != plain).sum()), quant_matmul_launches=launched[0],
             int8kv_decode_launches=launched[1])
        want = (ring_per_layer * cfg.n_layers * steps, cfg.n_layers * steps if kv_quant else 0)
        if not same or launched != want:
            raise AssertionError(f"{label} {mode}: kernel path is not token-identical to the plain path "
                                 f"(or launches {launched} != {want})")
        del qparams


def phase_profile(results, quantize="", kv_quant=""):
    """Opt-in (``--phases build,profile``): one warm ``generate`` round of
    the serve phase's shape under ``torch.profiler``; device time by
    kernel group and the device's busy share of the window.
    ``profile_int8`` and ``profile_int4`` do the same with the serve_quant
    phase's two configurations (int8 weights + int8 KV; int4 weights)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.models.quant import quantize_params
    from tpu_nexus_torch.workload.data import synthetic_tokens

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    if quantize:
        params = quantize_params(params, mode=quantize)
        torch.cuda.empty_cache()
    prompts = synthetic_tokens(8, 128, cfg.vocab_size, seed=101)
    generate(params, torch.as_tensor(next(prompts), device="cuda"), cfg, max_new_tokens=32, kv_quant=kv_quant)
    batch = torch.as_tensor(next(prompts), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(params, batch, cfg, max_new_tokens=32, kv_quant=kv_quant)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # the same round, no profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(params, batch, cfg, max_new_tokens=32, kv_quant=kv_quant)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def group_of(low):
        if "flash_fwd" in low:
            return "flash_attention kernel"
        if "decode_hopper" in low or "decode_partial" in low or "decode_combine" in low:
            return "decode_attention kernel"
        if "quant_matmul" in low or "quant_int4_ring" in low or "quant_int8_ring" in low:
            return "quant_matmul kernels (int8 ring, int4 ring; first design's partial + finalize)"
        if any(s in low for s in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, copies, reductions)"

    groups, top = _group_device_time(prof, group_of)
    device_ms = sum(groups.values())
    emit("profile", config=f"llama3_8b full depth, bf16 params, quantize={quantize!r} kv_quant={kv_quant!r}; "
         "one generate round: batch 8, prompt 128, 32 new tokens", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, idle_share=1 - device_ms / wall_ms,
         busy_share_of_unprofiled_round=device_ms / plain_wall_ms,
         groups_ms=groups, top=[{"ms": t, "calls": c, "name": n} for t, c, n in top[:12]])
    del params
    # the quantized rounds' decode-sized products are one launch each: no finalize pass among the kernels
    finalize = [n for _, _, n in top[:12] if "finalize" in n.lower()]
    if quantize and finalize:
        raise AssertionError(f"profile quantize={quantize!r}: a finalize kernel in the top list: {finalize}")


def _group_device_time(prof, groups_of):
    """Device ms by group and the top kernels of a profiler run."""
    groups, top = {}, []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us or "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        group = groups_of(evt.key.lower())
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    return groups, top


def phase_train_profile(results):
    """Opt-in (``--phases build,train_profile``): two warm training steps of
    the train phase's shape (nexus_1b, bf16, adamw, attn_out, batch 8, seq
    2048) under ``torch.profiler``; device time by kernel group, the top
    kernels, and the device's busy share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.registry import host_to_device
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.health import HealthConfig
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

    cfg = LlamaConfig.nexus_1b()
    tcfg = TrainConfig(warmup_steps=10, total_steps=20)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tcfg, device="cuda")
    step_fn = make_train_step(cfg, tcfg, health=HealthConfig())
    data = synthetic_tokens(8, 2048, cfg.vocab_size, seed=0)
    batches = [host_to_device(next(data), "cuda", torch.long) for _ in range(6)]
    for batch in batches[:2]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:4]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[4:]:
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2

    def group_of(low):
        if "flash_bwd_dq" in low:
            return "flash backward dQ kernel"
        if "flash_bwd_dkv" in low:
            return "flash backward dK/dV kernel"
        if "flash_fwd" in low:
            return "flash forward kernel"
        if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        return "other (elementwise, reductions, copies)"

    groups, top = _group_device_time(prof, group_of)
    groups = {k: v / 2 for k, v in groups.items()}
    device_ms = sum(groups.values())
    emit("train_profile", config="nexus_1b full depth, bf16, adamw, attn_out; batch 8, seq 2048; "
         "ms per step, mean of 2 profiled steps", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         busy_share_of_unprofiled_step=device_ms / plain_wall_ms, groups_ms=groups,
         top=[{"ms_per_step": t / 2, "calls": c // 2, "name": n} for t, c, n in top[:20]])
    del state, batches


# -- the MoE slice: grouped matmul (kernels #7 and #8), MoE training and serving --


#: grouped-matmul cases of moe_parity: (M, K, N, block_m, tiles per expert,
#: dtypes).  The nexus_moe train step's shapes (gate/up and down, bm 512,
#: m_pad 36864 = 72 tiles; expert 1 holds only its padding tile), a bm-128
#: layout, and Mixtral-8x7B's gate at one layer (K 4096, N 14336).
GMM_PARITY_CASES = [
    (36864, 1024, 2048, 512, (20, 1, 8, 12, 9, 7, 10, 5), ("bfloat16", "float32")),
    (36864, 2048, 1024, 512, (20, 1, 8, 12, 9, 7, 10, 5), ("bfloat16", "float32")),
    (4096, 1024, 2048, 128, (1, 10, 3, 4, 6, 2, 5, 1), ("bfloat16", "float32")),
    (12288, 4096, 14336, 512, (3, 3, 4, 2, 3, 3, 3, 3), ("bfloat16",)),
]
#: f32 limit on max-abs error relative to the reference's largest magnitude
#: (kernel and plain version differ in the order of the f32 sums only)
GMM_F32_MAXABS_REL = 1e-5
#: edge cases of moe_parity, each through gmm, gmm on rhsᵀ and tgmm in bf16
#: and f32: (what, M, K, N, block_m, E, tile_expert)
GMM_EDGE_CASES = [
    ("K and N not multiples of 64", 1024, 200, 72, 128, 4, (0, 0, 0, 1, 2, 2, 3, 3)),
    ("a ragged last slab and column tile", 2048, 1000, 1336, 256, 3, (0, 0, 0, 1, 1, 2, 2, 2)),
    ("K of one slab", 1024, 64, 512, 128, 2, (0, 0, 0, 0, 1, 1, 1, 1)),
    ("K under one slab", 512, 8, 256, 128, 2, (0, 1, 1, 1)),
    ("M of one tile: fewer units than SMs", 128, 1024, 2048, 128, 1, (0,)),
    ("an unsorted tile_expert", 1024, 256, 384, 128, 4, (2, 0, 3, 1, 0, 2, 3, 0)),
    ("expert ids outside [0, E): gmm writes zeros, tgmm skips them", 1024, 256, 384, 128, 3,
     (0, -1, 1, 3, 1, 2, 7, 0)),
    ("300 experts: tgmm past the ranked table, in expert order", 2048, 128, 256, 128, 300,
     (0, 299, 5, 5, 150, 299, 0, 7, 8, 9, 10, 11, 12, 13, 14, 15)),
]


def tile_map(tiles_per_expert):
    import torch

    return torch.repeat_interleave(
        torch.arange(len(tiles_per_expert), dtype=torch.int32), torch.tensor(tiles_per_expert)
    ).to("cuda")


def gmm_inputs(m, k, n, e, dtype, seed, transpose=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    rhs = (torch.randn((e, n, k) if transpose else (e, k, n), generator=g, device="cuda") * k**-0.5).to(dtype)
    return lhs, rhs


def _gmm_check(out, again, ref, dtype):
    """(ok, fields): bit-identical twice, finite, and within the limits."""
    import torch

    same = bool(torch.equal(out, again))
    err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
    good = e_row <= ROW_REL_TOL if dtype == torch.bfloat16 else err <= GMM_F32_MAXABS_REL * ref_max
    ok = same and good and bool(torch.isfinite(out).all())
    return ok, dict(max_abs_err=err, ref_max_abs=ref_max, max_row_rel_err=e_row, bit_identical_twice=same,
                    tol_f32_max_abs_rel=GMM_F32_MAXABS_REL, tol_bf16_row_rel=ROW_REL_TOL, ok=ok)


def phase_moe_parity(results):
    """Kernels #7 (forward and the transposed-rhs d_lhs call) and #8 against
    ``gmm_plain`` / ``tgmm_plain`` on the card, each run twice."""
    import torch

    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain

    worst = {"nexus_gmm": 0.0, "nexus_tgmm": 0.0}
    seed = 6000
    for m, k, n, bm, tiles, dtypes in GMM_PARITY_CASES:
        te = tile_map(tiles)
        e = len(tiles)
        for name in dtypes:
            dtype = getattr(torch, name)
            for kind in ("gmm", "gmm_transposed_rhs", "tgmm"):
                if kind == "tgmm" and k * n > 1024 * 2048:
                    continue  # the weight gradient runs at the train step's shapes only
                seed += 1
                transpose = kind == "gmm_transposed_rhs"
                lhs, rhs = gmm_inputs(m, k, n, e, dtype, seed, transpose)
                if kind == "tgmm":
                    d_out = torch.randn((m, n), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                                        device="cuda").to(dtype)
                    out, again = (tgmm_kernel_call(lhs, d_out, te, e, bm) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = tgmm_plain(lhs, d_out, te, e, bm)
                else:
                    out, again = (gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = gmm_plain(lhs, rhs.transpose(1, 2) if transpose else rhs, te, bm)
                ok, fields = _gmm_check(out, again, ref, dtype)
                emit("moe_parity", kernel=kind, m=m, k=k, n=n, block_m=bm, tiles_per_expert=list(tiles),
                     dtype=name, **fields)
                if not ok:
                    raise AssertionError(f"{kind} kernel disagrees with its plain version: M{m} K{k} N{n} {name}")
                key = "nexus_tgmm" if kind == "tgmm" else "nexus_gmm"
                if dtype == torch.bfloat16 and (m, k, n) == (36864, 1024, 2048):
                    worst[key] = max(worst[key], fields["max_abs_err"])
                del lhs, rhs, out, again, ref
                torch.cuda.empty_cache()
    for what, m, k, n, bm, e, te_list in GMM_EDGE_CASES:
        te = torch.tensor(te_list, dtype=torch.int32, device="cuda")
        outside = torch.tensor([not 0 <= x < e for x in te_list], device="cuda").repeat_interleave(bm)
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            for kind in ("gmm", "gmm_transposed_rhs", "tgmm"):
                seed += 1
                transpose = kind == "gmm_transposed_rhs"
                lhs, rhs = gmm_inputs(m, k, n, e, dtype, seed, transpose)
                if kind == "tgmm":
                    d_out = torch.randn((m, n), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                                        device="cuda").to(dtype)
                    out, again = (tgmm_kernel_call(lhs, d_out, te, e, bm) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = tgmm_plain(lhs, d_out, te, e, bm)
                    zeros_ok = True
                else:
                    out, again = (gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose) for _ in range(2))
                    torch.cuda.synchronize()
                    ref = gmm_plain(lhs, rhs.transpose(1, 2) if transpose else rhs, te, bm)
                    zeros_ok = not bool(out[outside].any())
                ok, fields = _gmm_check(out, again, ref, dtype)
                emit("moe_parity", kernel=kind, case=what, m=m, k=k, n=n, block_m=bm, experts=e,
                     tile_expert=list(te_list), dtype=name, rows_of_outside_ids_zero=zeros_ok, **fields)
                if not (ok and zeros_ok):
                    raise AssertionError(f"{kind} kernel disagrees with its plain version: {what}, {name}")
                del lhs, rhs, out, again, ref
    torch.cuda.empty_cache()
    # an expert with no tile at all: tgmm writes its block as zeros
    te = tile_map((2, 0, 2))
    lhs, _ = gmm_inputs(512, 256, 256, 3, torch.bfloat16, 6500)
    d_out = torch.randn((512, 256), device="cuda").to(torch.bfloat16)
    out = tgmm_kernel_call(lhs, d_out, te, 3, 128)
    torch.cuda.synchronize()
    emit("moe_parity", kernel="tgmm", case="expert 1 owns no tile", max_abs_of_absent_block=float(out[1].abs().max()))
    if float(out[1].abs().max()) != 0.0:
        raise AssertionError("tgmm wrote a nonzero block for an expert with no tile")
    results.setdefault("max_abs_err", {}).update(worst)


def gmm_bound(m, k, n, e, dtype, tgmm=False):
    """Least time: 2MKN operations at the peak of the inputs' type, or the
    inputs read once and the output written once at the HBM rate."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    if tgmm:  # lhs [M,K], d_out [M,N] -> f32 [E,K,N]
        nbytes = (m * k + m * n) * itemsize + e * k * n * 4
    else:  # lhs [M,K], rhs [E,K,N] -> [M,N]
        nbytes = (m * k + e * k * n + m * n) * itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * m * k * n / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def event_ms(fn, iters=3):
    """Mean ms per call between CUDA events around ``iters`` calls, host
    gaps included: for the plain versions, which read tile_expert on the
    host (``nonzero``) and so cannot be enqueued behind a spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grouped_library(lhs, rhs, tiles, bm, tgmm_out=None):
    """``(fn, what)``: one PyTorch call for the same grouped product, as a
    yardstick the port never calls.  ``torch._grouped_mm`` with group
    offsets where this PyTorch has it and takes the layout; else a loop of
    E ``torch.matmul`` over the expert runs (host offsets)."""
    import torch

    ends = [bm * sum(tiles[: i + 1]) for i in range(len(tiles))]
    offs = torch.tensor(ends, dtype=torch.int32, device="cuda")
    starts = [0] + ends[:-1]
    grouped = getattr(torch, "_grouped_mm", None)
    if tgmm_out is None:
        candidates = [("torch._grouped_mm(lhs, rhs, offs)", lambda: grouped(lhs, rhs, offs=offs)),
                      ("torch._grouped_mm(lhs, rhs column-major, offs)",
                       (lambda rc=rhs.transpose(1, 2).contiguous().transpose(1, 2): grouped(lhs, rc, offs=offs)))]
        loop = ("loop of E torch.matmul over the expert runs",
                lambda: [torch.matmul(lhs[s:t], rhs[i]) for i, (s, t) in enumerate(zip(starts, ends))])
    else:
        d_out = tgmm_out
        candidates = [("torch._grouped_mm(lhs.T, d_out, offs)", lambda: grouped(lhs.T, d_out, offs=offs,
                                                                                  out_dtype=torch.float32)),
                      ("torch._grouped_mm(lhs.T contiguous, d_out, offs)",
                       (lambda lt=lhs.T.contiguous(): grouped(lt, d_out, offs=offs, out_dtype=torch.float32)))]
        loop = ("loop of E torch.matmul over the expert runs (bf16 out)",
                lambda: [torch.matmul(lhs[s:t].T, d_out[s:t]) for s, t in zip(starts, ends)])
    if grouped is not None:
        for what, fn in candidates:
            try:
                fn()
                torch.cuda.synchronize()
                return fn, what
            except (RuntimeError, TypeError, ValueError):
                continue
    return loop[1], loop[0]


def moe_times(times):
    """Kernels #7 and #8 at the nexus_moe train step's shapes (B8 S2048:
    T 16384, A 32768, bm 512, m_pad 36864; gate/up, down, the d_lhs call,
    the weight gradient) and #7 at Mixtral-8x7B's gate for one layer (T
    4096, m_pad 12288, K 4096, N 14336), bf16, uneven expert runs.  Two
    input sets per shape, cycled, so operands come from HBM."""
    import torch

    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain

    dt = torch.bfloat16
    tiles_nexus, tiles_mixtral = (9, 8, 10, 9, 8, 9, 10, 9), (3, 3, 4, 2, 3, 3, 3, 3)
    rows = (
        ("nexus_gmm", "gmm gate/up (nexus_moe train step)", 36864, 1024, 2048, tiles_nexus, "gmm"),
        (None, "gmm down (nexus_moe train step)", 36864, 2048, 1024, tiles_nexus, "gmm"),
        (None, "gmm d_lhs of gate/up, rhs read transposed", 36864, 2048, 1024, tiles_nexus, "gmm_t"),
        ("nexus_tgmm", "tgmm d_rhs of gate/up (nexus_moe train step)", 36864, 1024, 2048, tiles_nexus, "tgmm"),
        ("nexus_gmm_mixtral", "gmm gate (mixtral_8x7b, one layer)", 12288, 4096, 14336, tiles_mixtral, "gmm"),
    )
    for key, what, m, k, n, tiles, kind in rows:
        te, e, bm = tile_map(tiles), len(tiles), 512
        if kind == "tgmm":
            sets = []
            for i in range(2):
                g = torch.Generator(device="cuda").manual_seed(7000 + i)
                sets.append((torch.randn((m, k), generator=g, device="cuda").to(dt),
                             torch.randn((m, n), generator=g, device="cuda").to(dt)))
            kern = [lambda s=s: tgmm_kernel_call(s[0], s[1], te, e, bm) for s in sets]
            plain = lambda s=sets[0]: tgmm_plain(s[0], s[1], te, e, bm)  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], None, tiles, bm, tgmm_out=sets[0][1])
            bound, by = gmm_bound(m, k, n, e, dt, tgmm=True)
        else:
            transpose = kind == "gmm_t"
            sets = [gmm_inputs(m, k, n, e, dt, 7200 + i, transpose) for i in range(2)]
            kern = [lambda s=s: gmm_kernel_call(s[0], s[1], te, bm, transpose_rhs=transpose) for s in sets]
            plain = (lambda s=sets[0]: gmm_plain(s[0], s[1].transpose(1, 2) if transpose else s[1], te, bm))  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], sets[0][1].transpose(1, 2) if transpose else sets[0][1],
                                            tiles, bm)
            bound, by = gmm_bound(m, k, n, e, dt)
        ms, enqueue_ms = timed(kern, iters=20)
        row = dict(shape=[m, k, n, e], block_m=bm, tiles_per_expert=list(tiles), dtype="bfloat16", ms=ms,
                   enqueue_ms=enqueue_ms, plain_ms=event_ms(plain), library_ms=cuda_ms([lib], iters=20),
                   library_ms_is=lib_what, bound_ms=bound, bound_by=by, share=bound / ms)
        emit("times", kernel=what, plain_ms_is="events around calls that read tile_expert on the host", **row)
        if key:
            times[key] = row
        del sets, kern, plain, lib
        torch.cuda.empty_cache()


class plain_grouped_matmul:
    """Within the block, ``ops.grouped_matmul``'s two wrappers are replaced
    by their plain versions, so the model runs the same code with the
    kernels' arithmetic in plain PyTorch (what ``attn_impl="plain"`` is to
    attention)."""

    def __enter__(self):
        from tpu_nexus_torch.ops import grouped_matmul as gm

        self.saved = gm.gmm_kernel_call, gm.tgmm_kernel_call
        gm.gmm_kernel_call = lambda lhs, rhs, te, bm, transpose_rhs=False: gm.gmm_plain(
            lhs, rhs.transpose(1, 2) if transpose_rhs else rhs, te, bm)
        gm.tgmm_kernel_call = gm.tgmm_plain
        return self

    def __exit__(self, *exc):
        from tpu_nexus_torch.ops import grouped_matmul as gm

        gm.gmm_kernel_call, gm.tgmm_kernel_call = self.saved
        return False


def _moe_counters():
    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, tgmm_kernel_call

    return (gmm_kernel_call, tgmm_kernel_call) + _bwd_counters()


def moe_launches_per_step(cfg):
    """(gmm, tgmm, flash fwd, dQ, dK/dV) launches of one MoE train step.
    Per layer the forward runs three gmm (gate, up, down); under a
    checkpointing policy the backward re-runs them (the "attn_out" and
    "qkv" policies keep the flash outputs, so attention's forward does not
    re-run, while "nothing" re-runs it); the backward adds one gmm on rhsᵀ
    (d_lhs) and one tgmm (d_rhs) per product."""
    recompute = cfg.remat and cfg.remat_policy != "dots"
    l = cfg.n_layers
    flash_fwd = l * (2 if recompute and cfg.remat_policy == "nothing" else 1)
    return (l * 3 * (3 if recompute else 2), 3 * l, flash_fwd, l, l)


def phase_moe_train_e2e(results):
    """nexus_moe widths at 2 layers in f32, dispatch gmm: 3 adamw steps
    through the kernels against 3 through the plain versions (dense
    attention, ``plain_grouped_matmul``) on the card, same init and
    batches; the limits of ``train_e2e``; nothing dropped."""
    import torch

    from tpu_nexus_torch.models.moe import MoeConfig, moe_head, moe_hidden
    from tpu_nexus_torch.models.registry import MoeAdapter
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.train import TrainConfig, chunked_next_token_loss, init_train_state, make_train_step

    class PlainMoeAdapter(MoeAdapter):
        """MoeAdapter whose loss runs dense attention."""

        def make_loss(self, train_cfg, mesh=None, rules=None):
            cfg = self.config

            def loss_fn(params, tokens):
                hidden, aux = moe_hidden(params, tokens, cfg, attn_impl="plain")
                loss, metrics = chunked_next_token_loss(hidden, moe_head(params, cfg), tokens, train_cfg.z_loss,
                                                        chunk=train_cfg.ce_chunk)
                loss = loss + cfg.load_balance_coef * aux["load_balance"] + cfg.router_z_coef * aux["router_z"]
                return loss, dict(metrics, dropped_frac=aux["dropped_frac"])

            return loss_fn

    cfg = dataclasses.replace(MoeConfig.nexus_moe(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    tcfg = TrainConfig(warmup_steps=1, total_steps=3)
    counters = _moe_counters()
    runs = {}
    for impl, model in (("kernels", MoeAdapter(config=cfg)), ("plain", PlainMoeAdapter(config=cfg))):
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), model, tcfg, device="cuda")
        step_fn = make_train_step(model, tcfg)
        data = synthetic_tokens(2, 512, cfg.vocab_size, seed=3)
        before = [c.launches for c in counters]
        rows = []
        with plain_grouped_matmul() if impl == "plain" else contextlib.nullcontext():
            for _ in range(3):
                state, m = step_fn(state, torch.as_tensor(next(data), device="cuda").long())
                rows.append((float(m["loss"]), float(m["grad_norm"]), float(m["dropped_frac"])))
        runs[impl] = (rows, [c.launches - b for c, b in zip(counters, before)])
        del state
    (got, launched), (ref, plain_launched) = runs["kernels"], runs["plain"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref))
    dropped = max(r[2] for r in got + ref)
    want = [3 * n for n in moe_launches_per_step(cfg)]
    emit("moe_train_e2e", config="nexus_moe widths, 2 layers, f32, dispatch gmm; batch 2, seq 512, 3 adamw steps",
         kernels=got, plain=ref, max_loss_rel_err=loss_rel, max_grad_norm_rel_err=gn_rel, max_dropped_frac=dropped,
         tol_loss_rel=1e-4, tol_grad_norm_rel=1e-3, launches_gmm_tgmm_fwd_dq_dkv=launched, want=want,
         plain_launches=plain_launched)
    if loss_rel > 1e-4 or gn_rel > 1e-3 or dropped != 0.0:
        raise AssertionError("MoE kernel training steps disagree with the plain path (or dropped tokens)")
    if launched != want or plain_launched != [0] * len(counters):
        raise AssertionError(f"launches {launched} (plain {plain_launched}) != {want}")
    torch.cuda.empty_cache()


def phase_train_moe(results):
    """``run_workload`` on nexus_moe at full width and depth (bf16 params,
    dispatch gmm, remat attn_out; adamw, batch 8, seq 2048, 20 steps) into
    an in-memory ledger: COMPLETED, exactly the derived gmm, tgmm and flash
    launches, nothing dropped; steady tokens/s, MFU, peak memory and the
    goodput buckets."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.moe import MoeConfig, moe_param_count
    from tpu_nexus_torch.models.registry import MoeAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.goodput import model_flops_per_token
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    torch.cuda.empty_cache()
    model = MoeConfig.nexus_moe()
    steps, batch, seq = 20, 8, 2048
    cfg = WorkloadConfig(model=MoeAdapter(config=model),
                         train=TrainConfig(warmup_steps=10, total_steps=steps, optimizer="adamw"),
                         batch_size=batch, seq_len=seq, steps=steps, heartbeat_every=5, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-train-moe", algorithm="train", process_id=0, num_processes=1,
                         coordinator=None)
    counters = _moe_counters()
    names = ("nexus_gmm", "nexus_tgmm", "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_workload(cfg, store=store, ctx=ctx, telemetry=NullMetrics())
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "train_moe")
    launches = {name: c.launches for name, c in zip(names, counters)}
    row = store.read_checkpoint("train", "chip-smoke-train-moe")
    stage = row.lifecycle_stage if row else None
    flops_per_token = model_flops_per_token(model, seq)
    buckets = summary["goodput"]["buckets_s"]
    steady_tps = (steps - 1) * batch * seq / (buckets["data_draw"] + buckets["step_dispatch"])
    want = {name: n * steps for name, n in zip(names, moe_launches_per_step(model))}
    emit("train_moe", config="nexus_moe full width and depth, bf16 params, dispatch gmm, adamw, remat attn_out",
         batch=batch, seq=seq, steps=steps, params=moe_param_count(model), stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, want_launches=want,
         model_flops_per_token=flops_per_token, peak_flops=PEAK_BF16_FLOPS, steady_tokens_per_second=steady_tps,
         steady_mfu=steady_tps * flops_per_token / PEAK_BF16_FLOPS, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if summary.get("dropped_frac") != 0.0:
        raise AssertionError(f"dropped_frac {summary.get('dropped_frac')} != 0 on the dropless path")
    results.setdefault("launches", {})["train_moe"] = launches
    results["train_moe"] = summary


def phase_serve_moe(results):
    """``run_serving`` on nexus_moe at full width and depth (bf16 params;
    decode dispatches by scatter at a dropless capacity, as the reference):
    batch 8, prompt 128, 32 new tokens, 3 rounds; COMPLETED with exactly
    layers x prefill calls flash and layers x decode steps decode launches.
    Then greedy ``generate`` at 2 layers in f32, kernels against plain:
    token-identical."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.moe import MoeConfig, moe_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    torch.cuda.empty_cache()
    model = MoeConfig.nexus_moe()
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-moe", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = decode_attention.launches = 0
    zero_rms_norm_launches()
    t0 = time.perf_counter()
    summary = run_serving(cfg, store=store, ctx=ctx)
    wall = time.perf_counter() - t0
    read_rms_norm_launches(results, "serve_moe")
    launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    row = store.read_checkpoint("serve", "chip-smoke-moe")
    stage = row.lifecycle_stage if row else None
    want = {"flash_attention": model.n_layers * summary["prefill_calls"],
            "decode_attention": model.n_layers * summary["decode_steps"]}
    emit("serve_moe", config="nexus_moe full width and depth, bf16 params", stage=stage,
         per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches, want_launches=want, **summary)
    if stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"ledger row is {stage}, not COMPLETED")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    results.setdefault("launches", {})["serve_moe"] = launches

    small = dataclasses.replace(model, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = moe_init(torch.Generator(device="cuda").manual_seed(0), small, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, small.vocab_size, (4, 128), generator=g, device="cuda", dtype=torch.int32)
    f0, d0 = flash_attention.launches, decode_attention.launches
    with_kernels = generate(params, prompt, small, max_new_tokens=32)
    launched = (flash_attention.launches - f0, decode_attention.launches - d0)
    plain = generate(params, prompt, small, max_new_tokens=32, attn_impl="plain", decode_kernel="plain")
    torch.cuda.synchronize()
    same = bool(torch.equal(with_kernels, plain))
    emit("serve_moe", config="nexus_moe widths, 2 layers, f32: greedy generate, kernels vs plain", batch=4,
         prompt=128, new_tokens=32, token_identical=same, mismatched_tokens=int((with_kernels != plain).sum()),
         flash_launches=launched[0], decode_launches=launched[1])
    if not same or launched != (small.n_layers, small.n_layers * 31):
        raise AssertionError("MoE kernel decode is not token-identical to the plain path (or skipped a kernel)")
    del params


def phase_serve_moe_quant(results):
    """Quantized MoE serving: ``run_serving`` on nexus_moe at full width
    and depth (bf16 params, batch 8, prompt 128, 32 new tokens, 3 rounds)
    with int8 weights + int8 KV, then int4 weights (group 64); Mixtral-8x7B
    widths at 4 of its 32 layers with int4 weights, one round.  Each run
    COMPLETED with exactly 4 dequant-matmul launches per layer per decode
    step (wq, wk, wv, wo on the ring kernel; the expert stacks keep their
    lead dim and are dequantized before their einsum), its weight bytes and
    peak memory; the time of dequantizing one Mixtral expert leaf.  Then
    greedy ``generate`` at nexus_moe widths, 2 layers, f32, int8 weights +
    int8 KV and int4 weights: kernels against plain, token-identical."""
    import torch

    from tpu_nexus_torch.models.moe import MoeConfig, moe_init
    from tpu_nexus_torch.models.quant import quantize_tensor_int4

    nexus = MoeConfig.nexus_moe()
    mixtral = dataclasses.replace(MoeConfig.mixtral_8x7b(), n_layers=4, param_dtype=torch.bfloat16)
    runs = (("serve_moe_int8", nexus, "int8", "int8", 3), ("serve_moe_int4", nexus, "int4", "", 3),
            ("serve_mixtral4_int4", mixtral, "int4", "", 1))
    for name, model, quantize, quantize_kv, rounds in runs:
        _serve_quantized(results, name, model, quantize, quantize_kv, 4, "serve_moe_quant", rounds=rounds)

    # what a decode step pays for the reference's dequantize-then-einsum of
    # one Mixtral expert stack [8, 4096, 14336] (three a layer)
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn((mixtral.n_experts, mixtral.hidden, mixtral.intermediate), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    leaf = quantize_tensor_int4(w, (-2,), 64, name="w_gate")
    del w
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms([lambda: leaf.to(torch.bfloat16)], iters=5, warmup=1)
    emit("serve_moe_quant", run="mixtral_expert_dequant", shape=list(leaf.shape), group=64,
         packed_bytes=leaf.q.numel() + leaf.s.numel() * 4, dequant_ms=ms,
         dequant_ms_per_decode_step=ms * 3 * mixtral.n_layers,
         peak_transient_bytes=torch.cuda.max_memory_allocated() - base)
    del leaf
    torch.cuda.empty_cache()

    small = dataclasses.replace(nexus, n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = moe_init(torch.Generator(device="cuda").manual_seed(0), small, device="cuda")
    _quantized_generate_parity("serve_moe_quant", small, params, (("int8", "int8"), ("int4", "")), 4)
    del params
    torch.cuda.empty_cache()


#: the quant_gate phase's training: nexus_moe at the gate's batch (32 x 2048)
#: for these steps, then both gates' measurements with the decode gate over
#: QUANT_GATE_DECODE batches of 8 x QUANT_GATE_DECODE_SEQ tokens
QUANT_GATE_STEPS = 100
#: held-out batches of the forward gates (32 x 2048 tokens each), cut from
#: the gate tool's 8 for the script's time
QUANT_GATE_EVAL = 4
QUANT_GATE_DECODE = 1
QUANT_GATE_DECODE_SEQ = 128


def _gate(line):
    """A gate's JSON line with its ``phase`` key renamed ``gate_phase``."""
    return {"gate_phase" if k == "phase" else k: v for k, v in line.items()}


def phase_quant_gate(results):
    """The perplexity gates of quantized serving on the card, at a short
    training: nexus_moe trained once on the gates' corpus
    (:data:`QUANT_GATE_STEPS` steps), then the int8 gate's measurements
    (forward int8 weights < 1 %; decode int8 KV < 1 %, int8 weights + KV
    < 2 %) and the int4 gate's (int8 < 1 %, int4 group 64 < 2 %, forward and
    decode).  Fails if the model did not train (ppl >= 256) or any gate
    does not pass."""
    import torch

    from tpu_nexus_torch.tools import int4_gate_1b as gate4
    from tpu_nexus_torch.tools import int8_gate_1b as gate8

    torch.cuda.empty_cache()
    tier = gate8.gate_tier("nexus_moe")
    device = torch.device("cuda")
    path = gate8.write_corpus("chip_smoke_gate_corpus.npy", tier.n_tokens)
    try:
        t0 = time.perf_counter()
        params = gate8.train(tier, QUANT_GATE_STEPS, path, device, log=lambda line: emit("quant_gate", **_gate(line)))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sizes = dict(eval_batches=QUANT_GATE_EVAL, decode_batches=QUANT_GATE_DECODE, decode_seq=QUANT_GATE_DECODE_SEQ)
        lines = [dict(line, gate="int8") for line in gate8.measure(params, tier, path, device, QUANT_GATE_STEPS,
                                                                      **sizes)]
        lines += [dict(line, gate="int4") for line in gate4.measure(params, tier, path, device, QUANT_GATE_STEPS,
                                                                       64, **sizes)]
        measure_s = time.perf_counter() - t0
    finally:
        os.remove(path)
    for line in lines:
        emit("quant_gate", **_gate(line))
    emit("quant_gate", model=tier.model, batch=tier.batch, seq=tier.seq, steps=QUANT_GATE_STEPS, train_s=train_s,
         measure_s=measure_s, max_memory_allocated=torch.cuda.max_memory_allocated())
    failed = [line for line in lines if not line["pass"]]
    if failed:
        raise AssertionError(f"quant_gate: gates failed: {failed}")
    results["quant_gate"] = lines
    del params
    torch.cuda.empty_cache()


def trace_breakdown(path, group_of):
    """A Chrome trace of ``torch.profiler`` read back: the kernels' names,
    device ms by group, and the card's busy share of the trace's span (the
    union of its kernel, copy and set intervals over the first to the last
    event)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span_us = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy_us, end = 0.0, None
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    groups, names = {}, {}
    for e in device:
        group = group_of(e["name"].lower())
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3
        names[e["name"][:90]] = names.get(e["name"][:90], 0.0) + e["dur"] / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {"span_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / span_us,
            "device_events": len(device), "groups_ms": groups, "top_ms": dict(top),
            "kernel_names": sorted({e["name"] for e in device if e.get("cat") == "kernel"})}


def _kernel_group(low):
    if "flash_fwd" in low:
        return "flash forward (#1)"
    if "flash_bwd" in low:
        return "flash backward (#2, #3)"
    if "decode_hopper" in low or "decode_partial" in low or "decode_combine" in low:
        return "decode attention (#4)"
    if "quant_int8_ring" in low or "quant_int4_ring" in low or "quant_matmul" in low:
        return "dequant-matmul (#5, #6)"
    if "tgmm" in low:
        return "tgmm (#8)"
    if "gmm" in low:
        return "gmm (#7)"
    if any(s in low for s in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies and sets"
    return "other (elementwise, reductions, gathers)"


@contextlib.contextmanager
def profile_env(directory, start, steps):
    """``NEXUS_PROFILE_DIR``/``_START``/``_STEPS`` set for one run."""
    keys = {"NEXUS_PROFILE_DIR": str(directory), "NEXUS_PROFILE_START": str(start), "NEXUS_PROFILE_STEPS": str(steps)}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _check_profile(label, summary_profiler, directory, must_name):
    """The armed run's window: DONE with no failure, one trace under its
    directory whose CUDA kernels name each of ``must_name``; its breakdown."""
    traces = sorted(Path(directory).glob("*.json"))
    if summary_profiler is None or summary_profiler["state"] != "done" or summary_profiler["failures"] != 0:
        raise AssertionError(f"{label}: profiler {summary_profiler}")
    if len(traces) != 1:
        raise AssertionError(f"{label}: {len(traces)} trace files under {directory}")
    info = trace_breakdown(traces[0], _kernel_group)
    missing = [n for n in must_name if not any(n in k for k in info["kernel_names"])]
    info = dict(info, trace_bytes=traces[0].stat().st_size, kernels_named=must_name)
    names = info.pop("kernel_names")
    emit("profile_hook", run=label, profiler=summary_profiler, kernel_count=len(names), **info)
    if missing:
        raise AssertionError(f"{label}: the trace's kernels miss {missing} ({names[:20]})")
    return info


def phase_profile_hook(results):
    """The device profiler hook through the real entry points: (i)
    ``run_serve_engine`` on nexus_moe at full width and depth, int8
    weights, paged (page 32), 8 slots, 24 requests, with
    ``NEXUS_PROFILE_DIR`` set, window [4, 12); (ii) ``run_workload``
    training nexus_moe (batch 8, seq 2048) for 6 steps, window [2, 4).
    Each run ends with the profiler DONE and 0 failures and one Chrome
    trace whose kernels name the hand-written kernels of that path (the
    decode attention and the int8 ring in (i); gmm, tgmm and the flash
    backward in (ii)); the card's busy share and device ms by group from
    each trace."""
    import tempfile

    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.moe import MoeConfig
    from tpu_nexus_torch.models.registry import MoeAdapter
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine
    from tpu_nexus_torch.workload.train import TrainConfig

    model = MoeConfig.nexus_moe()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda",
                          quantize="int8", page_size=32)
        store = InMemoryCheckpointStore()
        ctx = ProcessContext(run_id="profile-serve", algorithm="serve", process_id=0, num_processes=1,
                             coordinator=None)
        _zero_serving_counts()
        quant_matmul.launches_int8 = 0
        t0 = time.perf_counter()
        with profile_env(Path(tmp) / "serve", 4, 8):
            summary = run_serve_engine(cfg, store=store, ctx=ctx)
        wall = time.perf_counter() - t0
        counts = _serving_counts(results, "profile_serve_engine")
        counts["quant_matmul_int8"] = quant_matmul.launches_int8
        row = store.read_checkpoint("serve", "profile-serve")
        stage = row.lifecycle_stage if row else None
        emit("profile_hook", run="serve_engine", config="nexus_moe full width and depth, bf16 params, int8 weights, "
             "page 32, 8 slots, 24 requests", stage=stage, wall_s=wall, launches=counts,
             **{k: summary[k] for k in ("requests", "finished", "engine_steps", "elapsed_s",
                                        "decoded_tokens_per_second", "tpot_p50_s", "ttft_p50_s")})
        if stage != LifecycleStage.COMPLETED or summary["finished"] != 24:
            raise AssertionError(f"profile_hook serve: ledger row is {stage}, {summary['finished']} of 24 finished")
        results["profile_serve_engine"] = _check_profile(
            "serve_engine", summary["profiler"], Path(tmp) / "serve", ["decode_hopper_kernel", "quant_int8_ring_kernel"])

        torch.cuda.empty_cache()
        steps = 6
        wcfg = WorkloadConfig(model=MoeAdapter(config=model),
                              train=TrainConfig(warmup_steps=2, total_steps=steps, optimizer="adamw"),
                              batch_size=8, seq_len=2048, steps=steps, heartbeat_every=2, device="cuda")
        store = InMemoryCheckpointStore()
        ctx = ProcessContext(run_id="profile-train", algorithm="train", process_id=0, num_processes=1,
                             coordinator=None)
        t0 = time.perf_counter()
        with profile_env(Path(tmp) / "train", 2, 2):
            summary = run_workload(wcfg, store=store, ctx=ctx, telemetry=NullMetrics())
        wall = time.perf_counter() - t0
        row = store.read_checkpoint("train", "profile-train")
        stage = row.lifecycle_stage if row else None
        emit("profile_hook", run="train", config="nexus_moe full width and depth, bf16 params, dispatch gmm, "
             "batch 8 x 2048, 6 steps, window [2, 4)", stage=stage, wall_s=wall,
             tokens_per_second=summary["tokens_per_second"])
        if stage != LifecycleStage.COMPLETED:
            raise AssertionError(f"profile_hook train: ledger row is {stage}")
        results["profile_train"] = _check_profile(
            "train", summary.get("profiler"), Path(tmp) / "train",
            ["gmm_bf16_kernel", "tgmm_bf16_kernel", "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel"])


#: the control_plane phase's model and its train runs' shape (the train
#: phase's: nexus_1b, bf16 params, adamw, batch 8 x seq 2048)
CP_TRAIN_BATCH, CP_SEQ = 8, 2048
#: run (b)'s batch: its peak cannot fit the card.  Reckoning, from run (d)'s
#: peak at batch 8 (printed by the subprocess, ``max_memory_allocated``;
#: NVIDIA H100 80GB HBM3 at 700.00 W, this phase's first card run):
#: 12,010,102,784 B, of which the state is 947,972,096 params x 8 B =
#: 7,583,776,768 B; the other 4,426,326,016 B scale with the batch.  At
#: batch 512: 7.58 GB + 64 x 4.43 GB = 290.9 GB, 3.4x the card's 85.0 GB
#: (twice the card needs batch >= 294).  The phase checks the reckoning
#: again against each run's own measured peak.
CP_OOM_BATCH = 512
#: bytes a nexus_1b parameter holds in training with adamw: bf16 params,
#: grads and both moments (adamw keeps them in the params' dtype)
CP_STATE_BYTES_PER_PARAM = 8
CP_NS = "nexus"
CP_ALGORITHM = "nexus-1b"


def _cp_run_subprocess(argv, env, timeout):
    """Run one workload process; stream its stderr lines with their arrival
    time (``time.perf_counter``).  Returns (rc, stdout, stderr, [(t, line)],
    t_spawn, t_exit)."""
    import threading

    lines, out = [], []
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read_err():
        for line in proc.stderr:
            lines.append((time.perf_counter(), line))

    def read_out():
        out.append(proc.stdout.read())

    readers = [threading.Thread(target=read_err, daemon=True), threading.Thread(target=read_out, daemon=True)]
    for r in readers:
        r.start()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:  # the wait timed out or was interrupted
            proc.kill()
            proc.wait()
    t_exit = time.perf_counter()
    for r in readers:
        r.join(timeout=30)
    return rc, "".join(out), "".join(line for _, line in lines), lines, t_spawn, t_exit


def _cp_step_times(lines):
    """{step: arrival time} of the training loop's "step N loss" lines."""
    import re

    steps = {}
    for t, line in lines:
        m = re.search(r"\bstep (\d+) loss ", line)
        if m:
            steps[int(m.group(1))] = t
    return steps


def _cp_summary_number(stderr, key):
    """A number of the entry point's ``workload done: {...}`` line."""
    import re

    m = re.search(rf"workload done: .*?'{key}': ([0-9.eE+-]+)", stderr)
    return float(m.group(1)) if m else None


async def _control_plane(results, tmp, after_oom=None):
    import asyncio
    import math
    import re
    import uuid
    from datetime import timedelta

    import torch

    from tpu_nexus_torch.app.config import SupervisorConfig
    from tpu_nexus_torch.app.dependencies import ApplicationServices
    from tpu_nexus_torch.checkpoint.models import POD_JOB_NAME_LABEL, LifecycleStage
    from tpu_nexus_torch.core.config import load_config
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.launcher.client import Launcher
    from tpu_nexus_torch.launcher.jobset import LaunchSpec, run_labels
    from tpu_nexus_torch.supervisor.taxonomy import (
        MSG_FATAL_ERROR,
        MSG_HBM_OOM,
        DecisionAction,
        classify_tpu_failure,
    )

    ledger = str(tmp / "ledger.db")
    # the supervisor's config: appconfig.yaml on the search path (the
    # repository's, cql-store-type scylla) with NEXUS__* env on top
    env = dict(os.environ, NEXUS__CQL_STORE_TYPE="sqlite", NEXUS__SQLITE_STORE_PATH=ledger,
               NEXUS__RESOURCE_NAMESPACE=CP_NS, NEXUS__WORKERS="2", NEXUS__FAILURE_RATE_BASE_DELAY="5ms",
               NEXUS__FAILURE_RATE_MAX_DELAY="50ms", NEXUS__RATE_LIMIT_ELEMENTS_PER_SECOND="0",
               # the watchdog stays armed, its stale window longer than any run
               NEXUS__HEARTBEAT_STALE_AFTER="600s", NEXUS__WATCHDOG_INTERVAL="1s")
    cfg = load_config(SupervisorConfig, environ=env)
    client = FakeKubeClient({})
    services = (ApplicationServices(fatal_exit=False).with_store_for(cfg).with_fake_kube_client(client)
                .with_supervisor(cfg, resync_period=timedelta(0)))
    store, supervisor = services.store, services.supervisor
    ctx = LifecycleContext()
    task = asyncio.create_task(services.start(ctx, cfg))
    await asyncio.sleep(0.2)
    if cfg.cql_store_type != "sqlite" or supervisor.watchdog is None:
        raise AssertionError(f"control_plane: config {cfg}")
    out = {"runs": {}}

    async def idle():
        if not await supervisor.idle(timeout=10):
            raise AssertionError("control_plane: the supervisor's queues did not drain in 10 s")

    async def launch(label, env_extra):
        """Launch one run: the BUFFERED row first, the Job, then the pod and
        its Started event -> RUNNING; returns (rid, manifest, pod, seconds)."""
        rid = str(uuid.uuid4())
        spec = LaunchSpec(run_id=rid, algorithm=CP_ALGORITHM, image="tpu-nexus-torch-workload:chip",
                          command=["python", "-m", "tpu_nexus_torch.workload"], namespace=CP_NS,
                          resources={"nvidia.com/gpu": "1"}, env=env_extra)
        t0 = time.perf_counter()
        cp = await Launcher(client, store, use_jobset=False).launch(spec)
        if cp.lifecycle_stage != LifecycleStage.BUFFERED or store.read_checkpoint(
                CP_ALGORITHM, rid).lifecycle_stage != LifecycleStage.BUFFERED:
            raise AssertionError(f"{label}: the launch did not write BUFFERED first")
        jobs, _ = await client.list_objects("Job", CP_NS)
        manifest = next(j for j in jobs if j["metadata"]["name"] == rid)
        pod = {"kind": "Pod", "metadata": {"name": f"{rid}-0", "namespace": CP_NS, "uid": str(uuid.uuid4()),
                                            "labels": {POD_JOB_NAME_LABEL: rid, **run_labels(spec)}},
               "status": {}}
        client.inject("ADDED", "Pod", pod)
        client.inject("ADDED", "Event", {
            "kind": "Event", "metadata": {"name": f"evt-started-{rid[:8]}", "namespace": CP_NS},
            "reason": "Started", "message": "Started container algorithm", "type": "Normal",
            "involvedObject": {"kind": "Pod", "name": pod["metadata"]["name"], "namespace": CP_NS}})
        while store.read_checkpoint(CP_ALGORITHM, rid).lifecycle_stage != LifecycleStage.RUNNING:
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"{label}: no RUNNING within 30 s")
            await asyncio.sleep(0.002)
        return rid, manifest, pod, time.perf_counter() - t0

    async def container(manifest, timeout=600):
        """The container a kubelet would start: the manifest's command and
        env (NEXUS_PROCESS_ID from the downward API), the ledger pointed at
        the shared sqlite file, on the card."""
        box = manifest["spec"]["template"]["spec"]["containers"][0]
        penv = dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp), NEXUS_PROCESS_ID="0",
                    NEXUS__CQL_STORE_TYPE="sqlite", NEXUS__SQLITE_STORE_PATH=ledger)
        penv.update({e["name"]: e["value"] for e in box["env"] if "value" in e})
        argv = [sys.executable if a == "python" else a for a in box["command"]]
        return await asyncio.to_thread(_cp_run_subprocess, argv, penv, timeout)

    def run_numbers(label, lines, t_spawn, t_exit, stderr):
        steps = _cp_step_times(lines)
        wall = t_exit - t_spawn
        first = min(steps) if steps else None
        info = {"wall_s": wall}
        if first is not None:
            # spawn to the first step's heartbeat line: imports, the CUDA
            # context, the weights, the kernels' library and the first step
            info.update(to_first_step_end_s=steps[first] - t_spawn,
                        to_first_step_end_share=(steps[first] - t_spawn) / wall)
        loop_s = _cp_summary_number(stderr, "elapsed_s")
        if loop_s is not None:
            # spawn to the loop's first step (train) or to the timed engine
            # loop after the warm-up request (serve-engine)
            info.update(before_first_step_s=wall - loop_s, before_first_step_share=(wall - loop_s) / wall)
        info["step_line_times_s"] = {s: t - t_spawn for s, t in sorted(steps.items())}
        out["runs"][label] = info
        return info, steps

    train_env = {"NEXUS_MODEL_PRESET": "nexus_1b", "NEXUS_BATCH": str(CP_TRAIN_BATCH), "NEXUS_SEQ_LEN": str(CP_SEQ),
                 "NEXUS_OPTIMIZER": "adamw", "NEXUS_HEARTBEAT_EVERY": "1", "NEXUS_DEVICE": "cuda"}

    # (b) a real CUDA out-of-memory in the launched container, first: no
    # container after it fills the card (the work beside them starts then)
    rid, manifest, pod, to_running = await launch("b_oom", dict(train_env, NEXUS_STEPS="2",
                                                                 NEXUS_BATCH=str(CP_OOM_BATCH)))
    rc, _, stderr, lines, t_spawn, t_exit = await container(manifest)
    info, _ = run_numbers("b_oom", lines, t_spawn, t_exit, stderr)
    raw = [line.strip() for line in stderr.splitlines()
           if "OutOfMemoryError: CUDA out of memory" in line and "RESOURCE_EXHAUSTED" not in line]
    if rc == 0 or "RESOURCE_EXHAUSTED: device memory exhausted (CUDA out of memory)" not in stderr \
            or "[hlo_trace: file://" not in stderr or not raw:
        raise AssertionError(f"control_plane b_oom: rc {rc}\n{stderr[-3000:]}")
    # the kubelet's FallbackToLogsOnError: the log's tail (at most 80 lines
    # or 2048 bytes) becomes the terminated container's message
    tail = "\n".join(stderr.strip().splitlines()[-80:])[-2048:]
    client.inject("MODIFIED", "Pod", dict(pod, status={"phase": "Failed", "containerStatuses": [
        {"name": "algorithm", "state": {"terminated": {"reason": "Error", "message": tail, "exitCode": rc}}}]}))
    client.inject("ADDED", "Event", {
        "kind": "Event", "metadata": {"name": f"evt-failed-{rid[:8]}", "namespace": CP_NS},
        "reason": "Failed", "message": "Error", "type": "Warning",
        "involvedObject": {"kind": "Pod", "name": pod["metadata"]["name"], "namespace": CP_NS}})
    await idle()
    row = store.read_checkpoint(CP_ALGORITHM, rid)
    raw_class = classify_tpu_failure(raw[0])
    info.update(launch_to_running_s=to_running, rc=rc, stage=row.lifecycle_stage, cause=row.algorithm_failure_cause,
                hlo_trace_ref=row.hlo_trace_ref, job_deleted=rid in client.deleted("Job"),
                raw_line=raw[0][:200], raw_line_class=raw_class, batch=CP_OOM_BATCH)
    emit("control_plane", run="b_oom", **info)
    if (row.lifecycle_stage != LifecycleStage.FAILED or row.algorithm_failure_cause != MSG_HBM_OOM
            or not row.hlo_trace_ref.startswith("file://") or row.hlo_trace_ref not in tail
            or client.deleted("Job").count(rid) != 1 or raw_class != DecisionAction.TO_FAIL_HBM_OOM):
        raise AssertionError(f"control_plane b_oom: verdict {row}, raw line class {raw_class}")

    # the work beside the control plane (``after_oom``) starts once no
    # container of this phase fills the card any more
    if after_oom is not None:
        after_oom()

    # (d) a clean training run: COMPLETED, nothing flagged, its peak
    rid, manifest, pod, to_running = await launch("d_train", dict(train_env, NEXUS_STEPS="4"))
    rc, _, stderr, lines, t_spawn, t_exit = await container(manifest)
    info, steps = run_numbers("d_train", lines, t_spawn, t_exit, stderr)
    await asyncio.sleep(1.5)  # one watchdog sweep over the finished row
    await idle()
    row = store.read_checkpoint(CP_ALGORITHM, rid)
    m = re.search(r"peak device memory: (\d+) bytes", stderr)
    peak8 = int(m.group(1)) if m else None
    info.update(launch_to_running_s=to_running, rc=rc, stage=row.lifecycle_stage, per_chip_steps=row.per_chip_steps,
                peak_device_memory_bytes=peak8, tokens_per_second=_cp_summary_number(stderr, "tokens_per_second"))
    emit("control_plane", run="d_train", **info)
    if (rc != 0 or row.lifecycle_stage != LifecycleStage.COMPLETED or row.per_chip_steps != {"host0/chip0": 4}
            or rid in client.deleted("Job") or row.algorithm_failure_cause or supervisor.watchdog.flagged
            or peak8 is None):
        raise AssertionError(f"control_plane d_train: rc {rc}, row {row}, flagged {supervisor.watchdog.flagged}, "
                             f"peak {peak8}\n{stderr[-3000:]}")

    # (b)'s batch must have needed at least twice the card's memory by
    # (d)'s measured peak, the state fixed and the rest scaled with the batch
    from tpu_nexus_torch.models.llama import LlamaConfig, param_count

    state = param_count(LlamaConfig.nexus_1b()) * CP_STATE_BYTES_PER_PARAM
    card = torch.cuda.get_device_properties(0).total_memory
    reckoned = state + (peak8 - state) * CP_OOM_BATCH / CP_TRAIN_BATCH
    out["oom_reckoning"] = {"state_bytes": state, "peak8": peak8, "batch": CP_OOM_BATCH,
                            "reckoned_peak_bytes": reckoned, "card_bytes": card, "ratio": reckoned / card}
    emit("control_plane", run="b_oom_reckoning", **out["oom_reckoning"])
    if reckoned < 2 * card:
        raise AssertionError(f"control_plane: batch {CP_OOM_BATCH} reckons {reckoned} B, under twice {card} B")

    # (a) the fault exit: 137 at step 3 of 6, the profiler's window on step 2
    prof_a = tmp / "profile_a"
    rid, manifest, pod, to_running = await launch("a_fault", dict(
        train_env, NEXUS_STEPS="6", NEXUS_FAULT_MODE="oom", NEXUS_FAULT_STEP="3", NEXUS_PROFILE_DIR=str(prof_a),
        NEXUS_PROFILE_START="2", NEXUS_PROFILE_STEPS="1"))
    rc, _, stderr, lines, t_spawn, t_exit = await container(manifest)
    info, steps = run_numbers("a_fault", lines, t_spawn, t_exit, stderr)
    row = store.read_checkpoint(CP_ALGORITHM, rid)
    # step 2's line closes the one unprofiled step after the warm-up step
    tps = CP_TRAIN_BATCH * CP_SEQ / (steps[2] - steps[1]) if {1, 2} <= set(steps) else None
    info.update(launch_to_running_s=to_running, rc=rc, heartbeats=row.per_chip_steps, tokens_per_second_before_fault=tps)
    if rc != 137 or row.per_chip_steps != {"host0/chip0": 3} or row.lifecycle_stage != LifecycleStage.RUNNING:
        raise AssertionError(f"control_plane a_fault: rc {rc}, row {row}\n{stderr[-3000:]}")
    client.inject("ADDED", "Event", {
        "kind": "Event", "metadata": {"name": f"evt-pfp-{rid[:8]}", "namespace": CP_NS},
        "reason": "PodFailurePolicy",
        "message": (f"Container algorithm for pod {CP_NS}/{rid}-0 failed with exit code 137 "
                    "matching FailJob rule at index 0"),
        "type": "Warning", "involvedObject": {"kind": "Job", "name": rid, "namespace": CP_NS}})
    await idle()
    row = store.read_checkpoint(CP_ALGORITHM, rid)
    traces = sorted(prof_a.glob("*.json"))
    info.update(stage=row.lifecycle_stage, cause=row.algorithm_failure_cause, job_deleted=rid in client.deleted("Job"),
                trace_files=len(traces))
    if (row.lifecycle_stage != LifecycleStage.FAILED or row.algorithm_failure_cause != MSG_FATAL_ERROR
            or "exit code 137" not in row.algorithm_failure_details or client.deleted("Job").count(rid) != 1
            or len(traces) != 1):
        raise AssertionError(f"control_plane a_fault: verdict {row}, traces {traces}")
    trace = trace_breakdown(traces[0], _kernel_group)
    names = trace.pop("kernel_names")
    must = ["flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel"]
    missing = [n for n in must if not any(n in k for k in names)]
    info.update(trace_kernels_named=must, trace_missing=missing, trace_busy_share=trace["device_busy_share"])
    emit("control_plane", run="a_fault", **info)
    if missing:
        raise AssertionError(f"control_plane a_fault: the subprocess's trace misses {missing} ({names[:20]})")

    # (c) a completed serving run through the engine
    prof_c = tmp / "profile_c"
    rid, manifest, pod, to_running = await launch("c_serve", {
        "NEXUS_MODE": "serve-engine", "NEXUS_MODEL_PRESET": "nexus_1b", "NEXUS_BATCH": "8", "NEXUS_STEPS": "2",
        "NEXUS_PROMPT_LEN": "128", "NEXUS_GEN_TOKENS": "32", "NEXUS_DEVICE": "cuda",
        "NEXUS_PROFILE_DIR": str(prof_c), "NEXUS_PROFILE_START": "0", "NEXUS_PROFILE_STEPS": "4"})
    rc, _, stderr, lines, t_spawn, t_exit = await container(manifest)
    info, _ = run_numbers("c_serve", lines, t_spawn, t_exit, stderr)
    await idle()
    row = store.read_checkpoint(CP_ALGORITHM, rid)
    traces = sorted(prof_c.glob("*.json"))
    info.update(launch_to_running_s=to_running, rc=rc, stage=row.lifecycle_stage, heartbeats=row.per_chip_steps,
                job_deleted=rid in client.deleted("Job"), trace_files=len(traces),
                requests=_cp_summary_number(stderr, "requests"), finished=_cp_summary_number(stderr, "finished"),
                decoded_tokens_per_second=_cp_summary_number(stderr, "decoded_tokens_per_second"))
    if (rc != 0 or row.lifecycle_stage != LifecycleStage.COMPLETED or not row.per_chip_steps
            or rid in client.deleted("Job") or len(traces) != 1 or info["finished"] != 16):
        raise AssertionError(f"control_plane c_serve: rc {rc}, row {row}, {info}\n{stderr[-3000:]}")
    trace = trace_breakdown(traces[0], _kernel_group)
    names = trace.pop("kernel_names")
    must = ["flash_fwd_bf16_kernel", "decode_hopper_kernel"]
    missing = [n for n in must if not any(n in k for k in names)]
    info.update(trace_kernels_named=must, trace_missing=missing, trace_busy_share=trace["device_busy_share"])
    emit("control_plane", run="c_serve", **info)
    if missing:
        raise AssertionError(f"control_plane c_serve: the subprocess's trace misses {missing} ({names[:20]})")

    ctx.cancel()
    await task
    lat = sorted(supervisor.commit_latencies)
    out["decision_latency_s"] = dict(supervisor.latency_summary(),
                                     p99=lat[max(0, math.ceil(len(lat) * 0.99) - 1)] if lat else 0.0)
    out["flagged"] = supervisor.watchdog.flagged
    out["peak8"] = peak8
    if out["flagged"]:
        raise AssertionError(f"control_plane: the watchdog flagged {out['flagged']} runs")
    return out


def phase_control_plane(results, after_oom=None):
    """The launch-to-verdict chain on the card: ``Launcher.launch`` writes
    the BUFFERED row and the Job onto a ``FakeKubeClient`` plane watched by
    the real informers; a supervisor built through ``ApplicationServices``
    from ``load_config(SupervisorConfig)`` (``NEXUS__CQL_STORE_TYPE=sqlite``,
    a ledger in a temporary directory) moves the row to RUNNING on the pod's
    Started event; then the container runs — ``python -m
    tpu_nexus_torch.workload`` as a subprocess with the manifest's command
    and env, on the card, nexus_1b at full width and depth, in the order
    (b), (d), (a), (c).  (d) 4 clean train steps (batch 8 x 2048):
    COMPLETED, the Job kept, nothing flagged, the peak device memory, by
    which (b)'s batch must have needed at least twice the card's memory.
    (a) ``NEXUS_FAULT_MODE=oom`` at step 3 of 6:
    exit 137, three heartbeats, a PodFailurePolicy event -> FAILED with the
    fatal-error message and the Job deleted; its Chrome trace names kernels
    #1-#3.  (b) a batch that cannot fit (``CP_OOM_BATCH``): a real CUDA OOM,
    the harness's wording and trace ref on stderr, whose tail becomes the
    pod's termination message -> ``TO_FAIL_HBM_OOM``, FAILED with the ref,
    the Job deleted; the raw ``torch`` line alone classifies the same.  (c)
    serve-engine, 16 requests: COMPLETED with heartbeats; its trace names
    #1 and #4.  Then one line of numbers: launch-to-RUNNING seconds, the
    supervisor's decision latency (p50, p95 and max of
    ``latency_summary``, and p99), each subprocess's wall seconds and start-up
    share, tokens/s of (a) before the fault and of (c), the card's name and
    power limit.  ``after_oom()`` is called once (b) is done: no container
    of this phase fills the card after it (``main`` starts quant_gate
    there, so (d), (a) and (c) run beside it)."""
    import asyncio
    import tempfile

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = asyncio.run(_control_plane(results, Path(tmp), after_oom))
    runs = out["runs"]
    emit("control_plane_numbers", nvidia_smi=nvidia_smi(),
         launch_to_running_s={k: v["launch_to_running_s"] for k, v in runs.items()},
         decision_latency_s=out["decision_latency_s"],
         wall_s={k: v["wall_s"] for k, v in runs.items()},
         to_first_step_end_share={k: v.get("to_first_step_end_share") for k, v in runs.items()},
         before_first_step_share={k: v.get("before_first_step_share") for k, v in runs.items()},
         tokens_per_second={"a_before_fault": runs["a_fault"]["tokens_per_second_before_fault"],
                            "c_serve_decoded": runs["c_serve"]["decoded_tokens_per_second"]},
         peak_device_memory_bytes_batch8=out["peak8"], oom_reckoning=out["oom_reckoning"],
         flagged=out["flagged"])
    results["control_plane"] = out


def _decode_probe_times():
    """Kernel #4 (bf16) at the serve step's and kv 4096's shapes: contiguous
    and int8-KV at B8 q_len 1, paged (page 32) per-slot decode and the
    q_len-5 verify; ms on the card per launch."""
    import numpy as np
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention

    dt, times = torch.bfloat16, {}
    for label, max_len, kv_len, n_layers, int8 in (("contiguous_144", 160, 144, 32, False),
                                                   ("contiguous_4096", 4096, 4096, 4, False),
                                                   ("int8_144", 160, 144, 32, True),
                                                   ("int8_4096", 4096, 4096, 4, True)):
        layers = []
        for i in range(n_layers):
            q, k, v = decode_inputs(8, 1, max_len, 32, 8, 128, dt, seed=1000 + i)
            layers.append((q, *int8_cache(k, v)) if int8 else (q, k, v, None, None))
        times[label] = cuda_ms([lambda a=a: decode_attention(a[0], a[1], a[2], kv_len, None, None, a[3], a[4])
                                for a in layers], iters=64)
        del layers
    for label, sq, kv_len in (("paged_144", 1, 144), ("verify_q5_144", 5, 144)):
        n_log = -(-(kv_len + 16) // 32)
        starts = np.full(8, kv_len - 1, np.int32) if sq == 1 else (kv_len - sq - np.arange(8) * 7).astype(np.int32)
        layers = [paged_case(8, sq, 32, n_log, starts + sq, dt, 7000 + i) for i in range(32)]
        if sq == 1:
            kw = dict(prompt_lengths=torch.from_numpy(starts + sq).cuda(), prompt_width=n_log * 32)
        else:
            kw = dict(prompt_lengths=torch.zeros(8, dtype=torch.int32, device="cuda"), prompt_width=0,
                      q_starts=torch.from_numpy(starts).cuda())
        deepest = int((starts + sq).max())
        times[label] = cuda_ms([lambda x=x: decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                                for x in layers], iters=64)
        del layers
    torch.cuda.empty_cache()
    return times


def phase_decode_probe(results):
    """Opt-in: what sets kernel #4's pace.  (1) bf16 contiguous B8 across
    q_len x GQA (query rows 4-64, so wgmma N 8-64) at kv_len 144 and 4096;
    (2) the library built again from copies of ``csrc`` whose
    ``kProducerThreads`` is 32 and 64 (one and two producer warps; the
    kernel ships four) and timed beside the shipped build in every mode."""
    import re
    import shutil

    import torch

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import decode_attention as dec

    sweep = {}
    for sq, hq in ((1, 32), (2, 32), (3, 32), (5, 32), (8, 32), (5, 8), (1, 64), (8, 64)):
        for max_len, kv_len, n_layers in ((160, 144, 32), (4096, 4096, 4)):
            layers = [decode_inputs(8, sq, max_len, hq, 8, 128, torch.bfloat16, seed=1000 + i)
                      for i in range(n_layers)]
            sweep[f"q_len{sq}_hq{hq}_kv{kv_len}"] = cuda_ms([lambda a=a: dec.decode_attention(*a, kv_len)
                                                            for a in layers], iters=64)
            del layers
    emit("decode_probe", sweep_ms=sweep, rows="q_len x Hq/Hkv; wgmma N = rows rounded up to 8, 16, 32 or 64")
    by_producer = {128: _decode_probe_times()}
    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    source = (_build.CSRC / "decode_attention.cu").read_text()
    try:
        for threads in (32, 64):
            probe = ROOT / "build" / f"decode_probe_producer{threads}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            edited, n = re.subn(r"constexpr int kProducerThreads = \d+;",
                                f"constexpr int kProducerThreads = {threads};", source)
            if n != 1:
                raise RuntimeError("decode_probe: kProducerThreads not found once in decode_attention.cu")
            (probe / "csrc" / "decode_attention.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            dec._RESIDENT.clear()
            by_producer[threads] = _decode_probe_times()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        dec._RESIDENT.clear()
    emit("decode_probe", ms_by_producer_threads=by_producer)
    results["decode_probe"] = dict(sweep_ms=sweep, ms_by_producer_threads=by_producer)


#: int4_probe's builds of #6's ring kernel: label -> textual edits of csrc/quant_matmul.cu (each must
#: match once).  "truncating_pack" packs two f32 into bf16 by keeping their high halves (a byte
#: permute) instead of cvt.rn.bf16x2; "no_dequant" also skips the nibble decode and scale; "no_x_reads"
#: zero-fills the activation copies instead of reading x; "stages5_two_ctas" has a 5-stage ring at two
#: CTAs an SM (shipped: 8 stages, one CTA), "stages12" a 12-stage ring; "l2_promotion_128b" fills L2 in 128-byte lines; "consumers_skip" releases each stage as
#: soon as it lands; "ring_only" also drops the end of every run (sums, partials, merge); "no_merge"
#: writes every tile as if whole (no partials, no merge); "merge_reads_nothing" keeps the partials and
#: arrivals but the last CTA adds no partial.  Only times: most edits change results.
_TRUNC_PACK = [("__device__ __forceinline__ float int4_value(",
                "__device__ __forceinline__ uint32_t pack_trunc(float lo, float hi) {\n"
                "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n}\n"
                "__device__ __forceinline__ float int4_value("),
               ("pack_bf16(int4_value(", "pack_trunc(int4_value(")]
_SKIP_STAGE = [("        mbar_wait(&full[st], phase);\n",
                "        mbar_wait(&full[st], phase);\n        if (kb >= 0) {  // the stage arrived: release it\n"
                "          __syncwarp();\n          if (lane == 0) mbar_arrive(&empty[st]);\n"
                "          if (++st == kRingStages) st = 0, phase ^= 1;\n          continue;\n        }\n")]
INT4_PROBE_EDITS = {
    "truncating_pack": _TRUNC_PACK,
    "no_dequant": _TRUNC_PACK + [
        ("return (__uint_as_float(__byte_perm(nibbles, kTwoPow23Bits, 0x7650 + j)) - 8388616.f) * s;",
         "return __uint_as_float(nibbles ^ j);")],
    "no_x_reads": [("ok ? 16 : 0);", "0);")],
    "stages5_two_ctas": [("constexpr int kRingStages = 8;", "constexpr int kRingStages = 5;"),
                         ("constexpr int kRingCtasPerSm = 1;", "constexpr int kRingCtasPerSm = 2;")],
    "stages12": [("constexpr int kRingStages = 8;", "constexpr int kRingStages = 12;")],
    "l2_promotion_128b": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    "consumers_skip": _SKIP_STAGE,
    "ring_only": _SKIP_STAGE + [("      // The tile's sums: the eight warps added in a fixed order",
                                 "      if (u > 0) continue;  // no end of the run\n"
                                 "      // The tile's sums: the eight warps added in a fixed order")],
    "no_merge": [("      if (seg_begin == tile_begin && seg_end == tile_begin + n_kb) {",
                  "      if (true) {  // every tile written as if whole: no partials, no merge")],
    "merge_reads_nothing": [("        for (int c0 = first; c0 <= last; c0 += 16) {",
                             "        for (int c0 = first; c0 < first; c0 += 16) {")],
}


#: quant_matmul.cu's int8 ring kernel section (its constants, layout and kernel): int4_probe's edits
#: are made outside it, int8_probe's inside it
_INT8_SECTION = ("// ---- int8, bf16 activations: the ring kernel", "// A row-major matrix [rows, cols]")


def _edit_source(source, edits, label, inside_int8):
    """``source`` with ``edits`` made either only inside :data:`_INT8_SECTION` or only outside it;
    each ``old`` must be found there once (int4's four ``pack_bf16(int4`` calls: four times)."""
    i = source.index(_INT8_SECTION[0])
    j = source.index(_INT8_SECTION[1], i)
    head, section, tail = source[:i], source[i:j], source[j:]
    text = section if inside_int8 else head + "\x00" + tail
    for old, new in edits:
        if text.count(old) != (4 if old.startswith("pack_bf16(int4") else 1):
            raise RuntimeError(f"{label}: {old!r} not found as expected in quant_matmul.cu")
        text = text.replace(old, new)
    return head + text + tail if inside_int8 else text.replace("\x00", section)


def _streamk_plan(rows, n, m, resident, stage_rows, cols=128):
    """A plan for the probes: every shape cut into runs over all the CTAs the card holds (at least
    two units each), runs free to straddle tiles, as the shipped plan does only for many tiles."""
    from tpu_nexus_torch.ops import quant_matmul as qmm

    units = -(-n // cols) * -(-m // qmm.ROWS_M) * -(-rows // stage_rows)
    return units, max(1, min(resident, units // qmm.MIN_RING_UNITS))


def _int4_probe_times(hot=False):
    """#6's bf16 launches of :data:`QUANT_TIMED` (int4 rows), kernel time only (ms): weight copies
    over 128 MB (from HBM), or with ``hot`` one copy, left in L2 by the call before."""
    import torch

    from tpu_nexus_torch.ops.quant_matmul import quant_matmul

    out = {}
    for key, m, k, n, mode, group in QUANT_TIMED:
        if mode != "int4":
            continue
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda")
        x = x.to(torch.bfloat16)
        first = quant_weight(k, n, mode, group, 4001)
        copies = 1 if hot else max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, mode, group, 4001 + i) for i in range(1, copies)]
        out[key] = cuda_ms([lambda w=w: quant_matmul(x, w) for w in weights], iters=64)
        del weights, first
    torch.cuda.empty_cache()
    return out


def phase_int4_probe(results):
    """Opt-in: what sets the pace of #6's ring kernel.  The shipped build
    with the plan of :func:`_streamk_plan`; then the library built
    again from copies of ``csrc`` edited as :data:`INT4_PROBE_EDITS` says;
    each timed beside the shipped build at the four int4 rows of
    ``quant_times``, the weights from HBM and (``*_hot``) left in L2 by the
    call before (``--phases build,int4_probe``)."""
    import shutil

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import quant_matmul as qmm

    by_build = {"shipped": _int4_probe_times(), "shipped_hot": _int4_probe_times(hot=True)}
    plan = qmm.ring_plan
    try:  # the shipped build with runs free to straddle tiles at every shape
        qmm.ring_plan = _streamk_plan
        by_build["streamk_runs"] = _int4_probe_times()
    finally:
        qmm.ring_plan = plan
    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    source = (_build.CSRC / "quant_matmul.cu").read_text()
    try:
        for label, edits in INT4_PROBE_EDITS.items():
            edited = _edit_source(source, edits, f"int4_probe {label}", inside_int8=False)
            probe = ROOT / "build" / f"int4_probe_{label}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            (probe / "csrc" / "quant_matmul.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            qmm._RING_RESIDENT.clear()
            by_build[label] = _int4_probe_times()
            by_build[label + "_hot"] = _int4_probe_times(hot=True)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        qmm._RING_RESIDENT.clear()
    by_build["shipped_again"] = _int4_probe_times()
    emit("int4_probe", ms_by_build=by_build)
    results["int4_probe"] = by_build


#: the int8 ring kernel with consumers that release each stage as soon as it lands and skip the end
#: of every run (sums, partials, merge): the producer's stream alone.  Only times: y is not written.
_I8_SKIP_STAGE = [("          mbar_wait(&full[st], phase);\n",
                   "          mbar_wait(&full[st], phase);\n          if (u >= 0) {  // the stage arrived: release it\n"
                   "            __syncwarp();\n            if (lane == 0) mbar_arrive(&empty[st]);\n"
                   "            if (++st == kI8Stages) st = 0, phase ^= 1;\n            continue;\n          }\n")]
_I8_NO_TILE_END = [("      // The tile's sums: the warps of each box added in warp order",
                    "      if (u > 0) continue;  // no end of the run\n"
                    "      // The tile's sums: the warps of each box added in warp order")]
_I8_64x128 = dict(kI8Rows=64, kI8Boxes=1, kI8Stages=16, kI8CtasPerSm=1)
_I8_128x128 = dict(kI8Rows=128, kI8Boxes=1, kI8Stages=8, kI8CtasPerSm=1)
_I8_64x256 = dict(kI8Rows=64, kI8Boxes=2, kI8Stages=8, kI8CtasPerSm=1)
_I8_TWO_CTAS = dict(kI8Rows=64, kI8Boxes=1, kI8Stages=8, kI8CtasPerSm=2)
_I8_WALK_ROWS = [("  const int cta = blockIdx.x;\n",
                  "  const int n_tiles = units / n_kb, n_runs = gridDim.x / n_tiles;\n"
                  "  const int cta = gridDim.x % n_tiles ? blockIdx.x\n"
                  "                                      : (blockIdx.x % n_tiles) * n_runs + blockIdx.x / n_tiles;\n")]
#: int8_probe's builds of #5's ring kernel: label -> (the section's constants, textual edits inside it,
#: each matching once).  The stage geometries: 128 rows x 128 columns (16 KB a stage, shipped), 64 x
#: 128 (8 KB, as #6's), 64 x 256 (two 128-byte swizzled boxes side by side), 64 x 128 at two CTAs an
#: SM; "walk_rows": the blocks renumbered so that CTAs with neighbouring indices read the same rows of
#: neighbouring strips.  "ring_only": the consumers release each stage as it lands and skip the end of every run
#: (the producer's stream alone); "consumers_skip": only the release; "no_tile_end": the consumers'
#: products, no end of a run (sums, partials, merge, y); "no_widen": one shift in place of the
#: byte permute and FADD of each weight value; "lop_widen": each value by a mask-and-or (LOP3) and an
#: FFMA, each pair packed by a shift-add, no byte permute; "no_mma": an XOR and an FADD in place of
#: each mma;
#: "no_merge": every tile written as if whole; "consumers_only": no weight streamed (each stage
#: complete at once, the consumers at their own pace); "_sN": an N-stage ring.  Only
#: times: most edits change results.
INT8_PROBE_BUILDS = {
    # the shipped geometry (128 x 128, 8 stages) with parts taken away
    "128x128_s8_ring_only": (_I8_128x128, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "128x128_s8_consumers_skip": (_I8_128x128, _I8_SKIP_STAGE),
    "128x128_s8_consumers_only": (_I8_128x128, [
        ("        mbar_arrive_expect_tx(&full[st], Int8RingSmem::kStageBytes);",
         "        mbar_arrive(&full[st]);  // no weight: the consumers at their own pace"),
        ("          tma_load_3d(tile + b * kI8Rows * kCols, &tm_q,",
         "          if (kb < 0) tma_load_3d(tile + b * kI8Rows * kCols, &tm_q,")]),
    "128x128_s8_no_tile_end": (_I8_128x128, _I8_NO_TILE_END),
    "128x128_s8_no_merge": (_I8_128x128, [
        ("      if (seg_begin == tile_begin && seg_end == tile_begin + n_kb) {",
         "      if (true) {  // every tile written as if whole: no partials, no merge")]),
    "128x128_s8_no_widen": (_I8_128x128, [
        ("return __uint_as_float(__byte_perm(u, kTwoPow23Bits, 0x7650 + j)) - 8388736.f;",
         "return __uint_as_float(u << (8 * j));")]),
    "128x128_s8_lop_widen": (_I8_128x128, [
        ("  return __uint_as_float(__byte_perm(u, kTwoPow23Bits, 0x7650 + j)) - 8388736.f;",
         "  if (j == 0) return __uint_as_float((u & 0xFFu) | 0x4B000000u) - 8388736.f;\n"
         "  if (j == 1) return fmaf(__uint_as_float((u & 0xFF00u) | 0x4F000000u), 0x1p-8f, -8388736.f);\n"
         "  if (j == 2) return fmaf(__uint_as_float((u & 0xFF0000u) | 0x53000000u), 0x1p-16f, -8388736.f);\n"
         "  return __uint_as_float((u >> 24) + 0x4B000000u) - 8388736.f;"),
        ("  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);",
         "  return (__float_as_uint(lo) >> 16) + __float_as_uint(hi);")]),
    "128x128_s8_no_mma": (_I8_128x128, [
        ("for (int cp = 0; cp < 8; ++cp) mma_bf16_16816(acc[cp], a[cp], b0, b1);",
         "for (int cp = 0; cp < 8; ++cp)\n"
         "              acc[cp][0] += __uint_as_float(a[cp][0] ^ a[cp][1] ^ a[cp][2] ^ a[cp][3] ^ b0 ^ b1);")]),
    # other stage geometries, ring depths and walks
    "128x128_s10_ring_only": (dict(_I8_128x128, kI8Stages=10), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s16": (_I8_64x128, []),
    "64x128_s16_ring_only": (_I8_64x128, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s12_ring_only": (dict(_I8_64x128, kI8Stages=12), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s20_ring_only": (dict(_I8_64x128, kI8Stages=20), _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x256_s8": (_I8_64x256, []),
    "64x256_s8_ring_only": (_I8_64x256, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s8_two_ctas": (_I8_TWO_CTAS, []),
    "64x128_s8_two_ctas_ring_only": (_I8_TWO_CTAS, _I8_SKIP_STAGE + _I8_NO_TILE_END),
    "64x128_s16_walk_rows_ring_only": (_I8_64x128, _I8_WALK_ROWS + _I8_SKIP_STAGE + _I8_NO_TILE_END),
}


def _sass_mix(library, kernel):
    """Opcode counts in the SASS of ``kernel`` in ``library`` (the toolkit's cuobjdump): the mix of
    instructions a probe build compiled to."""
    import re

    from tpu_nexus_torch.ops import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    body = next((f for f in dump.split("Function : ")[1:] if re.match(rf"\S*{kernel}", f)), "")
    mix = {}
    for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
        mix[op] = mix.get(op, 0) + 1
    return dict(sorted(mix.items(), key=lambda kv: -kv[1]))


def phase_int8_probe(results):
    """Opt-in: the int8 weight's stream, measured before and beside #5's ring kernel's consumers.
    At the four int8 rows of ``quant_times`` (weights from HBM), kernel time (ms) of: the parent
    design (the partial pass and its finalize, forced), ``torch.matmul`` on the bf16 weight, the
    shipped build with the plan it ships, with every shared tile merged through the workspace
    (``*_global_merge``), with runs over every resident CTA free to straddle tiles
    (``*_streamk``) and with clusters of up to 16 CTAs (``*_clusters16``), and the library built again from copies of ``csrc`` edited as each
    entry of :data:`INT8_PROBE_BUILDS` says (stage geometries, the stream alone, parts of the
    consumers taken away).  ``TBps`` divides each launch's bytes (the
    int8 weight, its scales, x and y) by its time (``--phases build,int8_probe``)."""
    import re
    import shutil

    import torch

    from tpu_nexus_torch.ops import _build
    from tpu_nexus_torch.ops import quant_matmul as qmm

    dt = torch.bfloat16
    rows = [(key, m, k, n) for key, m, k, n, mode, _ in QUANT_TIMED if mode == "int8"]
    inputs, nbytes = {}, {}
    for key, m, k, n in rows:
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda").to(dt)
        first = quant_weight(k, n, "int8", 0, 4001)
        copies = max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
        weights = [first] + [quant_weight(k, n, "int8", 0, 4001 + i) for i in range(1, copies)]
        inputs[key] = (x, weights)
        nbytes[key] = first.q.numel() + first.s.numel() * 4 + (m * k + m * n) * 2

    def times():
        return {key: cuda_ms([lambda w=w, x=x: qmm.quant_matmul(x, w) for w in weights], iters=64)
                for key, (x, weights) in inputs.items()}

    by_build = {}
    route = qmm.int8_ring_route
    try:  # the parent's design, as the wrapper launches it for the shapes the ring kernel does not take
        qmm.int8_ring_route = lambda *a: False
        by_build["parent_first_design"] = times()
    finally:
        qmm.int8_ring_route = route
    library = {}
    for key, (x, weights) in inputs.items():
        dense = [w.to(dt) for w in weights[: max(4, -(-len(weights) // 4))]]
        library[key] = cuda_ms([lambda w=w, x=x: torch.matmul(x, w) for w in dense], iters=64)
        del dense
    by_build["library_torch_matmul_bf16"] = library
    by_build["shipped"] = times()
    sass = {"shipped": _sass_mix(_build.library_path(), "quant_int8_ring_kernel")}
    plan, max_cluster = qmm.ring_plan, qmm.INT8_MAX_CLUSTER
    try:
        qmm.INT8_MAX_CLUSTER = 1  # every shared tile merged through the workspace, as #6 does
        by_build["shipped_global_merge"] = times()
        qmm.ring_plan = _streamk_plan
        by_build["shipped_streamk"] = times()
        qmm.ring_plan, qmm.INT8_MAX_CLUSTER = plan, 16  # non-portable clusters of up to 16 CTAs
        by_build["shipped_clusters16"] = times()
    finally:
        qmm.ring_plan, qmm.INT8_MAX_CLUSTER = plan, max_cluster
    capacity = {c: qmm._int8_cluster_capacity(torch.device("cuda", torch.cuda.current_device()), c)
                for c in (1, 2, 4, 8, 16)}

    shipped = (_build.CSRC, _build.BUILD_DIR, _build._library)
    geometry = (qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS)
    source = (_build.CSRC / "quant_matmul.cu").read_text()
    errors = {}
    try:
        for label, (consts, extra) in INT8_PROBE_BUILDS.items():
            edits = []
            for name, value in consts.items():
                found = re.search(rf"constexpr int {name} = \d+;", source)
                if found is None:
                    raise RuntimeError(f"int8_probe {label}: no {name} in quant_matmul.cu")
                edits.append((found.group(0), f"constexpr int {name} = {value};"))
            edited = _edit_source(source, edits + extra, f"int8_probe {label}", inside_int8=True)
            probe = ROOT / "build" / f"int8_probe_{label}"
            shutil.rmtree(probe, ignore_errors=True)
            shutil.copytree(shipped[0], probe / "csrc")
            (probe / "csrc" / "quant_matmul.cu").write_text(edited)
            _build.CSRC, _build.BUILD_DIR, _build._library = probe / "csrc", probe / "build", None
            qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS = consts["kI8Rows"], 128 * consts["kI8Boxes"]
            qmm._RING_RESIDENT.clear()
            try:
                by_build[label] = times()
                sass[label] = _sass_mix(_build.library_path(), "quant_int8_ring_kernel")
            except RuntimeError as err:  # a geometry that does not build or launch is a reading too
                errors[label] = str(err)[-2000:]
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._library = shipped
        qmm.INT8_RING_ROWS, qmm.INT8_RING_COLS = geometry
        qmm._RING_RESIDENT.clear()
    by_build["shipped_again"] = times()
    rates = {label: {key: nbytes[key] / ms / 1e9 for key, ms in row.items()} for label, row in by_build.items()}
    emit("int8_probe", bytes=nbytes, ms_by_build=by_build, TBps_by_build=rates, errors=errors,
         shipped_cluster_capacity=capacity, sass_opcodes_by_build=sass)
    results["int8_probe"] = dict(ms_by_build=by_build, TBps_by_build=rates, errors=errors)


def phase_train_moe_profile(results):
    """Opt-in (``--phases build,train_moe_profile``): two warm training
    steps of train_moe's shape under ``torch.profiler``: device ms by group
    and the busy share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_nexus_torch.models.moe import MoeConfig
    from tpu_nexus_torch.models.registry import host_to_device
    from tpu_nexus_torch.workload.data import synthetic_tokens
    from tpu_nexus_torch.workload.health import HealthConfig
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

    cfg = MoeConfig.nexus_moe()
    tcfg = TrainConfig(warmup_steps=10, total_steps=20)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tcfg, device="cuda")
    step_fn = make_train_step(cfg, tcfg, health=HealthConfig())
    data = synthetic_tokens(8, 2048, cfg.vocab_size, seed=0)
    batches = [host_to_device(next(data), "cuda", torch.long) for _ in range(6)]
    for batch in batches[:2]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:4]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[4:]:
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2

    def group_of(low):
        if "tgmm" in low:
            return "tgmm kernel (#8)"
        if "gmm_" in low:
            return "gmm kernel (#7)"
        if "flash_bwd_dq" in low:
            return "flash backward dQ kernel"
        if "flash_bwd_dkv" in low:
            return "flash backward dK/dV kernel"
        if "flash_fwd" in low:
            return "flash forward kernel"
        if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass", "cublas", "sm90")):
            return "matmul (cuBLAS)"
        if any(k in low for k in ("index", "gather", "scatter", "sort", "radix", "searchsorted", "cumsum", "scan")):
            return "dispatch/combine gathers, sort and index maps"
        return "other (elementwise, reductions, copies)"

    groups, top = _group_device_time(prof, group_of)
    groups = {k: v / 2 for k, v in groups.items()}
    device_ms = sum(groups.values())
    emit("train_moe_profile", config="nexus_moe full depth, bf16, dispatch gmm, adamw, attn_out; batch 8, seq 2048; "
         "ms per step, mean of 2 profiled steps", wall_ms=wall_ms, unprofiled_wall_ms=plain_wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         busy_share_of_unprofiled_step=device_ms / plain_wall_ms, groups_ms=groups,
         top=[{"ms_per_step": t / 2, "calls": c // 2, "name": n} for t, c, n in top[:24]])
    del state, batches


# -- the serve-engine slice: kernel #4's paged and q_starts modes, kernel #9 ----


def paged_case(b, sq, page, n_log, live, dtype, seed, int8=False):
    """q [B, sq, 32, 128] and a pooled cache [NB, page, 8, 128] with
    shuffled block tables: block 0 is the scratch block, each row's live
    logical blocks get distinct shuffled physical blocks, and the entries
    past a row's live length point at the scratch block.  With ``int8``
    the pool is quantized the way decode writes it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nb = 1 + b * n_log
    phys = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    live_blocks = -(-np.asarray(live) // page)
    tables = np.where(np.arange(n_log)[None, :] < live_blocks[:, None], phys, 0).astype(np.int32)
    q, k, v = decode_inputs(nb, sq, page, 32, 8, 128, dtype, seed=seed)
    q = q[:b].contiguous()
    scales = {}
    if int8:
        k, v, ks, vs = int8_cache(k, v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, torch.from_numpy(tables).cuda(), scales


def _gather_rows(pool, tables):
    b, n_log = tables.shape
    return pool[tables.long()].reshape(b, n_log * pool.shape[1], *pool.shape[2:])


def phase_engine_parity(results):
    """Kernel #4's paged and ``q_starts`` modes against
    ``decode_attention_plain`` at Llama-3-8B heads (Hq 32, Hkv 8, D 128):
    pages 4, 16, 32 and 64, shuffled tables with a scratch block, staggered
    per-row lengths, q_len 1-5, every combination of paged x ragged x
    int8-KV in bf16 and f32, and the shapes of the serve_engine runs (the
    8-token extend tail, per-slot decode and verify at page 32, max_len
    160), each run twice bit-identical; f32 at 4096 slots and q_len 5
    against the plain version in f64; then kernel #9 (RMSNorm) against its
    plain version at [1024, 4096] and [16384, 2048]."""
    import numpy as np
    import torch

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain, mode_name
    from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel

    # (B, page, q_len, n_log, per-row starts, logical_limit, (paged, ragged, int8) combinations)
    every = [(p, r, q) for p in (False, True) for r in (False, True) for q in (False, True) if p or r]
    cases = []

    def page_cases(page):
        for sq in (1, 3, 5):
            n_log = -(-(4096 if page == 32 and sq == 1 else 160) // page)
            rng = np.random.default_rng(page * 10 + sq)
            starts = rng.integers(0, n_log * page - sq, size=8).astype(np.int32)
            starts[0], starts[1] = 0, n_log * page - sq  # the shortest and the deepest row
            cases.append((8, page, sq, n_log, starts, None, every))

    for page in (4, 16, 32):
        page_cases(page)
    # the shapes the serve_engine runs give the kernel: page 32, max_len 160
    # (n_log 5) and logical_limit 160 — an admission's 8-token extend tail at
    # one start (q_len 8, kv_len 128; B 1 as the engine runs it, and B 8),
    # the per-slot decode of 8 slots and spec_k 4's verify (q_len 5)
    for bb in (1, 8):
        cases.append((bb, 32, 8, 5, np.full(bb, 120, np.int32), 160, [(True, False, False), (True, False, True)]))
    for sq, ragged in ((1, False), (5, True)):
        starts = np.random.default_rng(900 + sq).integers(0, 160 - sq, size=8).astype(np.int32)
        starts[0], starts[1] = 0, 160 - sq
        cases.append((8, 32, sq, 5, starts, 160, [(True, ragged, False), (True, ragged, True)]))
    page_cases(64)  # last, so the cases above keep their inputs (seeds follow the case order)

    worst = {"decode_attention_paged": 0.0, "decode_attention_ragged": 0.0}
    i = 0
    for b, page, sq, n_log, starts, limit, combos in cases:
        logical = n_log * page
        for paged, ragged, int8 in combos:
            for dtype in (torch.bfloat16, torch.float32):
                i += 1
                q, k, v, tables, scales = paged_case(b, sq, page, n_log, starts + sq, dtype, 6000 + i, int8)
                if not paged:
                    k, v = _gather_rows(k, tables), _gather_rows(v, tables)
                    scales = {n: _gather_rows(s, tables) for n, s in scales.items()}
                kv_len = int(starts.max()) + sq
                if ragged:
                    kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device="cuda"), prompt_width=0,
                              q_starts=torch.from_numpy(starts).cuda())
                elif sq == 1:  # per-slot decode
                    kw = dict(prompt_lengths=torch.from_numpy(starts + 1).cuda(), prompt_width=logical)
                else:  # a shared-start extend
                    kw = {}
                if paged:
                    kw.update(block_tables=tables, logical_limit=limit)
                mode = mode_name(paged, ragged, int8)
                before = decode_attention.launches_by_mode[mode]
                out = decode_attention(q, k, v, kv_len, **scales, **kw)
                again = decode_attention(q, k, v, kv_len, **scales, **kw)
                torch.cuda.synchronize()
                ref = decode_attention_plain(q, k, v, kv_len, **scales, **kw)
                same = bool(torch.equal(out, again)) and decode_attention.launches_by_mode[mode] == before + 2
                err, ref_max, e_row = max_err(out, ref), float(ref.float().abs().max()), row_rel_err(out, ref)
                if dtype == torch.bfloat16:
                    ok = err <= TOL["bfloat16"][0] and e_row <= ROW_REL_TOL
                elif int8:
                    ok = err <= QUANT_F32_MAXABS_REL * ref_max
                else:
                    ok = err <= TOL["float32"][0]
                ok = ok and same and bool(torch.isfinite(out).all())
                emit("engine_parity", kernel="decode_attention", mode=mode, page=page, q_len=sq, b=b,
                     logical_len=logical, logical_limit=limit, kv_len=kv_len, dtype=str(dtype), max_abs_err=err,
                     ref_max_abs=ref_max, max_row_rel_err=e_row, bit_identical_twice=same, ok=ok)
                if not ok:
                    raise AssertionError(f"decode kernel mode {mode} disagrees with its plain version: "
                                         f"B {b} page {page} q_len {sq} kv_len {kv_len} {dtype}")
                if dtype == torch.bfloat16 and page == 32 and mode in ("paged", "paged+ragged"):
                    key = "decode_attention_" + ("ragged" if ragged else "paged")
                    worst[key] = max(worst[key], err)
                del q, k, v, tables, scales, out, again, ref
    # f32 at 4096 slots, q_len 5 (B4, pages 4 and 32): the kernel against the plain version
    # evaluated in f64, with the plain version's own f32 error beside it (at this depth it passes
    # the f32 limit, which the kernel stays inside)
    for page in (4, 32):
        starts = np.array([0, 7, 4096 - 7, 19], dtype=np.int32)
        q, k, v, tables, _ = paged_case(4, 5, page, 4096 // page, starts + 5, torch.float32, 6500 + page)
        kv_len = int(starts.max()) + 5
        out = decode_attention(q, k, v, kv_len, block_tables=tables)
        ref64 = decode_attention_plain(q.double(), k.double(), v.double(), kv_len, block_tables=tables)
        ref32 = decode_attention_plain(q, k, v, kv_len, block_tables=tables)
        err = float((out.double() - ref64).abs().max())
        plain_err = float((ref32.double() - ref64).abs().max())
        ok = err <= TOL["float32"][0] and bool(torch.isfinite(out).all())
        emit("engine_parity", kernel="decode_attention", mode="paged", page=page, q_len=5, b=4, kv_len=kv_len,
             dtype="torch.float32", reference="decode_attention_plain in f64", max_abs_err=err,
             plain_f32_max_abs_err=plain_err, tol=TOL["float32"][0], ok=ok)
        if not ok:
            raise AssertionError(f"f32 decode kernel at page {page}, 4096 slots, q_len 5: {err} from the f64 reference")
        del q, k, v, tables, out, ref64, ref32
    torch.cuda.empty_cache()

    worst["rms_norm"] = 0.0
    # the timed rows, H 8192 (eight warps a row), H 100 and 2056 (element accesses, a ragged warp), one
    # row, fewer rows than SMs, and a bf16 weight
    for rows, hidden, w_dtype in ((1024, 4096, torch.float32), (16384, 2048, torch.float32),
                                  (64, 8192, torch.float32), (37, 100, torch.float32), (1, 4096, torch.float32),
                                  (100, 2048, torch.float32), (7, 2056, torch.bfloat16),
                                  (1024, 4096, torch.bfloat16)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(rows + hidden)
            x = (torch.randn((rows, hidden), generator=g, device="cuda") * 3).to(dtype)
            w = (torch.randn((hidden,), generator=g, device="cuda") + 1).to(w_dtype)
            before = rms_norm_kernel.launches
            out, again = rms_norm_kernel(x, w), rms_norm_kernel(x, w)
            torch.cuda.synchronize()
            ref = rms_norm(x, w)
            same = bool(torch.equal(out, again)) and rms_norm_kernel.launches == before + 2
            err, ref_max = max_err(out, ref), float(ref.float().abs().max())
            if dtype == torch.bfloat16:  # one rounding of the same f32 value apart: one bf16 ulp
                ok = bool(((out.float() - ref.float()).abs() <= 2**-7 * ref.float().abs()).all())
            else:
                ok = err <= 1e-5 * ref_max
            ok = ok and same and out.dtype == dtype
            emit("engine_parity", kernel="rms_norm", shape=[rows, hidden], dtype=str(dtype),
                 weight_dtype=str(w_dtype), max_abs_err=err,
                 ref_max_abs=ref_max, bit_identical_twice=same, tol="f32: 1e-5 x max|ref|; bf16: one ulp", ok=ok)
            if not ok:
                raise AssertionError(f"rms_norm kernel disagrees with its plain version: {rows}x{hidden} {dtype}")
            if dtype == torch.bfloat16 and rows == 16384 and w_dtype == torch.float32:
                worst["rms_norm"] = err
    results.setdefault("max_abs_err", {}).update(worst)


def engine_times(times):
    """Kernel #4's paged decode (B8, per-slot cursors at kv_len 144 and
    4096, page 32) and its ragged verify (B8, q_len 5, page 32, staggered
    starts, at kv_len 144 and 4096), cycling per-layer pools so K/V come
    from HBM; then kernel #9 (:func:`rms_times`).  ``bound_ms``: the live
    K/V bytes read once at 3.35 TB/s.  ``library_ms``:
    ``scaled_dot_product_attention`` on the pre-gathered contiguous cache
    with the boolean mask, which the port never calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain

    dt, b, page, hq, hkv, d = torch.bfloat16, 8, 32, 32, 8, 128
    for key, sq, kv_len, n_layers in (("decode_attention_paged", 1, 144, 32), (None, 1, 4096, 4),
                                      ("decode_attention_ragged", 5, 144, 32), (None, 5, 4096, 4)):
        n_log = -(-(kv_len + 16) // page)
        if sq == 1:  # every slot at cursor kv_len - 1
            starts = np.full(b, kv_len - 1, np.int32)
        else:  # verify windows at staggered cursors ending at or before kv_len
            starts = (kv_len - sq - np.arange(b) * 7).astype(np.int32)
        live = starts + sq
        layers = [paged_case(b, sq, page, n_log, live, dt, 7000 + i) for i in range(n_layers)]
        if sq == 1:
            kw = dict(prompt_lengths=torch.from_numpy(live).cuda(), prompt_width=n_log * page)
        else:
            kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device="cuda"), prompt_width=0,
                      q_starts=torch.from_numpy(starts).cuda())
        deepest = int(live.max())
        kern = [lambda x=x: decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw) for x in layers]
        plain = [lambda x=x: decode_attention_plain(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                 for x in layers]
        # the yardstick: SDPA over each row's gathered contiguous view, masked to its live slots
        k_pos = torch.arange(deepest, device="cuda")
        row_last = torch.from_numpy(starts).cuda()[:, None] + torch.arange(sq, device="cuda")[None, :]
        mask = (k_pos[None, None, :] <= row_last[:, :, None])[:, None]  # [B, 1, sq, deepest]
        lib_sets = [(x[0].transpose(1, 2), _gather_rows(x[1], x[3])[:, :deepest].transpose(1, 2),
                     _gather_rows(x[2], x[3])[:, :deepest].transpose(1, 2)) for x in layers]
        lib = [lambda x=x: F.scaled_dot_product_attention(*x, attn_mask=mask, enable_gqa=True) for x in lib_sets]
        nbytes = (int(live.sum()) * hkv * d * 2 + 2 * b * sq * hq * d) * 2 + b * n_log * 4
        flops = 4 * hq * d * sq * int(live.sum())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, enqueue_ms = timed(kern, iters=64)
        row = dict(shape=[b, sq, page, n_log, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms(plain, iters=16), library_ms=cuda_ms(lib, iters=64),
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
                   library_ms_is="scaled_dot_product_attention, pre-gathered contiguous cache with the mask")
        if key:
            times[key] = row
        emit("times", kernel="decode_attention_" + ("ragged" if sq > 1 else "paged"), **row)
        del layers, lib_sets, kern, plain, lib
        torch.cuda.empty_cache()

    rms_times(times)


def rms_times(times):
    """Kernel #9 at [16384, 2048] (the kernels line's row) and [1024, 4096]
    (Llama-3-8B's prefill rows at batch 8, prompt 128), bf16 x and an f32
    weight, cycling input copies over 128 MB so x comes from HBM.
    ``bound_ms``: x read and y written once, the weight read once, at 3.35
    TB/s.  ``library_ms``: ``torch.nn.functional.rms_norm`` with the weight
    in bf16 (it takes one dtype), which the port never calls."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel

    dt = torch.bfloat16
    library = getattr(F, "rms_norm", None)  # PyTorch >= 2.4
    for key, rows, hidden in (("rms_norm", 16384, 2048), ("rms_norm_1024x4096", 1024, 4096)):
        g = torch.Generator(device="cuda").manual_seed(7500)
        xs = [torch.randn((rows, hidden), generator=g, device="cuda").to(dt)
              for _ in range(max(4, -(-128 * 2**20 // (rows * hidden * 2))))]
        w = torch.randn((hidden,), generator=g, device="cuda") + 1
        w_lib = w.to(dt)
        nbytes = 2 * rows * hidden * 2 + hidden * 4
        ms, enqueue_ms = timed([lambda x=x: rms_norm_kernel(x, w) for x in xs], iters=64)
        row = dict(shape=[rows, hidden], dtype="bfloat16 x, f32 weight", ms=ms, enqueue_ms=enqueue_ms,
                   plain_ms=cuda_ms([lambda x=x: rms_norm(x, w) for x in xs], iters=32),
                   library_ms=(cuda_ms([lambda x=x: library(x, (hidden,), w_lib, 1e-5) for x in xs], iters=64)
                               if library is not None else None),
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library_ms_is="torch.nn.functional.rms_norm, bf16 weight")
        times[key] = row
        emit("times", kernel=key, **row)
        del xs
        torch.cuda.empty_cache()


def phase_quant_rms_times(results):
    """Only kernel #6's and #9's timed rows and #5's control (``quant_times``
    and ``rms_times``): the opt-in phase that compares two trees of the
    package in one call, parent and change in turns."""
    times = results.setdefault("times", {})
    quant_times(times)
    rms_times(times)


def _engine_prompts(vocab, seed):
    """Prompts of the engine_e2e phase: varied lengths, repetitive ones (the
    ngram drafter's proposals get accepted), and a shared 100-token prefix
    with 5 distinct tokens each (prefix hits, COW, the kernel's extend)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=100).astype(np.int32)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32) for n in (128, 77, 100)]
    prompts += [np.tile(rng.integers(0, vocab, size=8).astype(np.int32), 12)]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, size=5).astype(np.int32)]) for _ in range(3)]
    return prompts


def phase_engine_e2e(results):
    """Llama-3-8B widths at 2 layers in f32, greedy: ``ServingEngine`` is
    token-identical to one-shot ``generate`` (per request) through the
    kernels and through the plain path — contiguous, paged (page 16),
    paged with int8-KV, speculative (spec_k 4, ngram, paged) and
    ``decode_steps`` 4 with overlap; the counters show the kernel modes
    each ran."""
    import torch

    from tpu_nexus_torch.models.generate import generate
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.serving import ModelExecutor, NGramDrafter, PagedModelExecutor, ServingEngine

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = _engine_prompts(cfg.vocab_size, seed=2)
    new = 24
    refs = {}
    for impl in ("auto", "plain"):
        for kv_quant in ("", "int8"):
            refs[impl, kv_quant] = [
                generate(params, torch.from_numpy(p).cuda()[None], cfg, max_new_tokens=new, max_len=160,
                         kv_quant=kv_quant, attn_impl=impl, decode_kernel=impl)[0].tolist()
                for p in prompts
            ]
    cases = {
        "contiguous": dict(), "paged16": dict(page=16), "paged16_int8kv": dict(page=16, kv_quant="int8"),
        "spec4_ngram_paged16": dict(page=16, spec=4), "decode_steps4_overlap": dict(steps=4, overlap=True),
    }
    for name, case in cases.items():
        for impl in ("auto", "plain"):
            kw = dict(num_slots=3, max_len=160, kv_quant=case.get("kv_quant", ""), decode_kernel=impl, attn_impl=impl,
                      decode_steps=case.get("steps", 1))
            if case.get("page"):
                ex = PagedModelExecutor(params, cfg, page_size=case["page"], **kw)
            else:
                ex = ModelExecutor(params, cfg, **kw)
            spec = case.get("spec", 0)
            eng = ServingEngine(ex, spec_k=spec, drafter=NGramDrafter(3) if spec else None,
                                overlap=case.get("overlap", False))
            reset_launches()
            for i, p in enumerate(prompts):
                eng.submit(p, new, request_id=f"r{i}")
            eng.run_until_drained()
            torch.cuda.synchronize()
            modes = {m: n for m, n in decode_attention.launches_by_mode.items() if n}
            got = {r.request_id: [int(t) for t in r.output_tokens] for r in eng.retired}
            want = refs[impl, case.get("kv_quant", "")]
            mismatched = sum(got[f"r{i}"] != want[i] for i in range(len(prompts)))
            emit("engine_e2e", config=f"llama3_8b widths, 2 layers, f32: {name}", impl=impl, requests=len(prompts),
                 new_tokens=new, token_identical=mismatched == 0, mismatched_requests=mismatched,
                 decode_launches_by_mode=modes, prefix_hits=eng.metrics.prefix_hits,
                 spec_accepted=eng.metrics.spec_accepted)
            if mismatched:
                raise AssertionError(f"engine_e2e {name} ({impl}): {mismatched} requests differ from generate")
            if impl == "auto":
                need = {"contiguous": "contiguous", "paged16": "paged", "paged16_int8kv": "paged+int8",
                        "spec4_ngram_paged16": "paged+ragged", "decode_steps4_overlap": "contiguous"}[name]
                if not modes.get(need):
                    raise AssertionError(f"engine_e2e {name}: no {need} decode launch ({modes})")
            elif modes:
                raise AssertionError(f"engine_e2e {name}: the plain path launched {modes}")
            del eng, ex
    del params
    torch.cuda.empty_cache()


def _shared_prefix_prompts(vocab, batch, prompt_len, seed, shared_len=120):
    """An endless stream of [batch, prompt_len] rounds: one fixed random
    prefix of ``shared_len`` tokens, then distinct random tokens per row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len).astype(np.int32)
    while True:
        tail = rng.integers(0, vocab, size=(batch, prompt_len - shared_len)).astype(np.int32)
        yield np.concatenate([np.broadcast_to(shared, (batch, shared_len)), tail], axis=1)


def phase_serve_engine(results):
    """``run_serve_engine`` on llama3_8b at full width and depth, bf16: 8
    slots, prompt 128, 32 new tokens, 3 rounds (24 requests) plus the
    warm-up, into an in-memory ledger — (a) contiguous, (b) page 32 with
    prompts that share a 120-token prefix (8 distinct tokens each), so
    admissions hit the prefix index and run ``extend_step`` through the
    kernel's paged mode, (c) page 32 with spec_k 4 (ngram).  Each lands
    COMPLETED; the counters, zeroed just before each run, give kernel #4's
    launches by mode (``decode_attention_paged`` counts every launch on the
    paged layout, ``decode_attention_ragged`` every launch in the q_starts
    mode)."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.ops.decode_attention import decode_attention, reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16)
    runs = (("serve_engine_contiguous", {}, False), ("serve_engine_paged", dict(page_size=32), True),
            ("serve_engine_spec", dict(page_size=32, spec_k=4), False))
    for name, extra, shared in runs:
        torch.cuda.empty_cache()
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=128, gen_tokens=32, rounds=3, device="cuda", **extra)
        prompts = _shared_prefix_prompts(model.vocab_size, 8, 128, seed=8) if shared else None
        store = InMemoryCheckpointStore()
        ctx = ProcessContext(run_id=name, algorithm="serve", process_id=0, num_processes=1, coordinator=None)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        reset_launches()
        zero_rms_norm_launches()
        t0 = time.perf_counter()
        summary = run_serve_engine(cfg, store=store, ctx=ctx, prompts=prompts)
        wall = time.perf_counter() - t0
        read_rms_norm_launches(results, name)
        modes = dict(decode_attention.launches_by_mode)
        # by flag: the paged layout (decode, extend and, with spec_k, verify)
        # and the q_starts mode (verify)
        launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
                    "decode_attention_paged": sum(n for m, n in modes.items() if m.startswith("paged")),
                    "decode_attention_ragged": sum(n for m, n in modes.items() if "ragged" in m)}
        row = store.read_checkpoint("serve", name)
        stage = row.lifecycle_stage if row else None
        keys = ("requests", "finished", "engine_steps", "elapsed_s", "decoded_tokens_per_second", "ttft_p50_s",
                "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "prefix_hits", "prefix_shared_tokens", "blocks_cow",
                "spec_proposed", "spec_accepted", "spec_acceptance_rate")
        emit("serve_engine", run=name, config=f"llama3_8b full width and depth, bf16 params, {extra or 'contiguous'}",
             stage=stage, per_chip_steps=row.per_chip_steps if row else None, wall_s=wall,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
             decode_launches_by_mode={m: n for m, n in modes.items() if n}, **{k: summary[k] for k in keys})
        if stage != LifecycleStage.COMPLETED or summary["finished"] != 24:
            raise AssertionError(f"{name}: ledger row is {stage}, {summary['finished']} of 24 finished")
        if extra.get("page_size") and not launches["decode_attention_paged"]:
            raise AssertionError(f"{name}: no paged decode launch ({modes})")
        if extra.get("spec_k") and not launches["decode_attention_ragged"]:
            raise AssertionError(f"{name}: no ragged (q_starts) launch ({modes})")
        if shared and not summary["prefix_hits"]:
            raise AssertionError(f"{name}: no prefix hit")
        if not extra and (modes["contiguous"] < model.n_layers * summary["engine_steps"]):
            raise AssertionError(f"{name}: {modes['contiguous']} contiguous launches < layers x steps")
        results.setdefault("launches", {})[name] = launches


@contextlib.contextmanager
def timed_checkpoints(events, label):
    """Time every ``TensorCheckpointer`` save, commit, verified-step scan and
    restore while the block runs (host wall seconds: the copy to the host,
    the disk and the SHA-256 passes), recording each as a dict in
    ``events`` tagged with ``label["run"]``; saves carry their tensor bytes,
    commits the step directory's manifested bytes."""
    from tpu_nexus_torch.workload import durability
    from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

    names = ("save", "commit", "latest_verified_step", "restore", "restore_params")
    originals = {name: getattr(TensorCheckpointer, name) for name in names}

    def timed(name, fn):
        def method(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            event = {"run": label["run"], "op": name, "seconds": time.perf_counter() - t0}
            if name == "save":
                event.update(step=args[0])
            elif name == "commit":
                manifest = durability.verify_step(self.step_dir(args[0]), args[0], deep=False)
                event.update(step=args[0], dir_bytes=manifest["total_bytes"], dir_files=manifest["file_count"])
            elif name == "latest_verified_step":
                event.update(step=out, deep_verified_bytes=(
                    durability.verify_step(self.step_dir(out), out, deep=False)["total_bytes"] if out else 0))
            else:
                event.update(step=args[1] if name == "restore" and len(args) > 1 else (args[0] if args else None))
            events.append(event)
            return out

        return method

    for name, fn in originals.items():
        setattr(TensorCheckpointer, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(TensorCheckpointer, name, fn)


#: the layers of nexus_1b (of 14) that train_ckpt and serve_reload run
CKPT_LAYERS = 2


def phase_train_ckpt(results):
    """Tensor checkpoints through ``run_workload`` on nexus_1b at full width
    and :data:`CKPT_LAYERS` of its 14 layers (bf16, adamw, remat attn_out,
    batch 8, seq 2048) into a
    temporary directory: A — 12 steps, no checkpoints; B — checkpoint_every
    4, cancelled after step 6 (PREEMPTED, emergency save at 6); C — the
    same directory, resumed from 6, COMPLETED at 12; D — a byte of step
    12's first tensor file flipped, then a restart: rolled back to 8
    (``ckpt_rollback``, ``12.corrupt``), COMPLETED at 12 again.  Per-step
    losses of B, C and D must equal A's bit for bit, and each run launch
    the flash forward, dQ and dK/dV kernels once a layer and step.  Prints the
    bytes and host seconds of every save, commit and verified restore.
    C's final params stay in memory for serve_reload, which removes the
    directory."""
    import atexit
    import shutil
    import tempfile

    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload import durability
    from tpu_nexus_torch.workload import train as train_module
    from tpu_nexus_torch.workload.faults import flip_committed_leaf
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    class Losses(NullMetrics):
        def __init__(self):
            self.losses = []

        def gauge(self, name, value, tags=None):
            if name == "train.loss":
                self.losses.append(value)

    torch.cuda.empty_cache()
    # full width, CKPT_LAYERS of nexus_1b's 14 layers: the saves and
    # verified restores are most of the phase's time
    model = dataclasses.replace(LlamaConfig.nexus_1b(), n_layers=CKPT_LAYERS)
    adapter = LlamaAdapter(config=model)
    steps, batch, seq = 12, 8, 2048
    directory = tempfile.mkdtemp(prefix="nexus-ckpt-")
    atexit.register(shutil.rmtree, directory, True)
    store = InMemoryCheckpointStore()
    counters = _bwd_counters()
    events, label, live = [], {"run": ""}, {}
    real_make = train_module.make_train_step

    def keeping_make(*args, **kwargs):
        """The harness's step, keeping a reference to the live state it
        updates (C's final params are served from memory later)."""
        step_fn = real_make(*args, **kwargs)

        def step(state, batch_):
            out = step_fn(state, batch_)
            live[label["run"]] = out[0]
            return out

        return step

    def cancelling(lifecycle, at):
        source = adapter.data(batch, seq, seed=0)
        for i, item in enumerate(source):
            if i == at:
                lifecycle.cancel("SIGTERM")
            yield item

    runs, launches_total = {}, {c.__name__: 0 for c in counters}

    def run(name, run_id, checkpoint_every=0, cancel_at=None):
        label["run"] = name
        lifecycle = LifecycleContext()
        cfg = WorkloadConfig(model=adapter, train=TrainConfig(warmup_steps=10, total_steps=steps, optimizer="adamw"),
                             batch_size=batch, seq_len=seq, steps=steps, heartbeat_every=1,
                             checkpoint_every=checkpoint_every, checkpoint_dir=directory if checkpoint_every else "",
                             device="cuda")
        ctx = ProcessContext(run_id=run_id, algorithm="train", process_id=0, num_processes=1, coordinator=None)
        telemetry = Losses()
        for c in counters:
            c.launches = 0
        zero_rms_norm_launches()
        t0 = time.perf_counter()
        summary = run_workload(cfg, store=store, ctx=ctx, telemetry=telemetry, lifecycle=lifecycle,
                               data=None if cancel_at is None else cancelling(lifecycle, cancel_at))
        wall = time.perf_counter() - t0
        read_rms_norm_launches(results, f"train_ckpt_{name}")
        launches = {c.__name__: c.launches for c in counters}
        for k, v in launches.items():
            launches_total[k] += v
        row = store.read_checkpoint("train", run_id)
        goodput = summary.get("goodput", {})
        runs[name] = dict(
            stage=row.lifecycle_stage, uri=row.tensor_checkpoint_uri, wall_s=wall, losses=telemetry.losses,
            launches=launches, final_step=summary["final_step"], resumed_from=summary["resumed_from"],
            emergency_step=summary.get("emergency_step"), emergency_skipped=summary.get("emergency_skipped"),
            ckpt_rollbacks=[{k: e[k] for k in ("step", "cause")} for e in summary.get("ckpt_rollbacks", [])],
            details_keys=sorted(json.loads(row.algorithm_failure_details or "{}")),
            checkpoint_bucket_s=goodput.get("buckets_s", {}).get("checkpoint"),
            goodput_elapsed_s=goodput.get("elapsed_s"),
            directory=sorted(os.listdir(directory)),
        )
        want = model.n_layers * (len(telemetry.losses))
        if any(n != want for n in launches.values()):
            raise AssertionError(f"run {name}: launches {launches} != {model.n_layers} x {len(telemetry.losses)}")
        return runs[name]

    train_module.make_train_step = keeping_make
    try:
        with timed_checkpoints(events, label):
            a = run("A", "chip-smoke-ckpt-a")
            b = run("B", "chip-smoke-ckpt", checkpoint_every=4, cancel_at=5)
            c = run("C", "chip-smoke-ckpt", checkpoint_every=4)
            c_params = live["C"]["params"]
            live.clear()
            flipped = flip_committed_leaf(os.path.join(directory, "12"))
            d = run("D", "chip-smoke-ckpt-restart", checkpoint_every=4)
            live.clear()
    finally:
        train_module.make_train_step = real_make
    losses = {"A": a["losses"], "B": b["losses"], "C": c["losses"], "D": d["losses"]}
    mismatch = {
        "B_vs_A_1_6": max((abs(x - y) for x, y in zip(b["losses"], a["losses"][:6])), default=None),
        "C_vs_A_7_12": max((abs(x - y) for x, y in zip(c["losses"], a["losses"][6:])), default=None),
        "D_vs_A_9_12": max((abs(x - y) for x, y in zip(d["losses"], a["losses"][8:])), default=None),
    }
    ckpt_c = c["checkpoint_bucket_s"]
    emit("train_ckpt", config=f"nexus_1b full width, {CKPT_LAYERS} of 14 layers, bf16 params, adamw, remat attn_out",
         batch=batch, seq=seq, steps=steps, runs=runs, losses_max_abs_diff=mismatch,
         flipped=os.path.relpath(flipped, directory), checkpoint_events=events,
         checkpoint_share_of_run_C=ckpt_c / c["goodput_elapsed_s"] if ckpt_c is not None else None,
         directory_free_bytes=shutil.disk_usage(directory).free)
    if a["stage"] != LifecycleStage.COMPLETED or a["final_step"] != steps or len(a["losses"]) != steps:
        raise AssertionError(f"A: {a['stage']} at {a['final_step']}")
    if (b["stage"] != LifecycleStage.PREEMPTED or b["final_step"] != 6 or b["uri"] != f"{directory}/6"
            or b["emergency_step"] != 6 or b["emergency_skipped"]):
        raise AssertionError(f"B: {b['stage']} at {b['final_step']}, uri {b['uri']}, emergency {b['emergency_step']}")
    if c["stage"] != LifecycleStage.COMPLETED or c["resumed_from"] != 6 or c["final_step"] != steps:
        raise AssertionError(f"C: {c['stage']}, resumed from {c['resumed_from']}, at {c['final_step']}")
    if (d["stage"] != LifecycleStage.COMPLETED or d["resumed_from"] != 8 or d["final_step"] != steps
            or d["ckpt_rollbacks"] != [{"step": 12, "cause": "corrupt"}] or "ckpt_rollback" not in d["details_keys"]
            or "12" + durability.QUARANTINE_SUFFIX not in d["directory"]):
        raise AssertionError(f"D: {d['stage']}, resumed from {d['resumed_from']}, rollbacks {d['ckpt_rollbacks']}, "
                             f"details {d['details_keys']}, directory {d['directory']}")
    if losses["B"] != losses["A"][:6] or losses["C"] != losses["A"][6:] or losses["D"] != losses["A"][8:]:
        raise AssertionError(f"resumed losses differ from the uninterrupted run's: {mismatch}")
    results.setdefault("launches", {})["train_ckpt"] = launches_total
    results["train_ckpt"] = {"dir": directory, "c_params": c_params, "model": model}
    torch.cuda.empty_cache()


def phase_ckpt_probe(results):
    """Where a checkpoint's seconds go, for a nexus_1b adamw train state on
    the card (5.7 GB in 38 tensors; opt-in): the copies to pageable host
    memory, ``torch.save`` into the page cache, the fsyncs, one SHA-256
    pass over the files (what ``commit`` and a verified restore each pay),
    ``torch.load`` back to the host and the copies to the card — each
    host wall seconds over all the leaves, with its rate."""
    import hashlib
    import shutil
    import tempfile

    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, param_leaves

    torch.cuda.empty_cache()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), LlamaAdapter(config=LlamaConfig.nexus_1b()),
                             TrainConfig(), "cuda")
    leaves = [p.detach() for _, p in param_leaves(state["params"])]
    leaves += [t for leaf in state["opt_state"]["leaves"] for t in leaf.values()]
    total = sum(t.numel() * t.element_size() for t in leaves)
    directory = tempfile.mkdtemp(prefix="nexus-ckpt-probe-")
    seconds = {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [t.to("cpu") for t in leaves]
        seconds["device_to_host"] = time.perf_counter() - t0
        paths = [os.path.join(directory, f"{i:05d}.pt") for i in range(len(host))]
        t0 = time.perf_counter()
        handles = []
        for t, path in zip(host, paths):
            fh = open(path, "wb")
            torch.save(t, fh)
            fh.flush()
            handles.append(fh)
        seconds["torch_save_to_page_cache"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for fh in handles:
            os.fsync(fh.fileno())
            fh.close()
        seconds["fsync"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for path in paths:
            digest = hashlib.sha256()
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 20), b""):
                    digest.update(block)
        seconds["sha256_pass"] = time.perf_counter() - t0
        del host
        t0 = time.perf_counter()
        loaded = [torch.load(path, weights_only=True) for path in paths]
        seconds["torch_load_to_host"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_card = [t.to("cuda") for t in loaded]
        torch.cuda.synchronize()
        seconds["host_to_device"] = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(on_card, leaves)):
            raise AssertionError("the probe's round trip changed a tensor")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    emit("ckpt_probe", config="nexus_1b adamw train state (params, mu, nu in bf16)", bytes=total, tensors=len(leaves),
         seconds=seconds, gb_per_second={k: total / v / 1e9 for k, v in seconds.items()},
         cpus=os.cpu_count(), disk=shutil.disk_usage(tempfile.gettempdir())._asdict())
    del state, leaves, loaded, on_card
    torch.cuda.empty_cache()


def phase_serve_reload(results):
    """Serving from train_ckpt's directory on nexus_1b (bf16, train_ckpt's
    :data:`CKPT_LAYERS` layers): (1)
    ``run_serving`` (batch 8, prompt 128, 32 new tokens, 2 rounds) restores
    the newest verified step, 12, whose params equal C's final params in
    memory bit for bit, and each greedy round's tokens equal ``generate``
    over C's params from memory on the same prompts; (2) a
    ``ServingEngine`` on the restored params takes 8 requests, a new step
    13 (step 12's params plus seeded noise) is committed, and
    ``_reload_if_newer`` quiesces the engine (the in-flight requests finish
    on step 12) and hot-swaps 13; 8 more requests follow.  One weight swap,
    all 16 requests FINISHED, the pre-swap tokens are step 12's own and the
    post-swap tokens step 13's own (an engine over those params alone).
    Removes the directory."""
    import shutil

    import numpy as np
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.serving import ModelExecutor, RequestState, ServingEngine
    from tpu_nexus_torch.workload import durability
    from tpu_nexus_torch.workload import serve as serve_module
    from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

    if "train_ckpt" not in results:
        raise AssertionError("serve_reload serves train_ckpt's directory: run it with --phases train_ckpt,serve_reload")
    directory, c_params, model = (results["train_ckpt"][k] for k in ("dir", "c_params", "model"))
    events, label = [], {"run": "serve"}
    calls = []
    real_generate = serve_module.generate

    def recording(params, prompt, cfg, **kwargs):
        out = real_generate(params, prompt, cfg, **kwargs)
        calls.append((prompt.clone(), out.clone(), kwargs))
        return out

    cfg = serve_module.ServeConfig(model=LlamaAdapter(config=model), batch_size=8, prompt_len=128, gen_tokens=32,
                                   rounds=2, checkpoint_dir=directory, device="cuda")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="chip-smoke-reload", algorithm="serve", process_id=0, num_processes=1,
                         coordinator=None)
    flash_attention.launches = 0
    decode_attention.launches = 0
    zero_rms_norm_launches()
    serve_module.generate = recording
    t0 = time.perf_counter()
    try:
        with timed_checkpoints(events, label):
            summary = serve_module.run_serving(cfg, store=store, ctx=ctx)
    finally:
        serve_module.generate = real_generate
    serve_wall = time.perf_counter() - t0
    serve_launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    newest = durability.newest_verified_step(directory, quarantine=False)[0]
    restored = TensorCheckpointer(directory).restore_params(newest)
    same_params = all(torch.equal(p, q) for p, q in zip(restored.parameters(), c_params.parameters()))
    with torch.inference_mode():
        same_tokens = [torch.equal(out, real_generate(c_params, prompt, model, **kw)) for prompt, out, kw in calls]
    row = store.read_checkpoint("serve", "chip-smoke-reload")

    # (2) the hot swap: step 13 = step 12's params plus seeded noise
    gen = torch.Generator(device="cuda").manual_seed(13)
    new_params = TensorCheckpointer(directory).restore_params(newest)
    with torch.no_grad():
        for p in new_params.parameters():
            p.add_((torch.randn(p.shape, generator=gen, device="cuda") * 0.02).to(p.dtype))
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, model.vocab_size, size=(16, 128)).astype(np.int32)

    def engine_over(params):
        return ServingEngine(ModelExecutor(params, model, num_slots=8, max_len=128 + 32))

    def own_tokens(params, rows):
        eng = engine_over(params)
        reqs = [eng.submit(p, 32) for p in rows]
        eng.run_until_drained()
        return [list(r.output_tokens) for r in reqs]

    flash_attention.launches = 0
    decode_attention.launches = 0
    engine = engine_over(restored)
    label["run"] = "swap"
    with timed_checkpoints(events, label):
        pre = [engine.submit(p, 32) for p in prompts[:8]]
        for _ in range(4):
            engine.step()
        ckpt = TensorCheckpointer(directory)
        ckpt.save(newest + 1, {"params": new_params, "step": torch.tensor(newest + 1, dtype=torch.int32)})
        ckpt.commit(newest + 1)
        poller = durability.VerifiedStepPoller(directory)
        t0 = time.perf_counter()
        serving_step = serve_module._reload_if_newer(engine, poller.latest_verified_step(), directory, newest, "", 60.0)
        swap_s = time.perf_counter() - t0
    post = [engine.submit(p, 32) for p in prompts[8:]]
    engine.run_until_drained()
    torch.cuda.synchronize()
    swap_launches = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches}
    read_rms_norm_launches(results, "serve_reload")
    states = [r.state for r in pre + post]
    pre_ok = [list(r.output_tokens) for r in pre] == own_tokens(restored, prompts[:8])
    post_ok = [list(r.output_tokens) for r in post] == own_tokens(new_params, prompts[8:])
    emit("serve_reload", config="nexus_1b full width and depth, bf16, restored from train_ckpt's directory",
         restored_from=summary["restored_from"], newest_verified=newest, stage=row.lifecycle_stage if row else None,
         serve_wall_s=serve_wall, restored_equals_c_params=same_params, rounds_token_identical=same_tokens,
         serve_launches=serve_launches, serving_step=serving_step, weight_swaps=engine.weight_swaps,
         swap_s=swap_s, finished=sum(s == RequestState.FINISHED for s in states), requests=len(states),
         pre_swap_tokens_are_step12s=pre_ok, post_swap_tokens_are_step13s=post_ok, swap_launches=swap_launches,
         checkpoint_events=events, decoded_tokens_per_second=summary["decoded_tokens_per_second"])
    shutil.rmtree(directory)
    del results["train_ckpt"]
    if row is None or row.lifecycle_stage != LifecycleStage.COMPLETED:
        raise AssertionError(f"run_serving ledger row is {row.lifecycle_stage if row else None}")
    if summary["restored_from"] != newest or newest != 12:
        raise AssertionError(f"restored_from {summary['restored_from']}, newest verified {newest}, not 12")
    if not same_params or not same_tokens or not all(same_tokens):
        raise AssertionError(f"served tokens differ from C's params in memory: params {same_params}, {same_tokens}")
    if serving_step != newest + 1 or engine.weight_swaps != 1:
        raise AssertionError(f"hot swap: serving step {serving_step}, weight swaps {engine.weight_swaps}")
    if states != [RequestState.FINISHED] * 16 or not pre_ok or not post_ok:
        raise AssertionError(f"swap: states {states}, pre-swap tokens {pre_ok}, post-swap tokens {post_ok}")
    if (serve_launches["flash_attention"] != model.n_layers * summary["prefill_calls"]
            or serve_launches["decode_attention"] < model.n_layers * summary["decode_steps"]):
        raise AssertionError(f"run_serving launches {serve_launches} for {summary['prefill_calls']} prefill calls "
                             f"and {summary['decode_steps']} decode steps of {model.n_layers} layers")
    if not all(swap_launches.values()):
        raise AssertionError(f"the engine launched no kernel of a path: {swap_launches}")
    results.setdefault("launches", {})["serve_reload"] = {
        k: serve_launches[k] + swap_launches[k] for k in serve_launches
    }
    torch.cuda.empty_cache()


def _zero_serving_counts() -> None:
    """Set the counts of the serving paths' kernels (#1, #4 by mode, #9) to
    0 just before a main-path run."""
    from tpu_nexus_torch.ops.decode_attention import reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    reset_launches()
    zero_rms_norm_launches()


def _serving_counts(results, path: str) -> dict:
    """The serving kernels' counts just after one run, recorded under
    ``path`` (one key a run: a main run and a fault drill never share one):
    #1, #4 whole, #4 on the paged layout (``decode_attention_paged``) and
    in its int8-KV mode (``decode_attention_int8kv``), and #9's."""
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention

    torch_sync()
    read_rms_norm_launches(results, path)
    modes = decode_attention.launches_by_mode
    counts = {"flash_attention": flash_attention.launches, "decode_attention": decode_attention.launches,
              "decode_attention_paged": sum(n for m, n in modes.items() if m.startswith("paged")),
              "decode_attention_int8kv": sum(n for m, n in modes.items() if "int8" in m)}
    results.setdefault("launches", {})[path] = counts
    return counts


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def _finished_tokens(reqs) -> int:
    from tpu_nexus_torch.serving import RequestState

    return sum(len(r.output_tokens) for r in reqs if r.state == RequestState.FINISHED)


def phase_fleet(results):
    """Three fused paged replicas of nexus_1b at full width and depth
    (bf16), page 32, 32 slots each (the reference bench's 4 x 8 lanes),
    unbounded queues, behind the ``pressure`` router and then
    ``round-robin``.  The traffic is the reference's fan-out
    (``bench_serving.py::make_prefix_requests``): 48 requests, one shared
    96-token prefix plus a unique 32-token tail each, 32 new tokens.  Every
    request FINISHED under both policies with the tokens of an engine of
    the same geometry given the same requests in the same order as its
    replica (under ``pressure`` one engine serving the whole fan-out
    alone); under ``pressure`` the fan-out lands on one replica with 47
    fleet-wide prefix hits (fanout - 1), under rotation more than one
    replica pays the shared prefill.  Then a kill mid-burst: 24 requests
    of distinct prompts, two ticks, ``kill_replica`` on the replica
    holding the most live requests, 6 more requests; every request
    terminal, each casualty with the kill's cause, none silently
    dropped."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.serving import CAUSE_REPLICA_LOST, PagedModelExecutor, RequestState, ServingEngine, ServingFleet

    torch.cuda.empty_cache()
    model = LlamaConfig.nexus_1b()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), model, device="cuda")
    fanout, shared_len, tail_len, new, page, slots = 48, 96, 32, 32, 32, 32
    rng = np.random.default_rng(0)
    shared = rng.integers(0, model.vocab_size, size=shared_len).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, model.vocab_size, size=tail_len).astype(np.int32)])
               for _ in range(fanout)]
    max_len = shared_len + tail_len + new

    def engine():
        return ServingEngine(PagedModelExecutor(params, model, num_slots=slots, max_len=max_len, page_size=page))

    # warm-up: one full prefill and one extend per engine shape, outside the counts
    warm = engine()
    for i, p in enumerate((prompts[0], np.concatenate([prompts[0][:-1], [1]]).astype(np.int32))):
        warm.submit(p, 2, request_id=f"warm-{i}")
    warm.run_until_drained()
    del warm
    rows = {}
    for policy in ("pressure", "round-robin"):
        torch.cuda.empty_cache()
        fleet = ServingFleet(policy=policy)
        for i in range(3):
            fleet.add_replica(f"page-{i}", engine(), step=0)
        _zero_serving_counts()
        torch_sync()
        t0 = time.perf_counter()
        reqs = [fleet.submit(p, new, request_id=f"fan-{i}") for i, p in enumerate(prompts)]
        fleet.run_until_drained()
        torch_sync()
        wall = time.perf_counter() - t0
        counts = _serving_counts(results, f"fleet_{policy}")
        on = {r.request_id: name for name, rep in fleet.replicas.items() for r in rep.all_retired()}
        landed = {name: sum(1 for r in reqs if on.get(r.request_id) == name) for name in fleet.replicas}
        hits = sum(rep.engine.metrics.prefix_hits for rep in fleet.replicas.values())
        steps = {n: rep.engine.steps for n, rep in fleet.replicas.items()}
        retries = fleet.router.retries
        del fleet
        # each replica's reference: an engine given the same requests in the same order
        want = {}
        for name in landed:
            mine = [i for i, r in enumerate(reqs) if on.get(r.request_id) == name]
            if mine:
                alone = engine()
                got = [alone.submit(prompts[i], new, request_id=f"fan-{i}") for i in mine]
                alone.run_until_drained()
                want.update((i, list(r.output_tokens)) for i, r in zip(mine, got))
                del alone
        mismatched = sum(list(r.output_tokens) != want.get(i) for i, r in enumerate(reqs))
        finished = sum(r.state == RequestState.FINISHED for r in reqs)
        rows[policy] = dict(landed=landed, hits=hits, finished=finished, mismatched=mismatched)
        emit("fleet", config=f"nexus_1b full width and depth, bf16, 3 paged replicas (page {page}, {slots} slots)",
             policy=policy, requests=fanout, finished=finished, token_identical_to_replica_alone=mismatched == 0,
             mismatched_requests=mismatched, prefix_hits_fleetwide=hits, landed_per_replica=landed,
             replicas_touched=sum(1 for n in landed.values() if n), router_retries=retries, engine_steps=steps, wall_s=wall,
             decoded_tokens_per_second=_finished_tokens(reqs) / wall, launches=counts)
        if finished != fanout or mismatched:
            raise AssertionError(f"fleet {policy}: {finished} of {fanout} FINISHED, {mismatched} differ from "
                                 "an engine given its replica's requests")
        if not counts["flash_attention"] or not counts["decode_attention_paged"]:
            raise AssertionError(f"fleet {policy}: a kernel of the path was not launched: {counts}")
    if rows["pressure"]["hits"] != fanout - 1 or sorted(rows["pressure"]["landed"].values()) != [0, 0, fanout]:
        raise AssertionError(f"pressure: {rows['pressure']} (want the fan-out on one replica, {fanout - 1} hits)")
    if sum(1 for n in rows["round-robin"]["landed"].values() if n) < 2:
        raise AssertionError(f"round-robin: one replica took the whole fan-out: {rows['round-robin']}")

    # kill mid-burst (a fault drill: its counts under their own key)
    torch.cuda.empty_cache()
    fleet = ServingFleet()
    for i in range(3):
        fleet.add_replica(f"page-{i}", engine(), step=0)
    burst = rng.integers(0, model.vocab_size, size=(30, shared_len + tail_len)).astype(np.int32)
    _zero_serving_counts()
    reqs = [fleet.submit(p, new, request_id=f"burst-{i}") for i, p in enumerate(burst[:24])]
    fleet.tick()
    fleet.tick()
    victim = max(fleet.replicas, key=lambda n: len(fleet.replicas[n].engine.requests))
    held = len(fleet.replicas[victim].engine.requests)
    cause = f"{CAUSE_REPLICA_LOST}:chip-smoke-kill"
    accounted = fleet.kill_replica(victim, cause)
    reqs += [fleet.submit(p, new, request_id=f"burst-{24 + i}") for i, p in enumerate(burst[24:])]
    fleet.run_until_drained()
    _serving_counts(results, "fleet_kill")
    states = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
    casualties = [r for r in reqs if r.state != RequestState.FINISHED]
    silent = [r.request_id for r in reqs if not r.is_terminal() or (r.state != RequestState.FINISHED and r.cause != cause)]
    emit("fleet", run="kill mid-burst", victim=victim, live_on_victim=held, accounted_at_kill=accounted,
         requests=len(reqs), retired_states=states, casualties=len(casualties), silently_dropped=len(silent),
         victim_gets_no_new_request=not any(r.request_id in fleet.replicas[victim].engine.requests
                                            for r in reqs[24:]))
    if not held or accounted != held or len(casualties) != held or silent:
        raise AssertionError(f"kill: {held} live, {accounted} accounted, {len(casualties)} casualties, silent {silent}")
    del fleet, params
    torch.cuda.empty_cache()


class _TimedSeam:
    """Wraps a paged executor and times each prefill and KV handoff
    dispatch in host wall milliseconds with the stream synchronised before
    and after (prefill: ``begin``, the flash prefill and the block scatter;
    extract: the gather and the copy to the host; install: validation, the
    copy to the card and the scatter).  Installed payloads are kept for the
    seal and validate timings."""

    def __init__(self, inner):
        self.inner = inner
        self.prefill_ms, self.extract_ms, self.install_ms, self.payloads = [], [], [], []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def begin(self, slot, prompt, **kwargs):
        torch_sync()
        t0 = time.perf_counter()
        out = self.inner.begin(slot, prompt, **kwargs)
        torch_sync()
        self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def extract_blocks(self, block_ids):
        torch_sync()
        t0 = time.perf_counter()
        out = self.inner.extract_blocks(block_ids)
        torch_sync()
        self.extract_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def install_blocks(self, payload, block_ids):
        torch_sync()
        t0 = time.perf_counter()
        self.inner.install_blocks(payload, block_ids)
        torch_sync()
        self.install_ms.append((time.perf_counter() - t0) * 1e3)
        self.payloads.append(payload)


def _handoff_timings(fleet, timed_reqs, page):
    """The timed run's handoffs, by payload size in blocks: the payload
    bytes and the prefill / extract / seal / validate / install ms of each
    (``_TimedSeam`` around every replica of ``fleet``; seal and validate
    re-run here on the installed payloads, which must be unchanged).
    Returns ``(by_blocks, payload bytes of each handoff)``."""
    import numpy as np

    from tpu_nexus_torch.serving import ROLE_PREFILL, validate_payload
    from tpu_nexus_torch.serving.handoff import leaf_bytes

    seams = {name: rep.engine.executor for name, rep in fleet.replicas.items()}
    (sender,) = [seams[name] for name, rep in fleet.replicas.items() if rep.role == ROLE_PREFILL]
    receivers = [seams[name] for name, rep in fleet.replicas.items() if rep.role != ROLE_PREFILL]
    extract_ms, prefill_ms = sender.extract_ms, sender.prefill_ms
    install_ms = [ms for seam in receivers for ms in seam.install_ms]
    payloads = [p for seam in receivers for p in seam.payloads]
    seal_ms, validate_ms = [], []
    specs = receivers[0].kv_leaf_specs()
    for payload in payloads:
        sealed = dict(payload.checksums)
        t0 = time.perf_counter()
        payload.seal()
        seal_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        validate_payload(payload, page_size=page, leaf_specs=specs)
        validate_ms.append((time.perf_counter() - t0) * 1e3)
        if payload.checksums != sealed:
            raise AssertionError(f"{payload.request_id}: the payload changed after its install")
    nbytes = [sum(leaf_bytes(a).nbytes for a in p.blocks.values()) for p in payloads]
    # one prefill and one extract a request, in submission order on the
    # prefill replica; the installs are keyed by their payloads
    n = len(timed_reqs)
    if len(prefill_ms) != n or len(extract_ms) != n or len(payloads) != n:
        raise AssertionError(f"{len(prefill_ms)} prefills, {len(extract_ms)} extracts, {len(payloads)} "
                             f"installs for {n} requests")
    sent = {r.request_id: (f, e) for r, f, e in zip(timed_reqs, prefill_ms, extract_ms)}
    by_blocks = {}
    for p, b, s_, v, i_ in zip(payloads, nbytes, seal_ms, validate_ms, install_ms):
        row = by_blocks.setdefault(p.n_blocks, {"handoffs": 0, "payload_bytes": b, "prefill_ms": [],
                                                "extract_ms": [], "seal_ms": [], "validate_ms": [],
                                                "install_ms": []})
        row["handoffs"] += 1
        f, e = sent[p.request_id]
        for key, val in (("prefill_ms", f), ("extract_ms", e), ("seal_ms", s_), ("validate_ms", v),
                         ("install_ms", i_)):
            row[key].append(val)
    for row in by_blocks.values():
        for key in ("prefill_ms", "extract_ms", "seal_ms", "validate_ms", "install_ms"):
            row[key] = {"mean": float(np.mean(row[key])), "min": float(np.min(row[key])),
                        "max": float(np.max(row[key]))}
    return by_blocks, nbytes


def _disagg_mix(vocab, n, seed):
    """The reference's disaggregated mix (``bench_serving.py::
    make_disagg_requests``, its lengths x 4): a third long prompts (192
    tokens, 16 new) beside short prompts (32 tokens, 192 new), each with a
    unique first token so no request prefix-hits another."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen, gen = (192, 16) if rng.random() < 1.0 / 3.0 else (32, 192)
        body = rng.integers(0, vocab - n, size=plen - 1).astype(np.int32)
        out.append((np.concatenate([np.array([vocab - n + i], np.int32), body]), gen))
    return out


#: disagg's requests (the reference's mix, cut from 24 for the script's time)
DISAGG_REQUESTS = 8
#: disagg's depth: 8 of llama3_8b's 32 layers (cut for the script's time)
DISAGG_LAYERS = 8


def phase_disagg(results):
    """Disaggregated serving of llama3_8b at full width, :data:`DISAGG_LAYERS`
    of its 32 layers (bf16 params), one prefill and two decode replicas sharing one params tree,
    page 32; bf16 KV, then an int8 KV cache.  :data:`DISAGG_REQUESTS` requests
    of the reference's mix (:func:`_disagg_mix`) are submitted at once: each
    prefills on the prefill replica, its KV blocks cross to the host,
    sealed, and install on a decode replica.  Tokens equal a fused engine's
    of the decode replicas' geometry on the same prompts;
    ``handoffs_completed`` is one a request and ``disagg_fallbacks`` 0; this run is
    uninstrumented, as the fused engine's is, and gives the tokens/s and
    the kernel counts.  A timed run of the same prompts (4 new tokens
    each) gives the payload bytes and the extract / seal / validate /
    install ms per handoff (host wall, stream synchronised around each
    call).  A pass of 6 requests then wraps the prefill replica in
    ``handoff-drop`` (the retry heals in place: ``serving.handoff_retry``)
    and decode replica 0 in ``kill-mid-handoff`` (the hop lands in
    ``handoff_log``, the replica goes down); every request is terminal
    and none silently dropped."""
    import torch

    from tpu_nexus_torch.core.telemetry import RecordingMetrics
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.serving import (ROLE_DECODE, ROLE_PREFILL, DisaggConfig, PagedModelExecutor, RequestState,
                                         ServingEngine, ServingFleet)
    from tpu_nexus_torch.workload.faults import FaultyExecutor

    torch.cuda.empty_cache()
    model = dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16, n_layers=DISAGG_LAYERS)
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), model, device="cuda")
    mix = _disagg_mix(model.vocab_size, DISAGG_REQUESTS, seed=5)
    page, decode_slots, max_len = 32, 12, 224

    def executor(kv_quant, slots):
        return PagedModelExecutor(params, model, num_slots=slots, max_len=max_len, page_size=page,
                                  kv_quant=kv_quant)

    def fleet_of(kv_quant, wrap=None, metrics=None):
        fleet = ServingFleet(disagg=DisaggConfig(), metrics=metrics)
        wrap = wrap or {}
        for name, role, slots in (("pf-0", ROLE_PREFILL, 2), ("dc-0", ROLE_DECODE, decode_slots),
                                  ("dc-1", ROLE_DECODE, decode_slots)):
            ex = executor(kv_quant, slots)
            fleet.add_replica(name, ServingEngine(wrap[name](ex) if name in wrap else ex), step=0, role=role)
        return fleet

    for kv_quant in ("", "int8"):
        label = "int8 KV" if kv_quant else "bf16 KV"
        warm = ServingEngine(executor(kv_quant, decode_slots))
        for p, _ in (mix[0], mix[1]):
            warm.submit(p, 2)
        warm.run_until_drained()
        fused = ServingEngine(executor(kv_quant, decode_slots))
        fused_reqs = [fused.submit(p, gen, request_id=f"d{i}") for i, (p, gen) in enumerate(mix)]
        torch_sync()
        t0 = time.perf_counter()
        fused.run_until_drained()
        torch_sync()
        fused_wall = time.perf_counter() - t0
        want = [list(r.output_tokens) for r in fused_reqs]
        del warm, fused
        torch.cuda.empty_cache()
        # the main run, uninstrumented as the fused engine was: tokens,
        # handoffs, launches and tokens/s
        fleet = fleet_of(kv_quant)
        _zero_serving_counts()
        torch_sync()
        t0 = time.perf_counter()
        reqs = [fleet.submit(p, gen, request_id=f"d{i}") for i, (p, gen) in enumerate(mix)]
        fleet.run_until_drained()
        torch_sync()
        wall = time.perf_counter() - t0
        path = "disagg_int8" if kv_quant else "disagg"
        counts = _serving_counts(results, path)
        mismatched = sum(list(r.output_tokens) != want[i] for i, r in enumerate(reqs))
        finished = sum(r.state == RequestState.FINISHED for r in reqs)
        tokens = _finished_tokens(reqs)
        handoffs, fallbacks, log = fleet.handoffs_completed, fleet.disagg_fallbacks, fleet.handoff_log
        prefill_retired = len(fleet.replicas["pf-0"].engine.retired)
        del fleet
        torch.cuda.empty_cache()
        # the timed run: the same prompts, 4 new tokens each, every executor
        # timed (the stream synchronised around each prefill and handoff
        # dispatch); prefill and handoff run inside submit, so the shorter
        # generation changes none of the timed calls
        fleet = fleet_of(kv_quant, wrap={name: _TimedSeam for name in ("pf-0", "dc-0", "dc-1")})
        timed_reqs = [fleet.submit(p, 4, request_id=f"t{i}") for i, (p, _) in enumerate(mix)]
        fleet.run_until_drained()
        if fleet.handoffs_completed != len(mix) or any(r.state != RequestState.FINISHED for r in timed_reqs):
            raise AssertionError(f"timed disagg {label}: {fleet.handoffs_completed} handoffs, "
                                 f"states {[r.state for r in timed_reqs]}")
        by_blocks, nbytes = _handoff_timings(fleet, timed_reqs, page)
        emit("disagg", config=f"llama3_8b full width, {model.n_layers} of 32 layers, bf16 params, {label}, 1 prefill + 2 decode "
             f"replicas ({decode_slots} slots, page {page}), one params tree", requests=len(mix), finished=finished,
             token_identical_to_fused=mismatched == 0, mismatched_requests=mismatched,
             handoffs_completed=handoffs, disagg_fallbacks=fallbacks, handoff_log=log,
             prefill_replica_retired=prefill_retired, wall_s=wall, decoded_tokens_per_second=tokens / wall,
             fused_wall_s=fused_wall, fused_decoded_tokens_per_second=_finished_tokens(fused_reqs) / fused_wall,
             launches=counts, timed_run="the same prompts, 4 new tokens, each seam call synchronised and timed",
             handoff_by_blocks=by_blocks, payload_bytes_total=sum(nbytes))
        if finished != len(mix) or mismatched:
            raise AssertionError(f"disagg {label}: {finished} FINISHED, {mismatched} differ from the fused engine")
        if handoffs != len(mix) or fallbacks:
            raise AssertionError(f"disagg {label}: {handoffs} handoffs, {fallbacks} fallbacks")
        if not counts["flash_attention"] or not counts["decode_attention_paged"] or (
                kv_quant and counts["decode_attention_int8kv"] != counts["decode_attention_paged"]):
            raise AssertionError(f"disagg {label}: a kernel of the path was not launched: {counts}")
        del fleet
        torch.cuda.empty_cache()

    # the chaos pass: a dropped transfer heals in place, a decode replica
    # killed mid-handoff hops the request to the other
    metrics = RecordingMetrics()
    fleet = fleet_of("", metrics=metrics, wrap={
        "pf-0": lambda ex: FaultyExecutor(ex, "handoff-drop", at_step=0, times=1),
        "dc-0": lambda ex: FaultyExecutor(ex, "kill-mid-handoff", at_step=0, times=1),
    })
    _zero_serving_counts()
    reqs = [fleet.submit(p, 16, request_id=f"c{i}") for i, (p, _) in enumerate(mix[:6])]
    fleet.run_until_drained()
    _serving_counts(results, "disagg_chaos")
    silent = [r.request_id for r in reqs if not r.is_terminal()
              or (r.state != RequestState.FINISHED and not r.cause.startswith("replica-lost:"))]
    hops = [e for e in fleet.handoff_log if e["stage"] == "decode"]
    emit("disagg", run="chaos: handoff-drop on pf-0, kill-mid-handoff on dc-0", requests=len(reqs),
         finished=sum(r.state == RequestState.FINISHED for r in reqs),
         handoff_retries=metrics.counters.get("serving.handoff_retry", 0), handoff_log=fleet.handoff_log,
         dc0_state=fleet.replicas["dc-0"].state, dc0_cause=fleet.replicas["dc-0"].down_cause,
         handoffs_completed=fleet.handoffs_completed, disagg_fallbacks=fleet.disagg_fallbacks,
         silently_dropped=len(silent))
    if silent or not metrics.counters.get("serving.handoff_retry") or not hops:
        raise AssertionError(f"chaos: silent {silent}, retries {metrics.counters}, hops {fleet.handoff_log}")
    if fleet.replicas["dc-0"].state != "down" or any(r.state != RequestState.FINISHED for r in reqs):
        raise AssertionError(f"chaos: dc-0 {fleet.replicas['dc-0'].state}, states {[r.state for r in reqs]}")
    del fleet, params
    torch.cuda.empty_cache()


def phase_fleet_rollout(results):
    """A zero-drop rolling update of three replicas of nexus_1b at full
    width, :data:`CKPT_LAYERS` of its 14 layers (bf16, paged, page 32, 4
    slots): steps 1 and 2 (seeds
    1 and 2) are committed with ``TensorCheckpointer`` into a temporary
    directory, the replicas start on step 1's restored params, 24 requests
    are submitted (12 decoding, 12 queued), step 2 is committed while they
    are in flight, and the
    serving loop offers each newer step ``CheckpointWatcher`` verifies to
    ``start_rollout`` + ``tick``.  The fleet converges to step 2 with every
    request FINISHED, each on one step's own tokens (an engine over that
    step's params alone); 8 requests after convergence get step 2's own
    tokens.  Then step 3 is committed, polled verified, a byte of it
    flipped before the load, and its rollout aborts with ``rollout_error``
    while the fleet stays at 2.  Removes the directory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.serving import CheckpointWatcher, PagedModelExecutor, RequestState, ServingEngine, ServingFleet
    from tpu_nexus_torch.workload.faults import flip_committed_leaf
    from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

    torch.cuda.empty_cache()
    model = dataclasses.replace(LlamaConfig.nexus_1b(), n_layers=CKPT_LAYERS)  # its commits and restores: depth
    prompt_len, new, page, slots = 128, 32, 32, 4
    directory = tempfile.mkdtemp(prefix="nexus-rollout-")
    try:
        ckpt = TensorCheckpointer(directory)
        seconds = {}

        def commit(step):
            p = llama_init(torch.Generator(device="cuda").manual_seed(step), model, device="cuda")
            t0 = time.perf_counter()
            ckpt.save(step, {"params": p, "step": torch.tensor(step, dtype=torch.int32)})
            ckpt.commit(step)
            seconds[f"save_commit_{step}"] = time.perf_counter() - t0
            return p

        def engine(params):
            return ServingEngine(PagedModelExecutor(params, model, num_slots=slots, max_len=prompt_len + new,
                                                    page_size=page))

        def own(params, rows):
            eng = engine(params)
            reqs = [eng.submit(p, new) for p in rows]
            eng.run_until_drained()
            return [list(r.output_tokens) for r in reqs]

        rng = np.random.default_rng(3)
        prompts = rng.integers(0, model.vocab_size, size=(32, prompt_len)).astype(np.int32)
        p1 = commit(1)
        t0 = time.perf_counter()
        serving = TensorCheckpointer(directory).restore_params(1)
        seconds["restore_1"] = time.perf_counter() - t0
        fleet = ServingFleet()
        for i in range(3):
            fleet.add_replica(f"rep-{i}", engine(serving), step=1)
        watcher = CheckpointWatcher(directory, interval_s=0.5)
        _zero_serving_counts()
        torch_sync()
        t_start = time.perf_counter()
        reqs = [fleet.submit(p, new, request_id=f"roll-{i}") for i, p in enumerate(prompts[:24])]
        fleet.tick()
        fleet.tick()
        p2 = commit(2)
        in_flight_at_commit = sum(rep.engine.in_flight for rep in fleet.replicas.values())
        t_roll = None
        ticks = 0
        while fleet.has_work or fleet.rollout_active or not fleet.converged(2):
            step = watcher.check()
            if step is not None and step > max(fleet.deployed_steps().values()) and not fleet.rollout_active:
                fleet.start_rollout(ckpt, step, grace_s=120.0)
                t_roll = time.perf_counter()
            fleet.tick()
            ticks += 1
            if ticks > 20_000:
                raise AssertionError(f"rollout did not converge: {fleet.summary()}")
        torch_sync()
        roll_wall = time.perf_counter() - t_start
        seconds["rollout"] = time.perf_counter() - t_roll
        post = [fleet.submit(p, new, request_id=f"post-{i}") for i, p in enumerate(prompts[24:])]
        fleet.run_until_drained()
        counts = _serving_counts(results, "fleet_rollout")
        own1, own2 = own(p1, prompts[:24]), own(p2, prompts)
        on_step = [1 if list(r.output_tokens) == own1[i] else 2 if list(r.output_tokens) == own2[i] else None
                   for i, r in enumerate(reqs)]
        post_ok = [list(r.output_tokens) for r in post] == own2[24:]
        states = [r.state for r in reqs + post]
        converged = fleet.converged(2)
        # a candidate that rots between the poll and the load
        commit(3)
        polled = None
        while polled is None:
            polled = watcher.check()
        flip_committed_leaf(os.path.join(directory, "3"))
        fleet.start_rollout(ckpt, polled, grace_s=120.0)
        fleet.run_until_drained()
        emit("fleet_rollout", config=f"nexus_1b full width and depth, bf16, 3 paged replicas (page {page}, "
             f"{slots} slots)", requests=len(states), finished=sum(s == RequestState.FINISHED for s in states),
             in_flight_at_commit=in_flight_at_commit, converged_to_2=converged,
             deployed_steps=fleet.deployed_steps(), rollouts_completed=fleet.rollouts_completed,
             requests_on_step={s: on_step.count(s) for s in (1, 2, None)}, post_swap_tokens_are_step2s=post_ok,
             step3_polled=polled, rollout_error=fleet.rollout_error, seconds=seconds, ticks=ticks,
             wall_s=roll_wall, decoded_tokens_per_second=_finished_tokens(reqs) / roll_wall,
             decoded_tokens_per_second_without_the_commit=_finished_tokens(reqs) / (
                 roll_wall - seconds["save_commit_2"]), launches=counts)
        if not converged or states != [RequestState.FINISHED] * len(states) or None in on_step or not post_ok:
            raise AssertionError(f"rollout: converged {converged}, states {set(states)}, on step {on_step}, "
                                 f"post-swap tokens {post_ok}")
        if polled != 3 or not fleet.rollout_error or fleet.rollout_error[0] != 3 or not fleet.converged(2):
            raise AssertionError(f"corrupt candidate: polled {polled}, error {fleet.rollout_error}, "
                                 f"steps {fleet.deployed_steps()}")
        del fleet, serving, p1, p2
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()


# -- the fleet supervisor and the CQL ledger --------------------------------------

FS_NS = "nexus"
FS_ALGORITHM = "nexus-1b-serve"
#: the ledger's timestamp columns (``tpu_nexus_torch/checkpoint/schema.cql``)
CQL_TIMESTAMP_COLUMNS = ("received_at", "sent_at", "last_modified")


def _cql_split(text, sep):
    """Split a CQL fragment on ``sep`` outside quoted strings ('' escapes)
    and outside {}/[] nesting: the literal grammar of ``cql.to_literal``."""
    parts, depth, i, start, quoted, n, w = [], 0, 0, 0, False, len(text), len(sep)
    while i < n:
        ch = text[i]
        if quoted:
            if ch == "'":
                if i + 1 < n and text[i + 1] == "'":
                    i += 2
                    continue
                quoted = False
        elif ch == "'":
            quoted = True
        elif ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        elif depth == 0 and text[i:i + w] == sep:
            parts.append(text[start:i])
            start = i = i + w
            continue
        i += 1
    parts.append(text[start:])
    return [p.strip() for p in parts if p.strip()]


def _cql_literal(tok):
    tok = tok.strip()
    if tok == "null":
        return None
    if tok in ("true", "false"):
        return tok == "true"
    if tok.startswith("'"):
        return tok[1:-1].replace("''", "'")
    if tok.startswith("{"):
        return {_cql_literal(k): _cql_literal(v)
                for k, v in (_cql_split(pair, ":") for pair in _cql_split(tok[1:-1], ","))}
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def _cql_pairs(clause, sep):
    return {k.strip(): _cql_literal(v) for k, v in (_cql_split(part, "=") for part in _cql_split(clause, sep))}


class CqlResponder:
    """A CQL native-protocol v4 responder for the run ledger on 127.0.0.1,
    one thread a connection, built on the port's frame helpers
    (``tpu_nexus_torch/checkpoint/cql.py``).  It holds ``nexus.checkpoints``
    rows in a dict and answers the statements ``CqlCheckpointStore`` sends:
    SELECT by key or by an indexed column, INSERT (a per-cell upsert),
    UPDATE with a map append, UPDATE as an upsert, and the lightweight
    transaction (``IF EXISTS`` / ``IF col = v``) with an honest
    ``[applied]``, all under one lock.  Rows go back typed as the schema
    types them (text, int, timestamp, map<text, bigint>).  Counts the frames
    it answers (``round_trips``)."""

    def __init__(self):
        from tpu_nexus_torch.checkpoint import cql

        self.cql = cql
        self.rows = {}
        self.lock = threading.Lock()
        self.round_trips = 0
        self.statements = {}
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._conns, self._threads = [], []
        self._closed = threading.Event()
        self._start(self._accept)

    def _start(self, target, *args):
        thread = threading.Thread(target=target, args=args, daemon=True)
        self._threads.append(thread)
        thread.start()

    def close(self):
        self._closed.set()
        self._listener.close()
        for conn in list(self._conns):
            with contextlib.suppress(OSError):
                conn.shutdown(socket.SHUT_RDWR)
            conn.close()
        for thread in self._threads:
            thread.join(timeout=5)

    def _accept(self):
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            self._start(self._serve, conn)

    @staticmethod
    def _recv(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve(self, conn):
        cql = self.cql
        with contextlib.suppress(OSError):
            while True:
                header = self._recv(conn, 9)
                if header is None:
                    return
                _, _, stream, opcode, length = struct.unpack(">BBhBi", header)
                body = self._recv(conn, length) if length else b""
                if opcode == cql.OP_STARTUP:
                    reply = cql.encode_frame(cql.OP_READY, b"", stream=stream, response=True)
                elif opcode == cql.OP_QUERY:
                    text = body[4:4 + struct.unpack(">i", body[:4])[0]].decode()
                    reply = cql.encode_frame(cql.OP_RESULT, self._handle(text), stream=stream, response=True)
                else:
                    reply = cql.encode_frame(cql.OP_ERROR, cql.write_int(0x000A) + cql.write_string(
                        f"opcode {opcode:#x} not served"), stream=stream, response=True)
                with self.lock:
                    self.round_trips += 1
                conn.sendall(reply)

    def _handle(self, text):
        kind = text.split(" ", 1)[0]
        with self.lock:
            self.statements[kind] = self.statements.get(kind, 0) + 1
            if kind == "SELECT":
                m = re.match(r"SELECT (.+) FROM \S+ WHERE (.+)$", text)
                cols = [c.strip() for c in m.group(1).split(",")]
                where = _cql_pairs(m.group(2), " AND ")
                hits = [row for row in self.rows.values() if all(row.get(k) == v for k, v in where.items())]
                return self._rows(cols, hits)
            if kind == "INSERT":
                m = re.match(r"INSERT INTO \S+ \((.+?)\) VALUES \((.+)\)$", text)
                row = dict(zip([c.strip() for c in m.group(1).split(",")],
                               [_cql_literal(t) for t in _cql_split(m.group(2), ",")]))
                self.rows.setdefault((row["algorithm"], row["id"]), {}).update(row)
                return self.cql.write_int(self.cql.RESULT_VOID)
            if kind == "UPDATE":
                return self._update(text)
            return self.cql.write_int(self.cql.RESULT_VOID)

    def _update(self, text):
        cql = self.cql
        m = re.match(r"UPDATE \S+ SET (.+?) WHERE (.+?)(?: IF (.+))?$", text)
        sets, where, cond = m.group(1), _cql_pairs(m.group(2), " AND "), m.group(3)
        key = (where["algorithm"], where["id"])
        row = self.rows.get(key)
        append = re.match(r"per_chip_steps = per_chip_steps \+ (.+)$", sets)
        if cond is None:
            # a CQL UPDATE is an upsert: the row appears if it was missing
            row = self.rows.setdefault(key, dict(where))
            if append:
                row["per_chip_steps"] = {**(row.get("per_chip_steps") or {}), **_cql_literal(append.group(1))}
            else:
                row.update(_cql_pairs(sets, ","))
            return cql.write_int(cql.RESULT_VOID)
        applies = row is not None and (cond.strip() == "EXISTS" or all(
            row.get(k) == v for k, v in _cql_pairs(cond, " AND ").items()))
        if applies:
            row.update(_cql_pairs(sets, ","))
        return self._rows(["[applied]"], [{"[applied]": applies}])

    def _rows(self, cols, rows):
        from datetime import datetime, timezone

        cql = self.cql
        types = {c: ((cql.TYPE_BOOLEAN, None) if c == "[applied]" else
                     (cql.TYPE_INT, None) if c in ("restart_count", "max_restarts") else
                     (cql.TYPE_MAP, (cql.TYPE_VARCHAR, cql.TYPE_BIGINT)) if c == "per_chip_steps" else
                     (cql.TYPE_TIMESTAMP, None) if c in CQL_TIMESTAMP_COLUMNS else
                     (cql.TYPE_VARCHAR, None)) for c in cols}
        body = cql.write_int(cql.RESULT_ROWS) + cql.write_int(0x0001) + cql.write_int(len(cols))
        body += cql.write_string("nexus") + cql.write_string("checkpoints")
        for c in cols:
            type_id, param = types[c]
            body += cql.write_string(c) + cql.write_short(type_id)
            if param is not None:
                body += cql.write_short(param[0]) + cql.write_short(param[1])
        body += cql.write_int(len(rows))
        for row in rows:
            for c in cols:
                value, (type_id, _) = row.get(c), types[c]
                if value is None:
                    cell = None
                elif type_id == cql.TYPE_BOOLEAN:
                    cell = b"\x01" if value else b"\x00"
                elif type_id == cql.TYPE_INT:
                    cell = struct.pack(">i", int(value))
                elif type_id == cql.TYPE_MAP:
                    cell = cql.write_int(len(value)) + b"".join(
                        cql.write_bytes(str(k).encode()) + cql.write_bytes(struct.pack(">q", int(v)))
                        for k, v in sorted(value.items()))
                elif type_id == cql.TYPE_TIMESTAMP:
                    at = datetime.strptime(value, "%Y-%m-%dT%H:%M:%S.%fZ").replace(tzinfo=timezone.utc)
                    cell = struct.pack(">q", round(at.timestamp() * 1000))
                else:
                    cell = str(value).encode()
                body += cql.write_bytes(cell)
        return body


def _serving_jobset(name, replicas, kv_blocks):
    """A serving JobSet manifest (``nexus-component: serving-fleet``) with
    ``replicas`` one-pod replicated jobs whose container env carries
    ``NEXUS_KV_BLOCKS``."""
    from tpu_nexus_torch.checkpoint.models import (
        JOB_LABEL_SERVING_FLEET,
        JOB_TEMPLATE_NAME_KEY,
        NEXUS_COMPONENT_LABEL,
    )

    env = [{"name": "NEXUS_KV_BLOCKS", "value": str(kv_blocks)}]
    return {
        "kind": "JobSet", "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "metadata": {"name": name, "namespace": FS_NS, "uid": f"js-{name}",
                     "labels": {NEXUS_COMPONENT_LABEL: JOB_LABEL_SERVING_FLEET,
                                JOB_TEMPLATE_NAME_KEY: FS_ALGORITHM}},
        "spec": {"replicatedJobs": [{"name": "replica", "replicas": replicas, "template": {"spec": {
            "parallelism": 1, "template": {"spec": {"containers": [{"name": "serve", "env": env}]}}}}}]},
        "status": {},
    }


async def _fleet_supervisor(results, responder):
    import asyncio
    import statistics
    from datetime import timedelta

    import numpy as np
    import torch

    from tpu_nexus_torch.checkpoint.cql import ScyllaCqlStore
    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
    from tpu_nexus_torch.serving import (
        CAUSE_REPLICA_LOST,
        PRESSURE_PRESSURED,
        PRESSURE_SATURATED,
        AutoscaleConfig,
        PagedModelExecutor,
        QueueFull,
        RequestState,
        ServingEngine,
        SloMonitor,
    )
    from tpu_nexus_torch.supervisor.taxonomy import MSG_HBM_OOM, MSG_PREEMPTED, DecisionAction, classify_tpu_failure
    from tpu_nexus_torch.workload.serve import ServeConfig, build_fleet_supervisor

    model = LlamaConfig.nexus_1b()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0), model, device="cuda")
    page, slots, prompt_len, new = 32, 32, 128, 32
    max_len = prompt_len + new
    full_kv = 1 + slots * -(-max_len // page)
    rng = np.random.default_rng(16)

    def prompts(n):
        return list(rng.integers(0, model.vocab_size, size=(n, prompt_len)).astype(np.int32))

    def engine(kv_blocks=None):
        return ServingEngine(PagedModelExecutor(params, model, num_slots=slots, max_len=max_len, page_size=page,
                                                num_blocks=kv_blocks or 0))

    made = []

    def factory(name, step, kv_blocks):
        made.append((name, step, kv_blocks))
        return engine(kv_blocks)

    # every ledger statement crosses the wire to the responder; each is timed
    store = ScyllaCqlStore(hosts=["127.0.0.1"], port=responder.port)
    ledger_ms = []
    execute = store._execute

    def timed_execute(statement):
        t0 = time.perf_counter()
        try:
            return execute(statement)
        finally:
            ledger_ms.append((statement.split(" ", 1)[0], (time.perf_counter() - t0) * 1e3))

    store._execute = timed_execute
    reconcile_ms = []

    async def reconcile(sup, now):
        t0 = time.perf_counter()
        await sup.reconcile(now=now)
        reconcile_ms.append((time.perf_counter() - t0) * 1e3)

    async def start(jobset, env):
        """The fleet and its supervisor as a deployment's env configures
        them (``build_fleet_supervisor`` reads the router policy, SLO
        targets, autoscale bounds and KV budget from ``ServeConfig``)."""
        client = FakeKubeClient(jobset_controller=True, emit_pod_events=True)
        client.inject("ADDED", "JobSet", _serving_jobset(jobset, 3, full_kv))
        cfg = ServeConfig.from_env({"NEXUS_PAGE_SIZE": str(page), "NEXUS_KV_BLOCKS": str(full_kv), **env})
        sup = build_fleet_supervisor(cfg, client, store, FS_NS, jobset, FS_ALGORITHM, factory, grace_s=30.0,
                                     resync_period=timedelta(0))
        fleet = sup.fleet
        ctx = LifecycleContext()
        sup._factory.start(ctx)
        if not await sup._factory.wait_for_cache_sync(timeout=30.0):
            raise AssertionError(f"fleet_supervisor {jobset}: the informers did not sync")
        pods = await sup.adopt_pods(step=0)
        if len(pods) != 3:
            raise AssertionError(f"fleet_supervisor {jobset}: adopted {pods}")
        return client, fleet, sup, ctx, pods

    async def settle(sup):
        for _ in range(250):
            if sup._pending:
                return
            await asyncio.sleep(0.02)
        raise AssertionError("fleet_supervisor: no incident reached the supervisor in 5 s")

    def first_token(eng, req):
        """Step ``eng`` until ``req`` has its first token."""
        while not req.output_tokens and not req.is_terminal():
            eng.step()
        torch_sync()
        return time.perf_counter()

    def routed_first_token(fleet, name, prompt, request_id):
        """Submit ``prompt`` through the fleet's router, which must land it on
        ``name``, and tick the whole fleet (every replica steps) until it has
        its first token; returns ``(request, seconds on the clock)``."""
        req = fleet.submit(prompt, new, request_id=request_id)
        if request_id not in fleet.replicas[name].engine.requests:
            raise AssertionError(f"fleet_supervisor: the router sent {request_id} past {name}")
        while not req.output_tokens and not req.is_terminal():
            fleet.tick()
        torch_sync()
        return req, time.perf_counter()

    def row(jobset):
        return store.read_checkpoint(FS_ALGORITHM, jobset)

    # warm-up outside the counts: one prefill and decode of each engine shape
    warm = engine()
    warm.submit(prompts(1)[0], 2, request_id="warm")
    warm.run_until_drained()
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replays = []  # (label, kv_blocks, [(request, prompt)], probe first) to hold against engines alone
    out = {}
    _zero_serving_counts()

    # (a) a pod deleted mid-traffic
    js = "nexus-1b-serve"
    client, fleet, sup, ctx, pods = await start(js, {})
    await reconcile(sup, 1.0)
    burst = prompts(24)
    reqs = [fleet.submit(p, new, request_id=f"a-{i}") for i, p in enumerate(burst)]
    fleet.tick()
    fleet.tick()
    victim = max(pods, key=lambda n: len(fleet.replicas[n].engine.requests))
    held = len(fleet.replicas[victim].engine.requests)
    t_del = time.perf_counter()
    await client.delete_object("Pod", FS_NS, victim)
    await settle(sup)
    await reconcile(sup, 2.0)
    uid = client._objects["Pod"][(FS_NS, victim)]["metadata"]["uid"]
    if sup.recreated != 1 or fleet.replicas[victim].state != "serving" or not uid.startswith("fleet-recreate-"):
        raise AssertionError(f"fleet_supervisor a: recreated {sup.recreated}, {fleet.replicas[victim].state}, {uid}")
    probe_prompt = prompts(1)[0]
    probe, t_first = routed_first_token(fleet, victim, probe_prompt, "a-probe")
    delete_to_first_token = t_first - t_del
    fleet.run_until_drained()
    lost = f"{CAUSE_REPLICA_LOST}:{DecisionAction.TO_PREEMPT_RESTARTABLE}"
    casualties = [r for r in reqs if r.state != RequestState.FINISHED]
    silent = [r.request_id for r in reqs if not r.is_terminal() or (r.state != RequestState.FINISHED
                                                                     and r.cause != lost)]
    post = prompts(6)
    post_reqs = [fleet.submit(p, new, request_id=f"a-post-{i}") for i, p in enumerate(post)]
    fleet.run_until_drained()
    on = {r.request_id: name for name, rep in fleet.replicas.items() for r in rep.all_retired()}
    replays.append(("a_probe", full_kv, [(probe, probe_prompt)], False))
    for name in pods:
        mine = [(r, p) for r, p in zip(post_reqs, post) if on.get(r.request_id) == name]
        if mine:
            replays.append((f"a_post_{name}", full_kv, mine, False))
    ledger_a = row(js)
    out["a"] = dict(victim=victim, live_on_victim=held, casualties=len(casualties), silently_dropped=len(silent),
                    recreated=sup.recreated, replacement_uid=uid, delete_to_first_token_s=delete_to_first_token,
                    post_landed={n: sum(on.get(r.request_id) == n for r in post_reqs) for n in pods},
                    ledger_stage=ledger_a.lifecycle_stage, ledger_cause=ledger_a.algorithm_failure_cause)
    emit("fleet_supervisor", drill="a_pod_deleted", **out["a"])
    if (not held or len(casualties) != held or silent or probe.state != RequestState.FINISHED
            or any(r.state != RequestState.FINISHED for r in post_reqs) or not out["a"]["post_landed"][victim]
            or ledger_a.lifecycle_stage != LifecycleStage.RUNNING or ledger_a.algorithm_failure_cause != MSG_PREEMPTED
            or victim not in ledger_a.algorithm_failure_details):
        raise AssertionError(f"fleet_supervisor a: {out['a']}, ledger {ledger_a}")

    # (b) a real CUDA out-of-memory in a pod's termination message
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    except torch.OutOfMemoryError as exc:
        oom_text = str(exc)
    else:
        raise AssertionError("fleet_supervisor b: twice the card's memory was allocated")
    target = next(n for n in pods if n != victim)
    oom_class = classify_tpu_failure(oom_text)
    client.fail_pod(FS_NS, target, message=oom_text, exit_code=137)
    await settle(sup)
    await reconcile(sup, 3.0)
    rep = fleet.replicas[target]
    env = client._objects["Pod"][(FS_NS, target)]["spec"]["containers"][0]["env"]
    halved = full_kv // 2
    serve_b = prompts(20)
    reqs_b = [rep.engine.submit(p, new, request_id=f"b-{i}") for i, p in enumerate(serve_b)]
    most_live = 0
    while fleet.has_work:
        fleet.tick()
        most_live = max(most_live, rep.engine.in_flight)
    replays.append(("b_halved_pool", halved, list(zip(reqs_b, serve_b)), False))
    ledger_b = row(js)
    out["b"] = dict(pod=target, oom_text=oom_text[:160], oom_class=oom_class, recreated=sup.recreated,
                    factory_call=made[-1], pod_env=env, num_blocks=rep.engine.executor.num_blocks,
                    most_in_flight=most_live, finished=sum(r.state == RequestState.FINISHED for r in reqs_b),
                    ledger_cause=ledger_b.algorithm_failure_cause)
    emit("fleet_supervisor", drill="b_hbm_oom", **out["b"])
    if (oom_class != DecisionAction.TO_FAIL_HBM_OOM or sup.recreated != 2 or made[-1] != (target, 0, halved)
            or {"name": "NEXUS_KV_BLOCKS", "value": str(halved)} not in env or rep.engine.executor.num_blocks != halved
            or out["b"]["finished"] != len(reqs_b) or most_live > (halved - 1) // -(-max_len // page)
            or ledger_b.algorithm_failure_cause != MSG_HBM_OOM):
        raise AssertionError(f"fleet_supervisor b: {out['b']}")
    ctx.cancel()
    await sup._factory.shutdown()
    del fleet, sup, rep
    torch.cuda.empty_cache()

    # (c) autoscale: a paused replica sheds -> SATURATED -> scale up; idle -> down
    js_c = "nexus-1b-autoscale"
    client, fleet, sup, ctx, pods = await start(js_c, {
        "NEXUS_SLO_SHED_RATE": "0.05", "NEXUS_SLO_SHORT_N": "1", "NEXUS_SLO_LONG_N": "3", "NEXUS_AUTOSCALE_MIN": "3",
        "NEXUS_AUTOSCALE_MAX": "4", "NEXUS_SCALE_UP_N": "1", "NEXUS_SCALE_DOWN_N": "2", "NEXUS_SCALE_COOLDOWN_S": "0"})
    if sup.autoscale != AutoscaleConfig(3, 4, 1, 2, 0.0) or sup.slo is None or fleet.router.slo is not sup.slo:
        raise AssertionError(f"fleet_supervisor c: the env did not configure the supervisor: {sup.autoscale}")
    reqs_c = [fleet.submit(p, new, request_id=f"c-{i}") for i, p in enumerate(prompts(3))]
    await reconcile(sup, 1.0)
    overloaded = fleet.replicas[pods[0]].engine
    overloaded.pause_admission()
    grades = []
    for t in (2.0, 3.0):
        try:
            overloaded.submit(prompts(1)[0], new)
        except QueueFull:
            pass
        else:
            raise AssertionError("fleet_supervisor c: a paused replica took a request")
        t_scale = time.perf_counter()
        await reconcile(sup, t)
        grades.append(dict(sup.slo.grades))
    scaled = f"{js_c}-scale-1"
    if (sup.scaled_up != 1 or len(fleet.replicas) != 4 or scaled not in fleet.replicas
            or grades[0].get(pods[0]) != PRESSURE_PRESSURED or grades[1].get(SloMonitor.FLEET) != PRESSURE_SATURATED):
        raise AssertionError(f"fleet_supervisor c: scaled_up {sup.scaled_up}, replicas {list(fleet.replicas)}, "
                             f"grades {grades}")
    up_cause = row(js_c).algorithm_failure_cause
    grown = fleet.replicas[scaled].engine
    probe_c_prompt = prompts(1)[0]
    probe_c, t_first = routed_first_token(fleet, scaled, probe_c_prompt, "c-probe")
    scale_up_to_first_token = t_first - t_scale
    serve_c = prompts(6)
    reqs_new = [grown.submit(p, new, request_id=f"c-new-{i}") for i, p in enumerate(serve_c)]
    overloaded.resume_admission()
    fleet.run_until_drained()
    replays.append(("c_scaled_replica", full_kv, [(probe_c, probe_c_prompt)] + list(zip(reqs_new, serve_c)), True))
    now = 3.0
    while sup.scaled_down == 0 and now < 12.0:
        now += 1.0
        await reconcile(sup, now)
    down = sup.scale_events[-1]
    down_cause = row(js_c).algorithm_failure_cause
    everything = reqs_c + [probe_c] + reqs_new
    out["c"] = dict(scaled_up=sup.scaled_up, scaled_down=sup.scaled_down, scaled_pod=scaled,
                    scale_up_to_first_token_s=scale_up_to_first_token, grades=grades, down=down,
                    replicas_after=sorted(fleet.replicas), reconciles_to_scale_down=int(now - 3.0),
                    finished=sum(r.state == RequestState.FINISHED for r in everything), requests=len(everything),
                    ledger_up_cause=up_cause, ledger_down_cause=down_cause)
    emit("fleet_supervisor", drill="c_autoscale", **out["c"])
    if (sup.scaled_down != 1 or len(fleet.replicas) != 3 or down["drain"]["drain_evicted"] != 0
            or out["c"]["finished"] != len(everything) or "fleet autoscale: scale-up" not in up_cause
            or "fleet autoscale: scale-down" not in down_cause or sup.recreated != 0):
        raise AssertionError(f"fleet_supervisor c: {out['c']}")
    ctx.cancel()
    await sup._factory.shutdown()
    del fleet, sup, overloaded, grown
    counts = _serving_counts(results, "fleet_supervisor")
    peak = torch.cuda.max_memory_allocated()
    if not counts["flash_attention"] or not counts["decode_attention_paged"]:
        raise AssertionError(f"fleet_supervisor: a kernel of the path was not launched: {counts}")

    # every replica's requests against an engine of its geometry given the
    # same requests in the same order (after the counts: not the main path)
    mismatched = {}
    for label, kv_blocks, pairs, probe_first in replays:
        alone = engine(kv_blocks)
        got = []
        for i, (req, prompt) in enumerate(pairs):
            got.append(alone.submit(prompt, new, request_id=req.request_id))
            if probe_first and i == 0:
                first_token(alone, got[0])
        alone.run_until_drained()
        bad = [r.request_id for (r, _), g in zip(pairs, got) if list(r.output_tokens) != list(g.output_tokens)]
        if bad:
            mismatched[label] = bad
        del alone
    store.close()
    writes = [ms for kind, ms in ledger_ms if kind != "SELECT"]
    reads = [ms for kind, ms in ledger_ms if kind == "SELECT"]
    out.update(counts=counts, peak=peak, mismatched=mismatched,
               reconcile_ms=dict(p50=statistics.median(reconcile_ms), max=max(reconcile_ms), n=len(reconcile_ms)),
               ledger_write_ms=dict(mean=statistics.fmean(writes), p50=statistics.median(writes), max=max(writes),
                                    n=len(writes)),
               ledger_read_ms=dict(mean=statistics.fmean(reads), p50=statistics.median(reads), n=len(reads)),
               round_trips=responder.round_trips, statements=dict(responder.statements))
    emit("fleet_supervisor", run="replays", replays=len(replays), token_identical_to_engine_alone=not mismatched,
         mismatched=mismatched)
    if mismatched:
        raise AssertionError(f"fleet_supervisor: tokens differ from an engine alone: {mismatched}")
    return out


def phase_fleet_supervisor(results):
    """``FleetSupervisor`` reconciling real nexus_1b replicas on the card
    (full width and depth, bf16, paged: page 32, 32 slots, one seeded
    params tree shared), over ``FakeKubeClient(jobset_controller=True,
    emit_pod_events=True)`` seeded with a 3-replica serving JobSet, fleet
    and supervisor built by ``build_fleet_supervisor`` from a
    ``ServeConfig`` env, the ledger the port's ``ScyllaCqlStore`` against ``CqlResponder`` (every
    write crosses the CQL wire).  (a) 24 requests, then the pod holding the
    most live requests is deleted: each casualty ends FAILED with the
    replica-lost cause, the pod is recreated under its name, requests after
    it FINISH, the row carries the preemption cause.  (b) a real
    ``torch.OutOfMemoryError`` (twice the card's memory) in a pod's
    termination message: classified HBM OOM, the pod recreated with
    ``NEXUS_KV_BLOCKS`` halved (161 -> 80), 20 requests served through the
    smaller pool (at most 15 in flight).  (c) a second fleet whose env
    sets a shed-rate SLO and autoscale bounds 3 and 4: a paused replica's sheds grade it
    PRESSURED then the fleet SATURATED, the fleet scales to 4, the new
    replica serves, and once idle it scales back to 3 with nothing
    evicted; the row carries both decisions.  Every replica's requests
    equal an engine of its geometry given them alone.  Then one line of
    numbers: reconcile ms, seconds from the deletion (and from the scale-up
    decision) to the first token of a request the router sends to the new
    pod while every replica of the fleet ticks, ledger ms a write, #1 and #4-paged launches, peak memory, the card."""
    import asyncio

    import torch

    torch.cuda.empty_cache()
    responder = CqlResponder()
    try:
        out = asyncio.run(_fleet_supervisor(results, responder))
    finally:
        responder.close()
    emit("fleet_supervisor_numbers", nvidia_smi=nvidia_smi(),
         config="nexus_1b full width and depth, bf16, 3 paged replicas (page 32, 32 slots, 161 KV blocks)",
         reconcile_ms=out["reconcile_ms"], delete_to_first_token_s=out["a"]["delete_to_first_token_s"],
         scale_up_to_first_token_s=out["c"]["scale_up_to_first_token_s"], ledger_write_ms=out["ledger_write_ms"],
         ledger_read_ms=out["ledger_read_ms"], ledger_round_trips=out["round_trips"],
         ledger_statements=out["statements"], launches=out["counts"], peak_device_memory_bytes=out["peak"])
    results["fleet_supervisor"] = out


def phase_cql_ledger(results):
    """One workload container on the reference's default ledger: ``python
    -m tpu_nexus_torch.workload`` as a subprocess, ``NEXUS_MODE=serve-engine``,
    nexus_1b (bf16, 8 slots, 16 requests), with NO ``NEXUS__CQL_STORE_TYPE``
    — ``appconfig.yaml``'s ``cql-store-type: scylla`` applies — and
    ``NEXUS__SCYLLA_CQL_STORE__HOSTS``/``__PORT`` pointed at
    ``CqlResponder``.  It exits 0; its row, read back through the port's
    ``ScyllaCqlStore``, is COMPLETED with heartbeats; its wall seconds and
    the ledger's round trips."""
    import tempfile
    import uuid

    import torch

    from tpu_nexus_torch.checkpoint.cql import ScyllaCqlStore
    from tpu_nexus_torch.checkpoint.models import LifecycleStage

    torch.cuda.empty_cache()
    responder = CqlResponder()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rid = str(uuid.uuid4())
            env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
            env.update(PYTHONPATH=str(ROOT), TMPDIR=tmp, NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET="nexus_1b",
                       NEXUS_BATCH="8", NEXUS_STEPS="2", NEXUS_PROMPT_LEN="128", NEXUS_GEN_TOKENS="32",
                       NEXUS_DEVICE="cuda", NEXUS_RUN_ID=rid, NEXUS_ALGORITHM=FS_ALGORITHM,
                       NEXUS__SCYLLA_CQL_STORE__HOSTS="127.0.0.1",
                       NEXUS__SCYLLA_CQL_STORE__PORT=str(responder.port))
            rc, _, stderr, _, t_spawn, t_exit = _cp_run_subprocess(
                [sys.executable, "-m", "tpu_nexus_torch.workload"], env, 600)
        round_trips = responder.round_trips
        statements = dict(responder.statements)
        store = ScyllaCqlStore(hosts=["127.0.0.1"], port=responder.port)
        try:
            row = store.read_checkpoint(FS_ALGORITHM, rid)
        finally:
            store.close()
    finally:
        responder.close()
    info = dict(rc=rc, wall_s=t_exit - t_spawn, ledger_round_trips=round_trips, ledger_statements=statements,
                stage=row.lifecycle_stage if row else None, heartbeats=row.per_chip_steps if row else None,
                finished=_cp_summary_number(stderr, "finished"),
                decoded_tokens_per_second=_cp_summary_number(stderr, "decoded_tokens_per_second"),
                nvidia_smi=nvidia_smi())
    emit("cql_ledger", **info)
    if (rc != 0 or row is None or row.lifecycle_stage != LifecycleStage.COMPLETED or not row.per_chip_steps
            or info["finished"] != 16 or not round_trips):
        raise AssertionError(f"cql_ledger: {info}, row {row}\n{stderr[-3000:]}")
    results["cql_ledger"] = info


# -- serve_sharded: one serve-engine replica across tensor/expert-parallel ranks

#: one rank's decode-step products of llama3_8b at tp 2 (times key, M, K, N):
#: wq, wk/wv, gate/up column-parallel (N halved), wo and w_down row-parallel
#: (K halved)
SHARDED_QUANT_SHAPES = (("wq", 8, 4096, 2048), ("wk", 8, 4096, 512), ("gate", 8, 4096, 7168),
                        ("wo", 8, 2048, 4096), ("down", 8, 7168, 4096))
#: the phase's device, models, prompt length and container preset (module
#: constants, so a dry run of the parts can swap in small ones)
SHARDED_DEVICE = "cuda:0"
SHARDED_PROMPT = 128
SHARDED_INT4_GROUP = 64


def _llama3_8b(n_layers=32):
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama3_8b(), param_dtype=torch.bfloat16, n_layers=n_layers)


def _nexus_1b_f32():
    """nexus_1b at full width, 4 of its 14 layers (depth cut for the phase's
    time), f32 compute over its bf16 params."""
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.nexus_1b(), dtype=torch.float32, n_layers=4)


def _nexus_moe():
    from tpu_nexus_torch.models.moe import MoeConfig

    return MoeConfig.nexus_moe()


SHARDED_MODELS = {"llama3_8b": _llama3_8b, "llama3_8b_8_layers": lambda: _llama3_8b(8),
                  "nexus_1b_f32": _nexus_1b_f32, "nexus_moe": _nexus_moe}


def _requests(vocab, n, prompt_len, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(0, vocab, size=(n, prompt_len)).astype(np.int32)


def _engine_tokens(executor, prompts, gen):
    """Every row of ``prompts`` through a ``ServingEngine`` on ``executor``:
    ``(tokens [N, gen], engine steps, seconds)``; every request must finish."""
    import numpy as np

    from tpu_nexus_torch.serving import RequestState, ServingEngine

    eng = ServingEngine(executor)
    reqs = [eng.submit(p, gen, request_id=f"r{i}") for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch_sync()
    secs = time.perf_counter() - t0
    states = sorted({r.state for r in reqs})
    if states != [RequestState.FINISHED]:
        raise AssertionError(f"requests ended {states}, not all FINISHED")
    return np.asarray([list(r.output_tokens) for r in reqs], np.int32), eng.steps, secs


def _forced(fn, prompts, tokens, batch=8):
    """Teacher-forced logits [N, T, V] (f32, host) of ``fn(prompts, tokens)``
    over batches of ``batch`` rows."""
    import numpy as np

    return np.concatenate([np.asarray(fn(prompts[i:i + batch], tokens[i:i + batch]), np.float32)
                           for i in range(0, len(prompts), batch)])


def _one_device_forced(params, model, kv_quant=""):
    import torch

    from tpu_nexus_torch.models.generate import teacher_forced_logits

    def fn(p, t):
        out = teacher_forced_logits(params, model, torch.from_numpy(p).to(SHARDED_DEVICE), torch.from_numpy(t).to(SHARDED_DEVICE),
                                    kv_quant=kv_quant)
        return out.float().cpu().numpy()

    return fn


#: how much farther from the f32 evaluation a sharded bf16 run may be than
#: the one-device bf16 run: two bf16 programs that sum in another order sit
#: ~2 % apart on llama3_8b's logits (worst row), each ~2 % from the f32
#: evaluation of the same weights (llama3_8b on an H100, part (a)), so the 1e-2
#: limit between them cannot hold; what must hold is that sharding adds
#: no error of its own
SHARDED_F32_MARGIN = 1.25


def _rel_rows(a, b):
    import numpy as np

    return np.linalg.norm(a - b, axis=-1) / np.maximum(np.linalg.norm(b, axis=-1), 1e-30)


def _against_f32(tp, one, truth, worst=True, floor=1e-5) -> dict:
    """Worst and median row distances (relative L2) of the sharded run to
    the one-device run and of both to the f32 evaluation; ``ok`` when the
    sharded run is within :data:`SHARDED_F32_MARGIN` of the one-device
    run's distance to the f32 evaluation (median, and with ``worst`` the
    worst row too), or within ``floor`` of it (1e-5: an f32 run; 1e-3 with
    an int8 KV cache, where a value within 1e-7 of a rounding edge lands
    one int8 step away when the sums round in another order)."""
    import numpy as np

    d = {name: _rel_rows(a, b) for name, (a, b) in
         (("tp_vs_one_device", (tp, one)), ("tp_vs_f32", (tp, truth)), ("one_device_vs_f32", (one, truth)))}
    row = {name: {"worst": float(v.max()), "median": float(np.median(v))} for name, v in d.items()}
    keys = ("median", "worst") if worst else ("median",)
    row["ok"] = all(row["tp_vs_f32"][k] <= max(SHARDED_F32_MARGIN * row["one_device_vs_f32"][k], floor)
                    for k in keys)
    return row


def _rank_launches(stats, names=("flash_attention", "decode_attention")):
    """Per rank: the counters named, #4 by mode and #5/#6 by route (non-zero)."""
    out = []
    for s in stats:
        row = {n: s["launches"][n] for n in names}
        row["decode_attention_by_mode"] = {m: n for m, n in s["launches"]["decode_attention_by_mode"].items() if n}
        row["quant_matmul_by_route"] = {m: n for m, n in s["launches"]["quant_matmul_by_route"].items() if n}
        out.append(row)
    return out


def _paged_launches(stats) -> int:
    return sum(n for s in stats for m, n in s["launches"]["decode_attention_by_mode"].items() if m.startswith("paged"))


def sharded_main_path(results, pool, out):
    """(a) llama3_8b bf16 at full width, 8 of its 32 layers, page 32, 8
    slots, 8 requests of prompt 128 and 32 new tokens: the one-device paged engine
    first (its tokens and teacher-forced logits kept on the host, and the
    logits of an f32 evaluation of the same weights along that stream), then
    ``run_serve_engine`` with ``serve_mesh="tp=2"`` on the pool's ranks
    (COMPLETED, per-rank launches and peak memory), then that replica,
    kept up by its pool, driven directly over the first 8 requests for 8
    tokens with the collectives timed: the share of greedy tokens equal to
    the one-device engine's, and each step's logits of those requests
    teacher-forced along the one-device stream, no farther from the f32
    evaluation than the one-device engine's."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.parallel import collectives
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.serving import PagedModelExecutor
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    model = SHARDED_MODELS["llama3_8b_8_layers"]()
    prompts, gen = _requests(model.vocab_size, 8, SHARDED_PROMPT, seed=17), 32
    params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(0), model, device=SHARDED_DEVICE)
    one = PagedModelExecutor(params, model, num_slots=8, max_len=SHARDED_PROMPT + 32,
                             page_size=32)
    one_tokens, one_steps, one_secs = _engine_tokens(one, prompts, gen)
    # the first round's logits along the one-device stream, and the f32
    # evaluation of the same bf16 weights: how far each bf16 run is from
    # what both round
    one_logits = _forced(_one_device_forced(params, model), prompts[:8], one_tokens[:8])
    truth = _forced(_one_device_forced(params, dataclasses.replace(model, dtype=torch.float32)), prompts[:8],
                    one_tokens[:8])
    del one, params
    torch.cuda.empty_cache()

    cfg = ServeConfig(model=model, batch_size=8, prompt_len=SHARDED_PROMPT, gen_tokens=gen, rounds=1, device=SHARDED_DEVICE,
                      page_size=32, serve_mesh="tp=2", rank_map="shared")
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="serve_sharded", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    pool.reset_counts()
    t0 = time.perf_counter()
    summary = run_serve_engine(cfg, store=store, ctx=ctx, prompts=iter([prompts[:8], prompts[:8]]), pool=pool)
    wall = time.perf_counter() - t0
    row = store.read_checkpoint("serve", "serve_sharded")
    stats = summary["shard_stats"]
    if row is None or row.lifecycle_stage != LifecycleStage.COMPLETED or summary["finished"] != 8:
        raise AssertionError(f"serve_sharded: row {row and row.lifecycle_stage}, {summary['finished']} of 8 finished")
    per_rank = _rank_launches(stats)
    for rank, counts in enumerate(per_rank):
        if counts["flash_attention"] < model.n_layers * 8 or not _paged_launches([stats[rank]]):
            raise AssertionError(f"serve_sharded: rank {rank} launched {counts}")
    results.setdefault("launches", {})["serve_sharded"] = {
        "flash_attention": sum(c["flash_attention"] for c in per_rank),
        "decode_attention_paged": _paged_launches(stats),
    }

    # the served replica (kept up: the pool is ours) over the first round
    # once more, driven directly for 8 tokens with the collectives timed
    # (each synchronizes the card first); then its logits teacher-forced
    # along the one-device stream
    sx = summary["replica"]
    collectives.STATS.reset()
    with collectives.STATS.timing():
        tp_tokens, timed_steps, tp_secs = _engine_tokens(sx, prompts[:8], 8)
    coll = collectives.STATS.to_dict()
    tp_logits = _forced(sx.teacher_forced_logits, prompts[:8], one_tokens[:8])
    sx.close()
    logits = _against_f32(tp_logits, one_logits, truth)
    del one_logits, tp_logits, truth
    per_step = {name: {"calls": n / timed_steps, "bytes": coll["bytes"][name] / timed_steps,
                       "ms": 1e3 * coll["seconds"].get(name, 0.0) / timed_steps} for name, n in coll["calls"].items()}
    out["a"] = dict(
        config="llama3_8b full width, 8 of 32 layers, bf16, page 32, 8 slots, 8 requests x (128 + 32)",
        stage=row.lifecycle_stage, finished=summary["finished"], wall_s=wall,
        decoded_tokens_per_second=summary["decoded_tokens_per_second"], tpot_p50_s=summary["tpot_p50_s"],
        ttft_p50_s=summary["ttft_p50_s"], engine_steps=summary["engine_steps"], launches_per_rank=per_rank,
        peak_memory_per_rank=[s["peak_memory"] for s in stats], weight_bytes=summary["load_snapshot"]["weight_bytes"],
        one_device=dict(steps=int(one_steps), seconds=one_secs, decoded_tokens_per_second=one_tokens.size / one_secs),
        timed_run=dict(requests=8, new_tokens=8, steps=int(timed_steps), seconds=tp_secs),
        greedy_tokens_equal_share=float((tp_tokens == one_tokens[:8, :8]).mean()),
        teacher_forced_rel_l2=logits,
        collectives_per_step=dict(timed_steps=int(timed_steps), **per_step),
    )
    emit("serve_sharded", part="a", **out["a"])
    if not logits["ok"]:
        raise AssertionError(f"serve_sharded (a): the sharded logits are farther from f32 than one device's: {logits}")


def sharded_exact(results, pool, out):
    """(b) nexus_1b at full width, 4 of 14 layers, f32 compute (bf16
    params), tp 2, contiguous and paged with int8 KV, 16 requests of prompt
    64 and 16 new tokens: greedy tokens identical to the one-device
    engine's."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.serving import ModelExecutor, PagedModelExecutor
    from tpu_nexus_torch.serving.sharded import SeedParams, ShardedModelExecutor, ShardedPagedModelExecutor

    model = SHARDED_MODELS["nexus_1b_f32"]()
    prompts = _requests(model.vocab_size, 16, 64, seed=18)
    out["b"] = {}
    for kind, kw in (("contiguous", {}), ("paged_int8kv", dict(page_size=32, kv_quant="int8"))):
        paged = "page_size" in kw
        params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(1), model, device=SHARDED_DEVICE)
        one = (PagedModelExecutor if paged else ModelExecutor)(params, model, num_slots=8, max_len=80, **kw)
        one_tokens = _engine_tokens(one, prompts, 16)[0]
        del one, params
        torch.cuda.empty_cache()
        sx = (ShardedPagedModelExecutor if paged else ShardedModelExecutor)(
            SeedParams(1), model, mesh=pool.mesh({"tp": 2}), num_slots=8, max_len=80, **kw)
        tp_tokens = _engine_tokens(sx, prompts, 16)[0]
        sx.close()
        same = float((tp_tokens == one_tokens).mean())
        out["b"][kind] = dict(tokens_identical=bool(same == 1.0), greedy_tokens_equal_share=same)
        if kind == "contiguous":
            out["b_old_tokens"] = one_tokens
    emit("serve_sharded", part="b", config="nexus_1b full width, 4 of 14 layers, f32 compute, tp 2, 16 x (64 + 16)",
         **out["b"])
    bad = [k for k, v in out["b"].items() if not v["tokens_identical"]]
    if bad:
        raise AssertionError(f"serve_sharded (b): tokens differ from the one-device engine's in {bad}")


def sharded_quantized(results, pool, out):
    """(c) llama3_8b at full width, 8 of its 32 layers (depth cut for the
    phase's time), int8 weights + int8 KV and int4 weights (group 64) at tp
    2: every rank's dequant-matmul launches on the ring kernel; the
    teacher-forced logits of 8 requests no farther from the f32 evaluation
    of the quantized weights than the one-device quantized engine's."""
    import torch

    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.serving import ModelExecutor
    from tpu_nexus_torch.serving.sharded import SeedParams, ShardedModelExecutor

    model = SHARDED_MODELS["llama3_8b_8_layers"]()
    prompts, gen = _requests(model.vocab_size, 8, SHARDED_PROMPT, seed=19), 16
    out["c"] = {}
    launches = results.setdefault("launches", {}).setdefault("serve_sharded", {})
    for mode, kvq, group in (("int8", "int8", 0), ("int4", "", SHARDED_INT4_GROUP)):
        kw = dict(num_slots=8, max_len=SHARDED_PROMPT + 16, quantize=mode, quant_group=group, kv_quant=kvq)
        params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(0), model, device=SHARDED_DEVICE)
        one = ModelExecutor(params, model, **kw)
        del params
        one_tokens = _engine_tokens(one, prompts, gen)[0]
        one_logits = _forced(_one_device_forced(one.params, model, kvq), prompts, one_tokens)
        truth = _forced(_one_device_forced(one.params, dataclasses.replace(model, dtype=torch.float32), kvq),
                        prompts, one_tokens)
        del one
        torch.cuda.empty_cache()
        pool.reset_counts()
        sx = ShardedModelExecutor(SeedParams(0), model, mesh=pool.mesh({"tp": 2}), **kw)
        tp_tokens = _engine_tokens(sx, prompts, gen)[0]
        stats = sx.shard_stats()
        tp_logits = _forced(sx.teacher_forced_logits, prompts, one_tokens)
        sx.close()
        per_rank = _rank_launches(stats, names=(f"quant_matmul_{mode}",))
        for rank, counts in enumerate(per_rank):
            routes = counts["quant_matmul_by_route"]
            if not routes.get(f"{mode}_ring") or routes.get(f"{mode}_first_design"):
                raise AssertionError(f"serve_sharded (c) {mode}: rank {rank} routes {routes}")
        launches[f"quant_matmul_{mode}"] = sum(c[f"quant_matmul_{mode}"] for c in per_rank)
        logits = _against_f32(tp_logits, one_logits, truth, floor=1e-3 if kvq else 1e-5)
        out["c"][mode] = dict(kv_quant=kvq or None, group=group or None, launches_per_rank=per_rank,
                              greedy_tokens_equal_share=float((tp_tokens == one_tokens).mean()),
                              teacher_forced_rel_l2=logits)
        if not logits["ok"]:
            raise AssertionError(f"serve_sharded (c) {mode}: the sharded logits are farther from f32: {logits}")
        del one_logits, tp_logits, truth

    emit("serve_sharded", part="c", config="llama3_8b full width, 8 of 32 layers, tp 2, 8 x (128 + 16)", **out["c"])


def sharded_rank_shape_parity(results, out):
    """(c) #5 and #6 at each rank's shapes (:data:`SHARDED_QUANT_SHAPES`)
    against their plain versions: the ring kernel, twice, bit-identical."""
    import torch

    from tpu_nexus_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    parity = {}
    for key, m, k, n in SHARDED_QUANT_SHAPES:
        for mode, group in (("int8", 0), ("int4", 64)):
            w = quant_weight(k, n, mode, group, seed=k + n)
            x = torch.randn((m, k), generator=torch.Generator(device=SHARDED_DEVICE).manual_seed(5), device=SHARDED_DEVICE).to(
                torch.bfloat16)
            before = dict(quant_matmul.launches_by_route)
            got, again = quant_matmul(x, w), quant_matmul(x, w)
            torch_sync()
            grew = {r: c - before[r] for r, c in quant_matmul.launches_by_route.items() if c != before[r]}
            ref = quant_matmul_plain(x, w)
            err = row_rel_err(got, ref)
            parity[f"{mode}_{key}"] = dict(shape=[m, k, n], route=grew, bit_identical=bool(torch.equal(got, again)),
                                           worst_row_rel_l2=err)
            if grew != {f"{mode}_ring": 2} or not torch.equal(got, again) or err > ROW_REL_TOL:
                raise AssertionError(f"serve_sharded (c): {mode} at {[m, k, n]}: {parity[f'{mode}_{key}']}")
    out.setdefault("c", {})["rank_shape_parity"] = parity
    emit("serve_sharded", part="c_parity", rank_shape_parity=parity)


def sharded_moe(results, pool, out):
    """(d) nexus_moe at full width and depth, bf16, at ep=2 (4 experts a
    rank) and at tp=2, against the one-device engine: tokens and the
    teacher-forced logits of 8 requests, beside the f32 evaluation.  Then
    tp=2 once more with f32 compute, where no bf16 routing flip can hide a
    fault: its greedy tokens equal the one-device f32 engine's and its
    teacher-forced logits the f32 evaluation's within 1e-5 (worst row)."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.moe import MoeConfig, moe_init
    from tpu_nexus_torch.serving import ModelExecutor
    from tpu_nexus_torch.serving.sharded import SeedParams, ShardedModelExecutor

    model = SHARDED_MODELS["nexus_moe"]()
    prompts, gen = _requests(model.vocab_size, 8, SHARDED_PROMPT, seed=20), 16
    params = moe_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(2), model, device=SHARDED_DEVICE)
    one = ModelExecutor(params, model, num_slots=8, max_len=SHARDED_PROMPT + 16)
    one_tokens = _engine_tokens(one, prompts, gen)[0]
    one_logits = _forced(_one_device_forced(params, model), prompts, one_tokens)
    model32 = dataclasses.replace(model, dtype=torch.float32)
    truth = _forced(_one_device_forced(params, model32), prompts, one_tokens)
    one32_tokens = _engine_tokens(ModelExecutor(params, model32, num_slots=8, max_len=SHARDED_PROMPT + 16),
                                  prompts, gen)[0]
    del one, params
    torch.cuda.empty_cache()
    out["d"] = {}
    for name, axes in (("ep2", {"ep": 2}), ("tp2", {"tp": 2})):
        sx = ShardedModelExecutor(SeedParams(2), model, mesh=pool.mesh(axes), num_slots=8,
                                  max_len=SHARDED_PROMPT + 16)
        tp_tokens = _engine_tokens(sx, prompts, gen)[0]
        tp_logits = _forced(sx.teacher_forced_logits, prompts, one_tokens)
        sx.close()
        # a bf16 routing flip moves a row's hidden state by tens of percent
        # in any two programs, so tp 2 is held on the median row; at ep 2
        # the combine adds exact zeros and the logits equal one device's
        logits = _against_f32(tp_logits, one_logits, truth, worst=(name == "ep2"))
        flips = _rel_rows(tp_logits, one_logits) > 0.1
        out["d"][name] = dict(greedy_tokens_equal_share=float((tp_tokens == one_tokens).mean()),
                              logits_equal=bool(np.array_equal(tp_logits, one_logits)),
                              rows_over_10_percent=int(flips.sum()), rows=int(flips.size),
                              teacher_forced_rel_l2=logits)
    sx = ShardedModelExecutor(SeedParams(2), model32, mesh=pool.mesh({"tp": 2}), num_slots=8,
                              max_len=SHARDED_PROMPT + 16)
    tp32_tokens = _engine_tokens(sx, prompts, gen)[0]
    tp32_rows = _rel_rows(_forced(sx.teacher_forced_logits, prompts, one_tokens), truth)
    sx.close()
    out["d"]["tp2_f32"] = dict(tokens_identical=bool(np.array_equal(tp32_tokens, one32_tokens)),
                               teacher_forced_rel_l2={"worst": float(tp32_rows.max()),
                                                      "median": float(np.median(tp32_rows))})
    emit("serve_sharded", part="d", config="nexus_moe full width and depth, bf16 (and f32 compute at tp2), "
         "8 x (128 + 16)", **out["d"])
    bad = {k: v for k, v in out["d"].items() if k != "tp2_f32" and not v["teacher_forced_rel_l2"]["ok"]}
    f32 = out["d"]["tp2_f32"]
    if bad or not out["d"]["ep2"]["logits_equal"] or not f32["tokens_identical"] \
            or f32["teacher_forced_rel_l2"]["worst"] > 1e-5:
        raise AssertionError(f"serve_sharded (d): {out['d']}")


def sharded_swap_and_fleet(results, pool, out, tmp):
    """(e) nexus_1b (4 layers, f32 compute, bf16 params) at tp 2: a replica swaps to
    a committed step through ``params_ref`` mid-traffic (in-flight requests
    finish on the old weights' tokens, a straddler and a later request on
    the new weights'); then a fleet of two tp-2 replicas (ranks 0+1 and
    0+2) rolls 1 -> 2 with every request FINISHED."""
    import torch

    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.serving import ModelExecutor, RequestState, ServingEngine, ServingFleet
    from tpu_nexus_torch.serving.sharded import SeedParams, ShardedModelExecutor
    from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

    model = SHARDED_MODELS["nexus_1b_f32"]()
    prompts = _requests(model.vocab_size, 16, 64, seed=18)
    old_tokens = out.pop("b_old_tokens")
    new = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(5), model, device=SHARDED_DEVICE)
    ck = TensorCheckpointer(str(Path(tmp) / "ckpt"))
    t0 = time.perf_counter()
    ck.save(2, {"params": new})
    ck.commit(2)
    save_s = time.perf_counter() - t0
    new_tokens = _engine_tokens(ModelExecutor(new, model, num_slots=8, max_len=80), prompts[:8], 16)[0]
    del new
    torch.cuda.empty_cache()
    try:
        sx = ShardedModelExecutor(SeedParams(1), model, mesh=pool.mesh({"tp": 2}), num_slots=4, max_len=80)
        eng = ServingEngine(sx)
        inflight = [eng.submit(prompts[i], 16, request_id=f"old{i}") for i in range(4)]
        for _ in range(2):
            eng.step()
        straddler = eng.submit(prompts[4], 16, request_id="straddler")
        eng.quiesce(grace_s=60.0)
        t0 = time.perf_counter()
        eng.swap_params(ck.params_ref(2))
        swap_s = time.perf_counter() - t0
        eng.resume_admission()
        post = eng.submit(prompts[5], 16, request_id="post")
        eng.run_until_drained()
        sx.close()
        swap = dict(
            swap_s=swap_s, checkpoint_save_commit_s=save_s,
            inflight_old_tokens=all(list(r.output_tokens) == old_tokens[i].tolist() for i, r in enumerate(inflight)),
            straddler_new_tokens=list(straddler.output_tokens) == new_tokens[4].tolist(),
            post_new_tokens=list(post.output_tokens) == new_tokens[5].tolist(),
            states=sorted({r.state for r in inflight + [straddler, post]}),
        )
        meshes = pool.meshes([({"tp": 2}, (0, 1)), ({"tp": 2}, (0, 2))])
        executors = [ShardedModelExecutor(SeedParams(1), model, mesh=m, num_slots=4, max_len=80) for m in meshes]
        fleet = ServingFleet()
        for i, ex in enumerate(executors):
            fleet.add_replica(f"rep-{i}", ServingEngine(ex), step=1)
        fleet.start_rollout(ck, 2, grace_s=60.0)
        reqs = []
        for i in range(8):
            reqs.append(fleet.submit(prompts[8 + i], 16))
            fleet.tick()
        for _ in range(2000):
            fleet.tick()
            if not fleet.rollout_active and not fleet.has_work:
                break
        fleet.run_until_drained()
        for ex in executors:
            ex.close()
        fleet_row = dict(converged=fleet.converged(2), rollouts_completed=fleet.rollouts_completed,
                         states=sorted({r.state for r in reqs}))
    finally:
        ck.close()
    out["e"] = dict(swap=swap, fleet=fleet_row)
    emit("serve_sharded", part="e", **out["e"])
    if not (swap["inflight_old_tokens"] and swap["straddler_new_tokens"] and swap["post_new_tokens"]
            and swap["states"] == [RequestState.FINISHED]):
        raise AssertionError(f"serve_sharded (e): swap {swap}")
    if not (fleet_row["converged"] and fleet_row["states"] == [RequestState.FINISHED]):
        raise AssertionError(f"serve_sharded (e): fleet {fleet_row}")


#: (f)'s most new tokens a request (the mix's 192 cut for the phase's time)
SHARDED_DISAGG_GEN = 32


def sharded_disagg(results, pool, out):
    """(f) The KV handoff of a sharded pool.  llama3_8b bf16 at full width,
    :data:`DISAGG_LAYERS` of its 32 layers, page 32: the fused tp-2 replica
    (ranks 0+2) serves :data:`DISAGG_REQUESTS` requests of the disagg mix
    (at most :data:`SHARDED_DISAGG_GEN` new tokens each);
    then a tp-2 prefill replica (ranks 0+1) hands the same requests off to
    that replica as a decode replica.  Gates: tokens equal the fused
    replica's, one ``handoffs_completed`` a request, ``disagg_fallbacks`` 0,
    #1 launched on both prefill ranks and #4 (paged) on both decode ranks;
    a timed run (4 new tokens) gives the payload bytes and the extract /
    seal / validate / install ms a handoff.  Then nexus_1b f32 (4 layers):
    a tp-2 prefill replica to a one-device decode replica and a one-device
    prefill replica to a tp-2 decode replica, tokens identical to one fused
    device's (in bf16 such a mix need not be token-identical)."""
    import torch

    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.serving import ROLE_DECODE, ROLE_PREFILL, DisaggConfig, PagedModelExecutor, ServingEngine
    from tpu_nexus_torch.serving import RequestState, ServingFleet
    from tpu_nexus_torch.serving.sharded import SeedParams, ShardedPagedModelExecutor

    model = _llama3_8b(DISAGG_LAYERS)
    # the disagg phase's prompts; generation capped (the phase's time): the
    # handoffs are the prompts'
    mix = [(p, min(gen, SHARDED_DISAGG_GEN)) for p, gen in _disagg_mix(model.vocab_size, DISAGG_REQUESTS, seed=5)]
    page, max_len = 32, 224
    pf_mesh, dc_mesh, exact_mesh = pool.meshes([({"tp": 2}, (0, 1)), ({"tp": 2}, (0, 2)), ({"tp": 2}, (0, 1))])
    pf = ShardedPagedModelExecutor(SeedParams(0), model, mesh=pf_mesh, num_slots=2, max_len=max_len, page_size=page)
    dc = ShardedPagedModelExecutor(SeedParams(0), model, mesh=dc_mesh, num_slots=12, max_len=max_len, page_size=page)

    def fleet_of(wrap=lambda ex: ex):
        fleet = ServingFleet(disagg=DisaggConfig())
        fleet.add_replica("pf-0", ServingEngine(wrap(pf)), step=0, role=ROLE_PREFILL)
        fleet.add_replica("dc-0", ServingEngine(wrap(dc)), step=0, role=ROLE_DECODE)
        return fleet

    fused = ServingEngine(dc)
    fused_reqs = [fused.submit(p, gen, request_id=f"d{i}") for i, (p, gen) in enumerate(mix)]
    fused.run_until_drained()
    want = [list(r.output_tokens) for r in fused_reqs]
    # the main run: a fresh engine (and block accounting) over each replica
    fleet = fleet_of()
    for ex in (pf, dc):  # zero every rank's counts (rank 0: both leaders)
        ex.shard_stats(reset=True)
    torch_sync()
    t0 = time.perf_counter()
    reqs = [fleet.submit(p, gen, request_id=f"d{i}") for i, (p, gen) in enumerate(mix)]
    fleet.run_until_drained()
    torch_sync()
    wall = time.perf_counter() - t0
    by_rank = {s["rank"]: _rank_launches([s])[0] for s in pf.shard_stats() + dc.shard_stats()}
    paged = {r: sum(n for m, n in c["decode_attention_by_mode"].items() if m.startswith("paged"))
             for r, c in by_rank.items()}
    mismatched = sum(list(r.output_tokens) != want[i] for i, r in enumerate(reqs))
    row = dict(requests=len(mix), finished=sum(r.state == RequestState.FINISHED for r in reqs),
               token_identical_to_fused_tp2=mismatched == 0, mismatched_requests=mismatched,
               handoffs_completed=fleet.handoffs_completed, disagg_fallbacks=fleet.disagg_fallbacks,
               wall_s=wall, decoded_tokens_per_second=_finished_tokens(reqs) / wall,
               launches_by_rank=by_rank)
    results.setdefault("launches", {})["serve_sharded_disagg"] = {
        "flash_attention": sum(c["flash_attention"] for c in by_rank.values()),
        "decode_attention_paged": sum(paged.values())}
    # the timed run: every seam call synchronised and timed
    fleet = fleet_of(_TimedSeam)
    timed_reqs = [fleet.submit(p, 4, request_id=f"t{i}") for i, (p, _) in enumerate(mix)]
    fleet.run_until_drained()
    if fleet.handoffs_completed != len(mix) or any(r.state != RequestState.FINISHED for r in timed_reqs):
        raise AssertionError(f"serve_sharded (f): timed run {fleet.handoffs_completed} handoffs")
    row["handoff_by_blocks"], nbytes = _handoff_timings(fleet, timed_reqs, page)
    row["payload_bytes_total"] = sum(nbytes)
    pf.close()
    dc.close()
    del fleet, fused, pf, dc
    torch.cuda.empty_cache()
    out["f"] = {"llama3_8b_tp2_to_tp2": dict(
        config=f"llama3_8b full width, {model.n_layers} of 32 layers, bf16, page {page}: tp-2 prefill replica "
               "(ranks 0+1) -> tp-2 decode replica (ranks 0+2; 12 slots), the fused reference that replica",
        **row)}
    if row["finished"] != len(mix) or mismatched or row["handoffs_completed"] != len(mix) or row["disagg_fallbacks"]:
        raise AssertionError(f"serve_sharded (f): {row}")
    if not (by_rank[0]["flash_attention"] and by_rank[1]["flash_attention"] and paged[0] and paged[2]):
        raise AssertionError(f"serve_sharded (f): a rank did not launch its kernel: {by_rank}")

    # nexus_1b f32: each mixed direction against one fused device
    model = SHARDED_MODELS["nexus_1b_f32"]()
    prompts = _requests(model.vocab_size, 8, 64, seed=21)
    params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(1), model, device=SHARDED_DEVICE)
    one = PagedModelExecutor(params, model, num_slots=8, max_len=80, page_size=page)
    one_tokens = _engine_tokens(one, prompts, 16)[0].tolist()
    sx = ShardedPagedModelExecutor(SeedParams(1), model, mesh=exact_mesh, num_slots=8, max_len=80, page_size=page)
    for name, (pf, dc) in (("tp2_prefill_one_device_decode", (sx, one)), ("one_device_prefill_tp2_decode", (one, sx))):
        fleet = ServingFleet(disagg=DisaggConfig())
        fleet.add_replica("pf-0", ServingEngine(pf), step=0, role=ROLE_PREFILL)
        fleet.add_replica("dc-0", ServingEngine(dc), step=0, role=ROLE_DECODE)
        reqs = [fleet.submit(p, 16, request_id=f"x{i}") for i, p in enumerate(prompts)]
        fleet.run_until_drained()
        out["f"][name] = dict(tokens_identical=[list(r.output_tokens) for r in reqs] == one_tokens,
                              handoffs_completed=fleet.handoffs_completed, disagg_fallbacks=fleet.disagg_fallbacks)
    sx.close()
    del one, params, sx
    torch.cuda.empty_cache()
    emit("serve_sharded", part="f", **out["f"])
    bad = {k: v for k, v in out["f"].items() if k != "llama3_8b_tp2_to_tp2" and not (
        v["tokens_identical"] and v["handoffs_completed"] == len(prompts) and not v["disagg_fallbacks"])}
    if bad:
        raise AssertionError(f"serve_sharded (f): nexus_1b f32 across a tp-2 and a one-device replica: {bad}")


def sharded_model_drafter(results, pool, out):
    """(g) The model drafter beside a sharded executor, through
    ``run_serve_engine`` with ``serve_mesh="tp=2"``, page 32, spec_k 4 and
    a self-draft (the draft: one device's executor on the leader's card over
    the whole tree of the replica's seed).  nexus_1b f32 (4 layers, 8
    requests of 64 + 16): tokens equal one device's greedy tokens; then
    llama3_8b bf16 at 8 of its 32 layers (8 requests of 128 + 32):
    COMPLETED, the acceptance rate, each rank's #4 ``q_starts`` (verify)
    launches."""
    import torch

    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.serving import PagedModelExecutor
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    out["g"] = {}
    cases = (("nexus_1b_f32", SHARDED_MODELS["nexus_1b_f32"](), 64, 16, 1),
             ("llama3_8b", SHARDED_MODELS["llama3_8b_8_layers"](), SHARDED_PROMPT, 32, 0))
    for name, model, prompt_len, gen, seed in cases:
        prompts = _requests(model.vocab_size, 8, prompt_len, seed=22)
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=prompt_len, gen_tokens=gen, rounds=1,
                          device=SHARDED_DEVICE, page_size=32, serve_mesh="tp=2", rank_map="shared", spec_k=4,
                          spec_drafter="model", seed=seed)
        store = InMemoryCheckpointStore()
        pool.reset_counts()
        with recorded_serving() as seen:
            summary = run_serve_engine(cfg, store=store, pool=pool, prompts=iter([prompts, prompts]),
                                       ctx=ProcessContext("serve_sharded_spec", "serve", 0, 1, None))
        summary.pop("replica").close()
        got = list(engine_tokens(seen["engines"][-1]).values())
        per_rank = _rank_launches(summary["shard_stats"])
        verify = [c["decode_attention_by_mode"].get("paged+ragged", 0) for c in per_rank]
        row = dict(stage=store.read_checkpoint("serve", "serve_sharded_spec").lifecycle_stage,
                   finished=summary["finished"], spec_proposed=summary["spec_proposed"],
                   spec_accepted=summary["spec_accepted"], spec_acceptance_rate=summary["spec_acceptance_rate"],
                   engine_steps=summary["engine_steps"], decoded_tokens_per_second=summary["decoded_tokens_per_second"],
                   launches_per_rank=per_rank, verify_launches_per_rank=verify)
        if name == "nexus_1b_f32":
            params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(seed), model, device=SHARDED_DEVICE)
            one = PagedModelExecutor(params, model, num_slots=8, max_len=prompt_len + gen, page_size=32)
            row["tokens_identical_to_one_device"] = got == _engine_tokens(one, prompts, gen)[0].tolist()
            del one, params
        else:
            results.setdefault("launches", {})["serve_sharded_spec"] = {"decode_attention_ragged": sum(verify)}
        out["g"][name] = row
        torch.cuda.empty_cache()
        if row["stage"] != LifecycleStage.COMPLETED or row["finished"] != 8 or not all(verify) \
                or not row["spec_accepted"] or not row.get("tokens_identical_to_one_device", True):
            raise AssertionError(f"serve_sharded (g) {name}: {row}")
    emit("serve_sharded", part="g", config="run_serve_engine, tp 2, page 32, spec_k 4, model drafter (self-draft)",
         **out["g"])


def sharded_times(results):
    """Kernels #1, #4 (paged) and #5/#6 at one rank's shapes of llama3_8b
    at tp 2, bf16: the prefill's flash (B1, S128, Hq 16, Hkv 4), the paged
    decode step (B8, kv 144, page 32, Hq 16, Hkv 4) and the five dequant-
    matmul products (:data:`SHARDED_QUANT_SHAPES`), each with its bound,
    its plain version's time and the library yardstick, as ``times``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    times = results.setdefault("times", {})
    dt = torch.bfloat16
    sets = [flash_inputs(1, 128, 16, 4, 128, dt, seed=9100 + i) for i in range(32)]
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) for q, k, v in sets]
    bound, by = flash_bound(1, 128, 16, 4, 128, dt)
    ms, enqueue_ms = timed([lambda x=x: flash_attention(*x, causal=True) for x in sets], iters=64)
    times["flash_attention_tp2"] = dict(
        shape=[1, 128, 16, 4, 128], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
        plain_ms=cuda_ms([lambda x=x: flash_attention_plain(*x, causal=True) for x in sets], iters=16),
        library_ms=cuda_ms([lambda x=x: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True)
                            for x in lib_sets], iters=64), bound_ms=bound, bound_by=by)
    del sets, lib_sets

    b, page, kv_len, hq, hkv, d = 8, 32, 144, 16, 4, 128
    n_log = -(-(kv_len + 16) // page)
    live = np.full(b, kv_len, np.int32)
    layers = []
    for i in range(32):
        q, k, v, tables, _ = paged_case(b, 1, page, n_log, live, dt, 9200 + i)
        layers.append((q[:, :, :hq].contiguous(), k[:, :, :hkv].contiguous(), v[:, :, :hkv].contiguous(), tables))
    kw = dict(prompt_lengths=torch.from_numpy(live).cuda(), prompt_width=n_log * page)
    lib_sets = [(x[0].transpose(1, 2), _gather_rows(x[1], x[3])[:, :kv_len].transpose(1, 2),
                 _gather_rows(x[2], x[3])[:, :kv_len].transpose(1, 2)) for x in layers]
    nbytes = (b * kv_len * hkv * d * 2 + 2 * b * hq * d) * 2 + b * n_log * 4
    t_ops, t_bytes = 4 * hq * d * b * kv_len / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms, enqueue_ms = timed([lambda x=x: decode_attention(x[0], x[1], x[2], kv_len, block_tables=x[3], **kw)
                            for x in layers], iters=64)
    times["decode_attention_paged_tp2"] = dict(
        shape=[b, 1, page, n_log, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
        plain_ms=cuda_ms([lambda x=x: decode_attention_plain(x[0], x[1], x[2], kv_len, block_tables=x[3], **kw)
                          for x in layers], iters=16),
        library_ms=cuda_ms([lambda x=x: F.scaled_dot_product_attention(*x, enable_gqa=True) for x in lib_sets],
                           iters=64),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")
    del layers, lib_sets

    # the speculative verify of part (g) at a rank's shape: #4's q_starts
    # mode, q_len 5 at staggered starts, held against its plain version
    # (twice, bit-identical), then timed as the paged step above
    sq = 5
    starts = (kv_len - sq - np.arange(b) * 7).astype(np.int32)
    live = starts + sq
    deepest = int(live.max())
    layers = []
    for i in range(32):
        q, k, v, tables, _ = paged_case(b, sq, page, n_log, live, dt, 9300 + i)
        layers.append((q[:, :, :hq].contiguous(), k[:, :, :hkv].contiguous(), v[:, :, :hkv].contiguous(), tables))
    kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device="cuda"), prompt_width=0,
              q_starts=torch.from_numpy(starts).cuda())
    x = layers[0]
    got, again = (decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw) for _ in range(2))
    ref = decode_attention_plain(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
    err, row_err = max_err(got, ref), row_rel_err(got, ref)
    identical = bool(torch.equal(got, again))
    k_pos = torch.arange(deepest, device="cuda")
    row_last = torch.from_numpy(starts).cuda()[:, None] + torch.arange(sq, device="cuda")[None, :]
    mask = (k_pos[None, None, :] <= row_last[:, :, None])[:, None]
    lib_sets = [(x[0].transpose(1, 2), _gather_rows(x[1], x[3])[:, :deepest].transpose(1, 2),
                 _gather_rows(x[2], x[3])[:, :deepest].transpose(1, 2)) for x in layers]
    nbytes = (int(live.sum()) * hkv * d * 2 + 2 * b * sq * hq * d) * 2 + b * n_log * 4
    t_ops, t_bytes = 4 * hq * d * sq * int(live.sum()) / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms, enqueue_ms = timed([lambda x=x: decode_attention(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                            for x in layers], iters=64)
    times["decode_attention_ragged_tp2"] = dict(
        shape=[b, sq, page, n_log, kv_len, hq, hkv, d], dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
        plain_ms=cuda_ms([lambda x=x: decode_attention_plain(x[0], x[1], x[2], deepest, block_tables=x[3], **kw)
                          for x in layers], iters=16),
        library_ms=cuda_ms([lambda x=x: F.scaled_dot_product_attention(*x, attn_mask=mask, enable_gqa=True)
                            for x in lib_sets], iters=64),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
        max_abs_err=err, worst_row_rel_l2=row_err, bit_identical=identical, starts=starts.tolist())
    del layers, lib_sets
    if err > TOL["bfloat16"][0] or row_err > ROW_REL_TOL or not identical:
        raise AssertionError(f"serve_sharded: #4 q_starts at a tp-2 rank's shape: {times['decode_attention_ragged_tp2']}")

    for key, m, k, n in SHARDED_QUANT_SHAPES:
        for mode, group in (("int8", 0), ("int4", 64)):
            x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(4000), device="cuda").to(dt)
            first = quant_weight(k, n, mode, group, 4001)
            copies = max(4, -(-128 * 2**20 // (first.q.numel() + first.s.numel() * 4)))
            weights = [first] + [quant_weight(k, n, mode, group, 4001 + i) for i in range(1, copies)]
            dense = [w.to(dt) for w in weights[: max(4, -(-copies // 4))]]
            bound, by = quant_bound(m, k, n, weights[0], dt)
            ms, enqueue_ms = timed([lambda w=w: quant_matmul(x, w) for w in weights], iters=64)
            times[f"quant_matmul_{mode}_tp2_{key}"] = dict(
                shape=[m, k, n], group=group or None, dtype="bfloat16", ms=ms, enqueue_ms=enqueue_ms,
                plain_ms=cuda_ms([lambda w=w: quant_matmul_plain(x, w) for w in weights[:4]], iters=8, warmup=2),
                library_ms=cuda_ms([lambda w=w: torch.matmul(x, w) for w in dense], iters=64),
                bound_ms=bound, bound_by=by, weight_copies=copies)
            del weights, dense, first
            torch.cuda.empty_cache()
    emit("serve_sharded", part="times", library_ms_is={
        "flash_attention_tp2": "scaled_dot_product_attention", "decode_attention_paged_tp2":
        "scaled_dot_product_attention on the pre-gathered cache", "decode_attention_ragged_tp2":
        "scaled_dot_product_attention on the pre-gathered cache with the mask",
        "quant_matmul": "torch.matmul, dequantized bf16"},
        **{k: v for k, v in times.items() if k.endswith("_tp2") or "_tp2_" in k})


def phase_serve_sharded(results):
    """One serve-engine replica across tensor/expert-parallel ranks on this
    card: the workers of ``serving/sharded.py``'s ``RankPool`` (spawned,
    three ranks) all on cuda:0 under the explicit one-device rehearsal map,
    over gloo — which collectives gloo takes on CUDA tensors is probed
    first (the seam's must be among them).  Its tokens/s is two ranks
    sharing one card over gloo through host memory, not a tensor-parallel
    speed.  Parts (a)-(e) (see their functions), then the kernels at each
    rank's shapes."""
    import tempfile

    import torch

    from tpu_nexus_torch.serving.sharded import RankPool

    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # by earlier phases of this process
    out = {}
    t0 = time.perf_counter()
    with RankPool(3, device=SHARDED_DEVICE, rank_map="shared", timeout_s=300.0) as pool:
        start_s = time.perf_counter() - t0
        probe = pool.gloo_cuda_probe()
        emit("serve_sharded", part="ranks", cards=cards, world=3, map="shared (every rank on cuda:0)",
             leader_bytes_allocated_at_start=held,
             backend=pool.backend, pool_start_s=start_s, gloo_cuda_probe=probe)
        if pool.backend == "gloo" and any(v != "ok" for k, v in probe.items() if k.split("/")[0] in
                                          ("all_reduce", "all_gather")):
            raise AssertionError(f"serve_sharded: gloo refuses a collective of the seam on CUDA tensors: {probe}")
        for part in (sharded_main_path, sharded_exact, sharded_quantized, sharded_moe, sharded_disagg,
                     sharded_model_drafter):
            t1 = time.perf_counter()
            part(results, pool, out)
            torch.cuda.empty_cache()
            emit("serve_sharded_part_done", part=part.__name__, seconds=time.perf_counter() - t1)
        with tempfile.TemporaryDirectory() as tmp:
            sharded_swap_and_fleet(results, pool, out, tmp)
    torch.cuda.empty_cache()
    sharded_rank_shape_parity(results, out)
    sharded_times(results)


# -- train_sharded ---------------------------------------------------------------

#: the main path's steps and the exact meshes of part (b)
TRAIN_SHARDED_STEPS = 2
TRAIN_SHARDED_EXACT = (({"fsdp": 2}, "ring"), ({"tp": 2}, "ring"), ({"sp": 2}, "ring"), ({"sp": 2}, "ulysses"),
                       ({"fsdp": 2, "tp": 2}, "ring"))
#: (b)'s depth and global batch
TRAIN_SHARDED_EXACT_LAYERS, TRAIN_SHARDED_EXACT_BATCH = 4, (4, 1024)
#: the rank shapes of part (c): (label, B, S, Hq, Hkv, causal)
TRAIN_SHARDED_RANK_SHAPES = (("fsdp2", 4, 2048, 16, 8, True), ("ring_sp2_diagonal", 8, 1024, 16, 8, True),
                             ("ring_sp2_offdiagonal", 8, 1024, 16, 8, False), ("ulysses_sp2", 8, 2048, 8, 4, True))


def _summary_of(stderr):
    """The ``workload done: {...}`` dict a container logs (a Python literal)."""
    import ast

    m = re.search(r"workload done: (\{.*\})\s*$", stderr, re.M)
    return ast.literal_eval(m.group(1)) if m else None


def _step_losses(stderr):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(r"\bstep (\d+) loss ([0-9.eE+-]+|nan)", stderr)}


def sharded_train_main_path(results, tmp, out, beside=None):
    """(a) Two containers, ``python -m tpu_nexus_torch.workload`` with
    ``NEXUS_NUM_PROCESSES=2`` and the default mesh (fsdp over both ranks),
    both on cuda:0 under the rehearsal map over gloo: nexus_1b at full width
    and depth, bf16, adamw, remat attn_out, global batch 8 x 2048,
    :data:`TRAIN_SHARDED_STEPS` steps, an sqlite ledger and a save at the
    last step.  Checks: the row COMPLETED with host0/chip0 and host1/chip0
    at the last step; #1-#3 launched 14 times a step on each rank; step 1's
    loss against the one-device step on the same weights and global batch,
    no farther from the f32 evaluation of those weights than the one-device
    bf16 step (or 1e-3 of it); a one-device restore of the saved step equal,
    leaf for leaf, to the state the fsdp-2 ranks restore and gather.  Also:
    each rank's collectives and bytes a step, peak memory and tokens/s (a
    rehearsal: two ranks share one card).  ``beside()`` (on a thread) and
    the one-device step run while the containers do, from their start (the
    containers' rendezvous port is held for them), and the restore runs
    while ``beside()`` may still (their traffic is host-bound: the card has
    room)."""
    import numpy as np
    import torch

    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
    from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.parallel.distributed import reserved_port
    from tpu_nexus_torch.workload.rehearsal import RankWorld
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_eval_step, make_train_step

    steps, batch, seq = TRAIN_SHARDED_STEPS, 8, 2048
    model = LlamaConfig.nexus_1b()
    adapter = LlamaAdapter(config=model)
    tc = TrainConfig(warmup_steps=10, total_steps=steps)

    def one_device_step1():
        """Step 1's loss on one device (the same seed's weights, the global
        batch the two processes drew: rows mode, process p its 4 rows with
        seed p) and the f32 evaluation of those weights on that batch."""
        global_batch = np.concatenate([next(adapter.data(batch // 2, seq, seed=p)) for p in range(2)])
        tokens = torch.from_numpy(global_batch).long().cuda()
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), adapter, tc, "cuda")
        f32 = make_eval_step(LlamaAdapter(config=dataclasses.replace(model, dtype=torch.float32)), tc)(state, tokens)
        _, one = make_train_step(adapter, tc)(state, tokens)
        out = float(one["loss"]), float(f32["loss"])
        del state, one, f32, tokens
        torch.cuda.empty_cache()
        return out

    ledger, ckpt = os.path.join(tmp, "ledger.db"), os.path.join(tmp, "ckpt")
    # the launcher's order: the run's row first (BUFFERED), then its
    # containers (two processes opening a new sqlite ledger at once race on
    # its journal mode)
    seed_store = SqliteCheckpointStore(ledger)
    seed_store.upsert_checkpoint(CheckpointedRequest(algorithm="nexus-1b", id="train-sharded",
                                                     lifecycle_stage=LifecycleStage.BUFFERED))
    seed_store.close()
    t0 = time.perf_counter()
    logs = [os.path.join(tmp, f"container{i}.err") for i in range(2)]
    procs = []
    # the containers' rendezvous port is held until they end, so the work
    # beside them (its own ports included) starts at once
    with reserved_port() as port:
        env = {**{k: v for k, v in os.environ.items() if not k.startswith("NEXUS")},
               "NEXUS_MODE": "train", "NEXUS_MODEL_PRESET": "nexus_1b", "NEXUS_BATCH": str(batch),
               "NEXUS_SEQ_LEN": str(seq), "NEXUS_STEPS": str(steps), "NEXUS_HEARTBEAT_EVERY": "1",
               "NEXUS_CHECKPOINT_EVERY": str(steps), "NEXUS_CHECKPOINT_DIR": ckpt, "NEXUS_NUM_PROCESSES": "2",
               "NEXUS_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NEXUS_RANK_DEVICE_MAP": "shared",
               "NEXUS_RUN_ID": "train-sharded", "NEXUS_ALGORITHM": "nexus-1b", "NEXUS_DIST_TIMEOUT_S": "600",
               "NEXUS__CQL_STORE_TYPE": "sqlite", "NEXUS__SQLITE_STORE_PATH": ledger}
        try:
            for i in range(2):
                with open(logs[i], "w") as fh:  # a file: a full pipe would stall a container while beside() runs
                    procs.append(subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], cwd=ROOT,
                                                  env={**env, "NEXUS_PROCESS_ID": str(i)},
                                                  stdout=subprocess.DEVNULL, stderr=fh))
            # beside() on a thread: it outlasts the containers, whose saved
            # step is restored below while it runs
            beside_done = _beside(beside) if beside is not None else (lambda: None)
            one_loss, f32_loss = one_device_step1()
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall = time.perf_counter() - t0
    errs = [Path(log).read_text() for log in logs]
    if any(p.returncode != 0 for p in procs):
        beside_done()
        raise AssertionError("train_sharded (a): containers exited " + ", ".join(
            f"{i}: {p.returncode}\n{err[-3000:]}" for i, (p, err) in enumerate(zip(procs, errs))))
    summaries = [_summary_of(e) for e in errs]
    peaks = [int(m.group(1)) if (m := re.search(r"peak device memory: (\d+) bytes", e)) else None for e in errs]
    row = SqliteCheckpointStore(ledger).read_checkpoint("nexus-1b", "train-sharded")
    launches = [s["attention_launches"] for s in summaries]
    n_layers = model.n_layers
    losses = [_step_losses(e) for e in errs]

    sharded_loss = losses[0].get(1)
    allowed = max(1.25 * abs(one_loss - f32_loss), 1e-3 * abs(f32_loss))

    # the saved step: restored onto fsdp 2 (each rank its slices, gathered
    # whole) and onto one device, leaf for leaf
    with RankWorld(2, device=SHARDED_DEVICE, timeout_s=600) as world:
        restored = world.run("tpu_nexus_torch.workload.rehearsal:restore_on_mesh", directory=ckpt, step=steps,
                             spec={"fsdp": 2}, model=adapter, train_cfg=tc, device=SHARDED_DEVICE)[0]
    beside_done()
    beside_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    per_step = [{name: {"calls": s["collectives"]["calls"][name] / steps,
                        "bytes": s["collectives"]["bytes"][name] / steps} for name in s["collectives"]["calls"]}
                for s in summaries]
    out["a"] = dict(
        config=f"nexus_1b full width and depth, bf16, adamw, remat attn_out, global batch {batch} x {seq}, "
               f"{steps} steps, fsdp 2 over 2 container processes (default mesh)",
        stage=row.lifecycle_stage if row else None, per_chip_steps=row.per_chip_steps if row else None,
        tensor_checkpoint_uri=row.tensor_checkpoint_uri if row else None, wall_s=wall,
        beside_s=beside_s, beside_is="seconds from the containers' start until the probe and (b) (on a thread), "
        "the one-device step and the restore below had all finished",
        launches_per_rank=launches, staged=summaries[0]["collectives"]["staged"],
        collectives_per_step_per_rank=per_step, peak_memory_per_rank=peaks,
        losses_per_rank=[[v for _, v in sorted(x.items())] for x in losses],
        step1_loss=dict(sharded=sharded_loss, one_device=one_loss, f32_evaluation=f32_loss, allowed=allowed),
        restore=restored,
        tokens_per_second_rehearsal=summaries[0]["tokens_per_second"],
        tokens_per_second_is="two ranks sharing one card over gloo (the rehearsal map), not a data-parallel speed",
        mfu_rehearsal=summaries[0].get("goodput", {}).get("mfu"),
    )
    emit("train_sharded", part="a", **out["a"])
    if row is None or row.lifecycle_stage != LifecycleStage.COMPLETED or row.per_chip_steps != {
            "host0/chip0": steps, "host1/chip0": steps}:
        raise AssertionError(f"train_sharded (a): row {row and row.lifecycle_stage} {row and row.per_chip_steps}")
    if any(n != n_layers * steps for counts in launches for n in counts.values()):
        raise AssertionError(f"train_sharded (a): launches {launches} != {n_layers} x {steps} a rank")
    if sharded_loss is None or losses[0] != losses[1] or abs(sharded_loss - f32_loss) > allowed:
        raise AssertionError(f"train_sharded (a): step-1 loss {out['a']['step1_loss']}, ranks {losses}")
    if restored is None or restored["differ"] or restored["leaves"] == 0:
        raise AssertionError(f"train_sharded (a): restores differ: {restored}")
    results.setdefault("launches", {})["train_sharded"] = {k: sum(c[k] for c in launches) for k in launches[0]}


def sharded_train_exact(results, world, staged, out):
    """(b) nexus_1b at full width and :data:`TRAIN_SHARDED_EXACT_LAYERS` of
    14 layers in f32 (global batch :data:`TRAIN_SHARDED_EXACT_BATCH`) at each
    mesh of :data:`TRAIN_SHARDED_EXACT` against one device: one adamw step
    from the seed's init with a one-step warmup, so it (lr 0) leaves the
    weights and fills Adam's first moment with (1 - b1) x the clipped
    gradient.  Gated: the loss and grad norm within 1e-5 relative, every
    leaf's first moment (the sharded gradient) within 1e-5 x its max-abs.
    The parameters after an update are not held to that: Adam divides a
    gradient element by its own magnitude, so the rounding noise of an
    element that cancels to ~0 moves it by up to 2·lr in any two programs
    that sum in another order (ROADMAP.md queue C)."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.workload.train import TrainConfig

    model = dataclasses.replace(LlamaConfig.nexus_1b(), n_layers=TRAIN_SHARDED_EXACT_LAYERS, dtype=torch.float32,
                                param_dtype=torch.float32)
    b, s = TRAIN_SHARDED_EXACT_BATCH
    rng = np.random.default_rng(31)
    batches = [rng.integers(0, model.vocab_size, (b, s)).astype(np.int32)]
    job = "tpu_nexus_torch.workload.rehearsal:train_steps"
    common = dict(model=model, batches=batches, device=SHARDED_DEVICE, stage=staged)
    t0 = time.perf_counter()
    ref = world.run(job, spec={}, train_cfg=TrainConfig(warmup_steps=1, total_steps=4), reference="keep",
                    **common)[0]
    rows = []
    for spec, attn in TRAIN_SHARDED_EXACT:
        t1 = time.perf_counter()
        got = world.run(job, spec=spec, train_cfg=TrainConfig(warmup_steps=1, total_steps=4, sp_attn=attn),
                        reference="compare", **common)[0]
        worst_grad = max(err / scale for err, scale in got["first_moments"].values() if scale)
        ok = (all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(got["loss"], ref["loss"]))
              and all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(got["grad_norm"], ref["grad_norm"]))
              and worst_grad <= 1e-5)
        rows.append(dict(mesh=spec, sp_attn=attn, loss=got["loss"], grad_norm=got["grad_norm"],
                         worst_gradient_err_over_max=worst_grad, ok=ok, seconds=time.perf_counter() - t1, collectives_calls=got["collectives"]["calls"]))
        torch.cuda.empty_cache()
    out["b"] = dict(config=f"nexus_1b full width, {TRAIN_SHARDED_EXACT_LAYERS} of 14 layers, f32, adamw, "
                           f"global batch {b} x {s}, 1 step (warmup 1: lr 0)",
                    one_device=dict(loss=ref["loss"], grad_norm=ref["grad_norm"]), meshes=rows,
                    seconds=time.perf_counter() - t0)
    emit("train_sharded", part="b", **out["b"])
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"train_sharded (b): meshes differ from one device in f32: {failed}")


def sharded_train_rank_shapes(results, out, shapes=TRAIN_SHARDED_RANK_SHAPES, phase="train_sharded", part="c"):
    """(c) Kernels #1-#3 at the rank shapes of the parallel training meshes
    (``shapes``, default :data:`TRAIN_SHARDED_RANK_SHAPES`; bf16, D 128;
    train_pp_ep's (d) passes the pipeline's microbatch): each against its plain
    version (the forward at the parity phase's bf16 limits, the backward at
    train_parity's), each run twice bit-identical, then timed beside its
    bound, its plain version and ``scaled_dot_product_attention`` (forward;
    its backward for the backward kernels)."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
        flash_bwd_qt,
        flash_dsum,
    )

    dt, d = torch.bfloat16, 128
    rows = {}
    for label, b, s, hq, hkv, causal in shapes:
        q, k, v, o, lse, dout = bwd_inputs(b, s, hq, hkv, d, dt, causal, seed=4100)
        again, lse2 = flash_attention(q, k, v, causal=causal)
        ref_o, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        dsum, qt = flash_dsum(o, dout), flash_bwd_qt(q, d**-0.5)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, dsum, causal=causal, qt=qt)
        dq2 = flash_attention_bwd_dq(q, k, v, dout, lse, dsum, causal=causal, qt=qt)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, dsum, causal=causal, qt=qt)
        dk2, dv2 = flash_attention_bwd_dkv(q, k, v, dout, lse, dsum, causal=causal, qt=qt)
        torch.cuda.synchronize()
        rdq, rdk, rdv = flash_attention_bwd_plain(q, k, v, o, lse, dout, causal=causal)
        fwd_err = max_err(o, ref_o)
        bwd_errs = {n: (max_err(a, r), float(r.float().abs().max()), row_rel_err(a, r, BWD_ROW_FLOOR))
                    for n, a, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
        identical = all(torch.equal(x, y) for x, y in ((o, again), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)))
        ok = (identical and fwd_err <= TOL["bfloat16"][0] and max_err(lse, ref_lse) <= TOL["bfloat16"][1]
              and all(e <= BWD_BF16_MAXABS_REL * m and r <= ROW_REL_TOL for e, m, r in bwd_errs.values()))
        sets = [bwd_inputs(b, s, hq, hkv, d, dt, causal, seed=4200 + i) for i in range(2)]
        pre = [(flash_dsum(x[3], x[5]), flash_bwd_qt(x[0], d**-0.5)) for x in sets]
        lib_fwd, lib_bwd = [], []
        for x in sets:
            ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in x[:3])
            lib_fwd.append(lambda x=(ql, kl, vl): F.scaled_dot_product_attention(*x, is_causal=causal,
                                                                                  enable_gqa=True))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
            lib_bwd.append(lambda lo=lo, g=x[5].transpose(1, 2), leaves=(ql, kl, vl): torch.autograd.grad(
                lo, leaves, g, retain_graph=True))
        fb, fby = flash_bound(b, s, hq, hkv, d, dt, causal)
        qb, qby = bwd_bound(b, s, hq, hkv, d, dt, 2, "dq", causal)
        kb, kby = bwd_bound(b, s, hq, hkv, d, dt, 3, "dkv", causal)
        fwd_ms, fwd_enq = timed([lambda x=x: flash_attention(*x[:3], causal=causal) for x in sets], iters=20)
        dq_ms, dq_enq = timed([lambda x=x, p=p: flash_attention_bwd_dq(x[0], x[1], x[2], x[5], x[4], p[0],
                                                                        causal=causal, qt=p[1])
                               for x, p in zip(sets, pre)], iters=20)
        dkv_ms, dkv_enq = timed([lambda x=x, p=p: flash_attention_bwd_dkv(x[0], x[1], x[2], x[5], x[4], p[0],
                                                                          causal=causal, qt=p[1])
                                 for x, p in zip(sets, pre)], iters=20)
        plain_fwd = cuda_ms([lambda x=sets[0]: flash_attention_plain(*x[:3], causal=causal)], iters=3, warmup=1)
        plain_bwd = cuda_ms([lambda x=sets[0]: flash_attention_bwd_plain(*x, causal=causal)], iters=3, warmup=1)
        lib_f, lib_b = cuda_ms(lib_fwd, iters=20), cuda_ms(lib_bwd, iters=20)
        shape = [b, s, hq, hkv, d]
        rows[label] = {
            "flash_attention": dict(shape=shape, causal=causal, ms=fwd_ms, enqueue_ms=fwd_enq, bound_ms=fb,
                                    bound_by=fby, plain_ms=plain_fwd, library_ms=lib_f, max_abs_err=fwd_err),
            "flash_attention_bwd_dq": dict(shape=shape, causal=causal, ms=dq_ms, enqueue_ms=dq_enq, bound_ms=qb,
                                           bound_by=qby, plain_ms=plain_bwd, library_ms=lib_b,
                                           max_abs_err=bwd_errs["dq"][0]),
            "flash_attention_bwd_dkv": dict(shape=shape, causal=causal, ms=dkv_ms, enqueue_ms=dkv_enq, bound_ms=kb,
                                            bound_by=kby, plain_ms=plain_bwd, library_ms=lib_b,
                                            max_abs_err=max(bwd_errs["dk"][0], bwd_errs["dv"][0])),
            "bit_identical_twice": identical, "ok": ok,
        }
        emit(phase, part=part, rank_shape=label, plain_ms_is="plain forward / plain backward (dQ+dK+dV)",
             library_ms_is="scaled_dot_product_attention forward / its backward", **rows[label])
        del q, k, v, o, lse, dout, again, lse2, ref_o, ref_lse, dq, dq2, dk, dk2, dv, dv2, rdq, rdk, rdv
        del sets, pre, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{phase} ({part}): {label} disagrees with plain or is not deterministic: "
                                 f"fwd {fwd_err}, bwd {bwd_errs}, identical {identical}")
    out[part] = rows
    results.setdefault("train_sharded_rank_shapes", {}).update(rows)


def phase_train_sharded(results):
    """Parallel training on this card: ranks of a training mesh, every one
    on cuda:0 over gloo under the explicit one-device rehearsal map (the
    machine has one card; which collectives gloo takes on CUDA tensors is
    probed first, and the refused ones are staged through host memory).
    (a) the main path through two containers, and beside it (its traffic
    is host-bound) the probe and (b) f32 parity of five meshes; then (c)
    #1-#3 at the rank shapes; see their functions."""
    import tempfile

    import torch

    from tpu_nexus_torch.workload.rehearsal import RankWorld

    torch.cuda.empty_cache()
    out = {}

    def probe_and_exact():
        # gloo's send/recv on a card's tensors may take its ranks down
        # rather than raise: probed in a world of its own
        job = "tpu_nexus_torch.parallel.collectives:probe"
        with RankWorld(2, device=SHARDED_DEVICE, timeout_s=120) as probe_world:
            try:
                probe = probe_world.run(job, device=SHARDED_DEVICE, p2p=True)[0]
            except RuntimeError as exc:
                probe = {"send_recv": f"the probe's ranks failed: {str(exc).splitlines()[0][:200]}"}
        with RankWorld(4, device=SHARDED_DEVICE, timeout_s=600) as world:
            if "all_reduce/float32" not in probe:
                probe.update(world.run(job, device=SHARDED_DEVICE)[0])
            staged = sorted({k.split("/")[0] for k, v in probe.items() if v != "ok"})
            emit("train_sharded", part="ranks", map="shared (every rank on cuda:0)", backend="gloo",
                 gloo_cuda_probe=probe, staged_through_host=staged,
                 containers_stage="send_recv always, and what the containers' own probe refuses")
            if any(name in staged for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")):
                raise AssertionError(f"train_sharded: gloo refuses an fsdp/tp collective on CUDA tensors: {probe}")
            t0 = time.perf_counter()
            sharded_train_exact(results, world, staged, out)
            emit("train_sharded_part_done", part="b", seconds=time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sharded_train_main_path(results, tmp, out, beside=probe_and_exact)
        emit("train_sharded_part_done", part="a (with b beside it)", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_train_rank_shapes(results, out)
    emit("train_sharded_part_done", part="c", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


# -- train_pp_ep ----------------------------------------------------------------

#: the main paths' steps
TRAIN_PP_EP_STEPS = 2
#: (c): depth, global batch and seed, and the meshes (spec, sp_attn) for
#: nexus_1b and (spec, dispatch, NEXUS_MOE_FORCE_EP_PATH, pp_microbatches)
#: for nexus_moe.  Scatter under pp runs ONE microbatch here: a
#: microbatch's capacity and aux losses are its own (so several would not
#: be one device's math); the CPU tests hold the port's microbatched MoE
#: pipeline to the JAX package's
TRAIN_PP_EP_EXACT_LAYERS, TRAIN_PP_EP_EXACT_BATCH, TRAIN_PP_EP_EXACT_SEED = 2, (8, 512), 37
TRAIN_PP_EP_EXACT_LLAMA = (({"pp": 2}, "ring"), ({"pp": 2, "fsdp": 2}, "ring"), ({"pp": 2, "sp": 2}, "ulysses"))
TRAIN_PP_EP_EXACT_MOE = (({"pp": 2}, "scatter", False, 1), ({"ep": 2}, "gmm", False, 0),
                         ({"ep": 2, "tp": 2}, "gmm", False, 0), ({}, "gmm", True, 0))
#: (d): #1-#3 at the pipeline's microbatch (nexus_1b, batch 8 over 8
#: microbatches: B1 S2048 Hq16 Hkv8) and #7/#8 at an ep-2 rank of
#: nexus_moe (T 16384, A 32768, bm 512: 68 budget tiles + the dumpster,
#: m_pad 35328; 4 local experts of ~8 tiles, the last one also owning the
#: unallocated tail and the dumpster; 16384 useful rows)
TRAIN_PP_EP_FLASH_SHAPES = (("pp2_microbatch", 1, 2048, 16, 8, True),)
TRAIN_PP_EP_GMM_TILES, TRAIN_PP_EP_GMM_USEFUL_ROWS = (9, 8, 9, 43), 16384


def _per_step(summary, steps, names):
    calls, nbytes = summary["collectives"]["calls"], summary["collectives"]["bytes"]
    return {n: {"calls": calls.get(n, 0) / steps, "bytes": nbytes.get(n, 0) / steps} for n in names}


def _one_device_step1(adapter, tc, batch):
    """Step 1's loss of ``adapter`` on one card from the seed-0 init on the
    host batch ``batch``."""
    import torch

    from tpu_nexus_torch.workload.train import init_train_state, make_train_step

    tokens = torch.from_numpy(batch).long().cuda()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), adapter, tc, "cuda")
    _, m = make_train_step(adapter, tc)(state, tokens)
    loss = float(m["loss"])
    del state, m, tokens
    torch.cuda.empty_cache()
    return loss


def pp_ep_exact(results, world, staged, out):
    """(c) f32 at full width and :data:`TRAIN_PP_EP_EXACT_LAYERS` layers
    (global batch :data:`TRAIN_PP_EP_EXACT_BATCH`, tokens from seed
    :data:`TRAIN_PP_EP_EXACT_SEED`): one adamw step with a one-step warmup
    (lr 0) at each mesh against one device, gated on the loss and grad norm
    within 1e-5 relative and every leaf's gradient (Adam's first moment)
    within 1e-5 x its max-abs."""
    import numpy as np
    import torch

    from tpu_nexus_torch.models.llama import LlamaConfig
    from tpu_nexus_torch.models.moe import MoeConfig
    from tpu_nexus_torch.workload.train import TrainConfig

    b, s = TRAIN_PP_EP_EXACT_BATCH
    job = "tpu_nexus_torch.workload.rehearsal:train_steps"
    f32 = dict(n_layers=TRAIN_PP_EP_EXACT_LAYERS, dtype=torch.float32, param_dtype=torch.float32)
    llama = dataclasses.replace(LlamaConfig.nexus_1b(), **f32)
    cases = [(llama, spec, attn, False, 0) for spec, attn in TRAIN_PP_EP_EXACT_LLAMA]
    cases += [(dataclasses.replace(MoeConfig.nexus_moe(), dispatch=dispatch, **f32), spec, "ring", force, mb)
              for spec, dispatch, force, mb in TRAIN_PP_EP_EXACT_MOE]
    rows, refs = [], {}
    t0 = time.perf_counter()
    for model, spec, attn, force, mb in cases:
        batches = [np.random.default_rng(TRAIN_PP_EP_EXACT_SEED).integers(0, model.vocab_size, (b, s)).astype(
            np.int32)]
        common = dict(model=model, batches=batches, device=SHARDED_DEVICE, stage=staged)
        if refs.get("key") != (type(model).__name__, model.dispatch if isinstance(model, MoeConfig) else ""):
            refs["key"] = (type(model).__name__, model.dispatch if isinstance(model, MoeConfig) else "")
            refs["one"] = world.run(job, spec={}, train_cfg=TrainConfig(warmup_steps=1, total_steps=4),
                                    reference="keep", **common)[0]
        ref = refs["one"]
        t1 = time.perf_counter()
        tc = TrainConfig(warmup_steps=1, total_steps=4, sp_attn=attn, pp_microbatches=mb)
        got = world.run(job, spec=spec, train_cfg=tc, reference="compare", force_ep=force, **common)[0]
        worst = max(err / scale for err, scale in got["first_moments"].values() if scale)
        ok = (all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(got["loss"], ref["loss"]))
              and all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(got["grad_norm"], ref["grad_norm"]))
              and worst <= 1e-5)
        rows.append(dict(model=type(model).__name__, dispatch=getattr(model, "dispatch", None), mesh=spec,
                         sp_attn=attn, force_ep_path=force, pp_microbatches=mb, loss=got["loss"],
                         one_device_loss=ref["loss"], grad_norm=got["grad_norm"],
                         one_device_grad_norm=ref["grad_norm"], worst_gradient_err_over_max=worst, ok=ok,
                         seconds=time.perf_counter() - t1, collectives_calls=got["collectives"]["calls"]))
        emit("train_pp_ep", part="c", **rows[-1])
        torch.cuda.empty_cache()
    out["c"] = dict(config=f"full width, {TRAIN_PP_EP_EXACT_LAYERS} layers, f32, adamw, global batch {b} x {s} "
                           f"(seed {TRAIN_PP_EP_EXACT_SEED}), 1 step (warmup 1: lr 0)", meshes=rows,
                    seconds=time.perf_counter() - t0)
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"train_pp_ep (c): meshes differ from one device in f32: {failed}")


def pp_ep_main_path(results, tmp, out, beside=None):
    """(a) nexus_1b at full width and depth, bf16, adamw, remat attn_out,
    ``NEXUS_MESH=pp=2`` over two containers (one rank each, on cuda:0 over
    gloo: the rehearsal map), :data:`TRAIN_PP_EP_STEPS` steps of 8 x 2048,
    a save at the last step; (b) nexus_moe at full size, gmm dispatch,
    ``NEXUS_MESH=ep=2`` over two containers the same way, the same steps,
    started with (a) (each run's rendezvous port is held for it).
    ``beside()`` runs on a thread from their start, and (a)'s restore while
    it may still.  Checks: every row COMPLETED with its keys at the
    last step; the kernels launched on every rank as the schedule says
    (per step: (a) 56 of each of #1-#3 a stage, 7 layers x 8 microbatches;
    (b) 72 of #7, 24 of #8 and 8 of each of #1-#3 a rank); each step-1 loss
    within 5e-3 of one device's on the same weights and batch; (a)'s saved
    step restored onto pp 2 and onto one device, leaf for leaf equal."""
    import numpy as np
    import torch

    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
    from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
    from tpu_nexus_torch.models.registry import get_adapter
    from tpu_nexus_torch.parallel.distributed import reserved_port
    from tpu_nexus_torch.workload.rehearsal import RankWorld
    from tpu_nexus_torch.workload.train import TrainConfig

    steps, batch, seq = TRAIN_PP_EP_STEPS, 8, 2048
    dense, moe = get_adapter("nexus_1b"), get_adapter("nexus_moe")
    tc = TrainConfig(warmup_steps=10, total_steps=steps)
    ckpt = os.path.join(tmp, "ckpt")
    base = {**{k: v for k, v in os.environ.items() if not k.startswith("NEXUS")},
            "NEXUS_MODE": "train", "NEXUS_BATCH": str(batch), "NEXUS_SEQ_LEN": str(seq), "NEXUS_STEPS": str(steps),
            "NEXUS_HEARTBEAT_EVERY": "1", "NEXUS_RANK_DEVICE_MAP": "shared", "NEXUS_DIST_TIMEOUT_S": "600",
            "NEXUS__CQL_STORE_TYPE": "sqlite"}
    runs = {
        "a": dict(run="train-pp", algorithm="nexus-1b", preset="nexus_1b", mesh="pp=2", processes=2,
                  extra={"NEXUS_CHECKPOINT_EVERY": str(steps), "NEXUS_CHECKPOINT_DIR": ckpt}),
        "b": dict(run="train-ep", algorithm="nexus-moe", preset="nexus_moe", mesh="ep=2", processes=2, extra={}),
    }
    for part, run in runs.items():
        run["ledger"] = os.path.join(tmp, f"ledger-{part}.db")
        # the launcher's order: the row first, then the containers
        store = SqliteCheckpointStore(run["ledger"])
        store.upsert_checkpoint(CheckpointedRequest(algorithm=run["algorithm"], id=run["run"],
                                                    lifecycle_stage=LifecycleStage.BUFFERED))
        store.close()
    procs, logs = {}, {}

    def start(part):
        run = runs[part]
        env = {**base, "NEXUS_MODEL_PRESET": run["preset"], "NEXUS_MESH": run["mesh"],
               "NEXUS_NUM_PROCESSES": str(run["processes"]), "NEXUS_RUN_ID": run["run"],
               "NEXUS_ALGORITHM": run["algorithm"], "NEXUS__SQLITE_STORE_PATH": run["ledger"],
               "NEXUS_COORDINATOR_ADDRESS": f"127.0.0.1:{run['port']}", **run["extra"]}
        for i in range(run["processes"]):
            logs[part, i] = os.path.join(tmp, f"{part}{i}.err")
            with open(logs[part, i], "w") as fh:
                procs[part, i] = subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], cwd=ROOT,
                                                  env={**env, "NEXUS_PROCESS_ID": str(i)},
                                                  stdout=subprocess.DEVNULL, stderr=fh)

    t0 = time.perf_counter()
    one = {}
    # both runs' rendezvous ports are held until their containers end, so
    # both runs and the work beside them start at once
    with contextlib.ExitStack() as held:
        for run in runs.values():
            run["port"] = held.enter_context(reserved_port())
        try:
            start("a")
            start("b")
            # beside() on a thread: it outlasts the containers, whose saved
            # step is restored below while it runs
            beside_done = _beside(beside) if beside is not None else (lambda: None)
            one["a"] = _one_device_step1(dense, tc, next(dense.data(batch, seq, seed=0)))
            one["b"] = _one_device_step1(moe, tc, next(moe.data(batch, seq, seed=0)))
            for p in procs.values():
                p.wait(timeout=900)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall = time.perf_counter() - t0
    errs = {key: Path(log).read_text() for key, log in logs.items()}
    failed = {key: p.returncode for key, p in procs.items() if p.returncode != 0}
    if failed:
        beside_done()
        raise AssertionError("train_pp_ep: containers exited " + "; ".join(
            f"{key}: {rc}\n{errs[key][-3000:]}" for key, rc in failed.items()))
    # per rank: one rank a container
    ranks = {part: [_summary_of(errs[part, i]) for i in range(2)] for part in runs}
    if any(r is None for rs in ranks.values() for r in rs):
        raise AssertionError(f"train_pp_ep: a rank's summary is missing: { {k: [r is None for r in v] for k, v in ranks.items()} }")
    with RankWorld(2, device=SHARDED_DEVICE, timeout_s=600) as world:
        restored = world.run("tpu_nexus_torch.workload.rehearsal:restore_on_mesh", directory=ckpt, step=steps,
                             spec={"pp": 2}, model=dense, train_cfg=tc, device=SHARDED_DEVICE)[0]
    beside_done()
    beside_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rows = {part: SqliteCheckpointStore(run["ledger"]).read_checkpoint(run["algorithm"], run["run"])
            for part, run in runs.items()}
    step1 = {part: _step_losses(errs[part, 0]).get(1) for part in runs}
    want_keys = {"host0/chip0": steps, "host1/chip0": steps}
    per_step = {"a": (56, 56, 56), "b": (8, 8, 8)}
    flash = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for part, config in (("a", "nexus_1b full width and depth, bf16, adamw, remat attn_out, global batch 8 x 2048, "
                               f"{steps} steps, pp 2 over 2 container processes (auto microbatches: 8 of B1)"),
                         ("b", "nexus_moe full size (8 layers, 8 experts of 2048, top-2), gmm dispatch, bf16, "
                               f"adamw, remat attn_out, global batch 8 x 2048, {steps} steps, ep 2 over 2 "
                               "container processes")):
        rs, row = ranks[part], rows[part]
        out[part] = dict(
            config=config, stage=row.lifecycle_stage if row else None,
            per_chip_steps=row.per_chip_steps if row else None, wall_s=wall, beside_s=beside_s,
            beside_is="seconds from the containers' start until (c) (on a thread), the one-device steps and "
                      "the restore had all finished",
            attention_launches_per_rank=[r["attention_launches"] for r in rs],
            grouped_matmul_launches_per_rank=[r["grouped_matmul_launches"] for r in rs],
            collectives_per_step_per_rank=[_per_step(r, steps, ("pp_send", "pp_recv", "pp_broadcast",
                                                                   "grad_all_reduce", "region_all_reduce",
                                                                   "data_all_reduce", "loss_all_reduce"))
                                           for r in rs],
            staged=rs[0]["collectives"]["staged"], losses_per_rank=[r["loss"] for r in rs],
            step1_loss=dict(parallel=step1[part], one_device=one[part], allowed=5e-3),
            dropped_frac_per_rank=[r.get("dropped_frac") for r in rs],
            tokens_per_second_rehearsal=rs[0]["tokens_per_second"],
            tokens_per_second_is="two ranks sharing one card over gloo (the rehearsal map), not a parallel speed",
            mfu_rehearsal=rs[0].get("goodput", {}).get("mfu"),
            **({"restore": restored} if part == "a" else {}),
        )
        emit("train_pp_ep", part=part, **out[part])
    for part in runs:
        rs, row = ranks[part], rows[part]
        if row is None or row.lifecycle_stage != LifecycleStage.COMPLETED or row.per_chip_steps != want_keys:
            raise AssertionError(f"train_pp_ep ({part}): row {row and row.lifecycle_stage} {row and row.per_chip_steps}")
        if any(r["attention_launches"][n] != per_step[part][i] * steps for r in rs for i, n in enumerate(flash)):
            raise AssertionError(f"train_pp_ep ({part}): flash launches {[r['attention_launches'] for r in rs]}")
        if step1[part] is None or abs(step1[part] - one[part]) > 5e-3 or len({r["loss"] for r in rs}) != 1:
            raise AssertionError(f"train_pp_ep ({part}): step-1 loss {step1[part]} vs one device {one[part]}, "
                                 f"final losses {[r['loss'] for r in rs]}")
    if any(r["grouped_matmul_launches"] != {"nexus_gmm": 72 * steps, "nexus_tgmm": 24 * steps} for r in ranks["b"]):
        raise AssertionError(f"train_pp_ep (b): grouped-matmul launches {out['b']['grouped_matmul_launches_per_rank']}")
    if any(out["a"]["collectives_per_step_per_rank"][i][n]["calls"] != 8 for i, n in ((0, "pp_send"), (1, "pp_recv"))):
        raise AssertionError(f"train_pp_ep (a): hand-offs {out['a']['collectives_per_step_per_rank']}")
    if restored is None or restored["differ"] or restored["leaves"] == 0:
        raise AssertionError(f"train_pp_ep (a): restores differ: {restored}")
    launches = results.setdefault("launches", {})
    launches["train_pp"] = {n: sum(r["attention_launches"][n] for r in ranks["a"]) for n in flash}
    launches["train_ep"] = {**{n: sum(r["attention_launches"][n] for r in ranks["b"]) for n in flash},
                            **{n: sum(r["grouped_matmul_launches"][n] for r in ranks["b"])
                               for n in ("nexus_gmm", "nexus_tgmm")}}


def pp_ep_gmm_rank_shape(results, out):
    """(d) #7 (gate/up, down, and the d_lhs call reading rhs transposed) and
    #8 at an ep-2 rank's padded layout of nexus_moe
    (:data:`TRAIN_PP_EP_GMM_TILES`), bf16: each against its plain version
    (the row-relative limit), twice bit-identical, then timed beside its
    bound over the launched rows and over the useful rows, its plain version
    and the library call (``torch._grouped_mm``; for #8 the loop of
    ``torch.matmul`` where ``_grouped_mm`` refuses the layout)."""
    import torch

    from tpu_nexus_torch.ops.grouped_matmul import gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain

    dt, bm, tiles = torch.bfloat16, 512, TRAIN_PP_EP_GMM_TILES
    te, e, m = tile_map(tiles), len(tiles), bm * sum(tiles)
    useful = TRAIN_PP_EP_GMM_USEFUL_ROWS
    rows = {}
    for key, what, k, n, kind in (("nexus_gmm", "gate/up", 1024, 2048, "gmm"), ("nexus_gmm_down", "down", 2048, 1024, "gmm"),
                                  ("nexus_gmm_dlhs", "d_lhs of gate/up, rhs read transposed", 2048, 1024, "gmm_t"),
                                  ("nexus_tgmm", "d_rhs of gate/up", 1024, 2048, "tgmm")):
        transpose = kind == "gmm_t"
        if kind == "tgmm":
            sets = []
            for i in range(2):
                g = torch.Generator(device="cuda").manual_seed(7600 + i)
                sets.append((torch.randn((m, k), generator=g, device="cuda").to(dt),
                             torch.randn((m, n), generator=g, device="cuda").to(dt)))
            kern = [lambda x=x: tgmm_kernel_call(x[0], x[1], te, e, bm) for x in sets]
            ref = tgmm_plain(sets[0][0], sets[0][1], te, e, bm)
            plain = lambda x=sets[0]: tgmm_plain(x[0], x[1], te, e, bm)  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], None, tiles, bm, tgmm_out=sets[0][1])
        else:
            sets = [gmm_inputs(m, k, n, e, dt, 7700 + i, transpose) for i in range(2)]
            kern = [lambda x=x: gmm_kernel_call(x[0], x[1], te, bm, transpose_rhs=transpose) for x in sets]
            rhs0 = sets[0][1].transpose(1, 2) if transpose else sets[0][1]
            ref = gmm_plain(sets[0][0], rhs0, te, bm)
            plain = lambda x=sets[0], r=rhs0: gmm_plain(x[0], r, te, bm)  # noqa: E731
            lib, lib_what = grouped_library(sets[0][0], rhs0, tiles, bm)
        got, again = kern[0](), kern[0]()
        torch.cuda.synchronize()
        ok, fields = _gmm_check(got, again, ref, dt)
        bound, by = gmm_bound(m, k, n, e, dt, tgmm=kind == "tgmm")
        bound_useful, by_useful = gmm_bound(useful, k, n, e, dt, tgmm=kind == "tgmm")
        ms, enqueue_ms = timed(kern, iters=20)
        rows[key] = dict(kernel=what, shape=[m, k, n, e], block_m=bm, tiles_per_expert=list(tiles), dtype="bfloat16",
                         ms=ms, enqueue_ms=enqueue_ms, bound_ms=bound, bound_by=by, bound_useful_rows_ms=bound_useful,
                         bound_useful_rows_by=by_useful, useful_rows=useful, plain_ms=event_ms(plain),
                         library_ms=cuda_ms([lib], iters=20), library_ms_is=lib_what, **fields)
        emit("train_pp_ep", part="d", rank_shape="ep2_rank", **rows[key])
        del sets, kern, plain, lib, got, again, ref
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"train_pp_ep (d): {what} at the ep-2 rank shape disagrees or is not deterministic")
    out["d_gmm"] = rows
    results["train_pp_ep_gmm_rank_shape"] = rows


def phase_train_pp_ep(results):
    """Pipeline- and expert-parallel training on this card, every rank on
    cuda:0 over gloo (the rehearsal map; the pipeline's hand-offs staged
    through host memory): (a) nexus_1b over pp 2 in two containers and (b)
    nexus_moe over ep 2, and beside them (c) f32 gradients of seven meshes
    against one device; then (d) the kernels at the new shapes."""
    import tempfile

    import torch

    from tpu_nexus_torch.workload.rehearsal import RankWorld

    torch.cuda.empty_cache()
    out = {}

    def exact():
        with RankWorld(4, device=SHARDED_DEVICE, timeout_s=600) as world:
            t0 = time.perf_counter()
            pp_ep_exact(results, world, ["send_recv"], out)
            emit("train_pp_ep_part_done", part="c", seconds=time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pp_ep_main_path(results, tmp, out, beside=exact)
        emit("train_pp_ep_part_done", part="a and b (with c beside them)", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_train_rank_shapes(results, out, TRAIN_PP_EP_FLASH_SHAPES, "train_pp_ep", "d")
    pp_ep_gmm_rank_shape(results, out)
    emit("train_pp_ep_part_done", part="d", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()


# -- serve_multiprocess ----------------------------------------------------------

#: (a): rounds of 8 requests of 128 + SERVE_MP_GEN, page 32, 8 slots
SERVE_MP_ROUNDS, SERVE_MP_GEN = 1, 32
#: each part's model: a preset and the fields replaced in its config
SERVE_MP_MODELS = {
    "a": ("llama3_8b", {"param_dtype": "bfloat16", "n_layers": 8}),
    "b": ("nexus_moe", {"n_layers": 4}),
    "c": ("nexus_1b", {"n_layers": 4, "dtype": "float32"}),
    "d": ("nexus_1b", {}),
}
TERMINAL_STAGES = ("COMPLETED", "PREEMPTED", "FAILED")


def smoke_model(preset: str, over: dict):
    """The config of ``preset`` with the fields of ``over`` replaced
    (dtypes by name)."""
    import torch

    from tpu_nexus_torch.models.registry import get_adapter

    cfg = get_adapter(preset).config
    over = {k: getattr(torch, v) if k.endswith("dtype") else v for k, v in over.items()}
    return dataclasses.replace(cfg, **over) if over else cfg


def _beside(fn, *args):
    """Run ``fn(*args)`` on a thread; returns a ``join()`` that re-raises
    its error."""
    box = {}

    def run():
        try:
            fn(*args)
        except BaseException as exc:  # noqa: BLE001 - handed to join()
            box["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]

    return join


@contextlib.contextmanager
def recorded_serving():
    """Record what the serving loops compute: every ``ServingEngine`` they
    build (``engines``) and the greedy tokens of every lockstep
    ``generate`` call (``calls``)."""
    import tpu_nexus_torch.serving as serving
    from tpu_nexus_torch.workload import serve

    seen = {"engines": [], "calls": []}
    engine_cls, generate = serving.ServingEngine, serve.generate

    class Recording(engine_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["engines"].append(self)

    def recording(params, prompts, *args, **kwargs):
        out = generate(params, prompts, *args, **kwargs)
        seen["calls"].append(out.tolist())
        return out

    serving.ServingEngine, serve.generate = Recording, recording
    try:
        yield seen
    finally:
        serving.ServingEngine, serve.generate = engine_cls, generate


def engine_tokens(engine) -> dict:
    """request id -> greedy tokens of every FINISHED request but the
    warm-up, in submission order."""
    from tpu_nexus_torch.serving import RequestState

    done = [r for r in engine.retired if r.request_id != "warmup-0" and r.state == RequestState.FINISHED]
    return {r.request_id: [int(t) for t in r.output_tokens]
            for r in sorted(done, key=lambda r: int(r.request_id.split("-")[1]))}


def serve_container() -> int:
    """One serving container for the serve_multiprocess phase
    (``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.serve_container())"``):
    ``tpu_nexus_torch.workload.__main__.main()`` itself — its
    ``ServeConfig.from_env``, its ledger store, its entry point by
    ``NEXUS_MODE`` and, in that, the entry point's own rank plan and pool —
    with recording around it:

    * ``SMOKE_MODEL`` (JSON) replaces fields of the preset's config
      (dtypes by name) in what ``ServeConfig.from_env`` returns;
    * the store counts this process's terminal writes, and holds the
      coordinator's until every process's key is in the row (at most 60 s:
      copies without a mesh end independently, and a heartbeat after the
      terminal write is dropped by the IsFinished guard; the serving loops
      themselves never wait);
    * every ``ServingEngine`` and lockstep ``generate`` call is recorded, and
      the entry point's summary;
    * ``SMOKE_FORCED`` (an ``.npz`` of ``prompts`` and ``tokens``; the
      process that leads a meshed engine): a separate step once serving is
      done, as the entry point closes its pool — the replica's
      teacher-forced logits along ``tokens``, saved beside the file.

    Printed on one ``SERVE_RESULT`` line: the greedy tokens of every
    finished request (engine) or ``generate`` call (lockstep), the terminal
    writes, the summary and the peak device memory."""
    import numpy as np
    import torch

    from tpu_nexus_torch.serving import sharded
    from tpu_nexus_torch.workload import __main__ as entry
    from tpu_nexus_torch.workload import serve

    from_env, store_from_env, close = serve.ServeConfig.from_env, entry.store_from_env, sharded.RankPool.close
    run_serving, run_serve_engine = serve.run_serving, serve.run_serve_engine
    forced, n_keys = os.environ.get("SMOKE_FORCED"), int(os.environ.get("NEXUS_NUM_PROCESSES", "1"))
    terminal, summaries = [], []

    def configured(env=None):
        cfg = from_env(env)
        if os.environ.get("SMOKE_MODEL"):
            cfg = dataclasses.replace(cfg, model=smoke_model(os.environ["NEXUS_MODEL_PRESET"],
                                                             json.loads(os.environ["SMOKE_MODEL"])))
        return cfg

    def counting_store(env=None):
        store = store_from_env(env)
        update = store.update_fields

        def counted(algorithm, id, fields):
            if fields.get("lifecycle_stage") in TERMINAL_STAGES:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and len(
                        store.read_checkpoint(algorithm, id).per_chip_steps or {}) < n_keys:
                    time.sleep(0.05)
                terminal.append(fields["lifecycle_stage"])
            return update(algorithm, id, fields)

        store.update_fields = counted
        return store

    def recorded(run):
        def call(*args, **kwargs):
            summaries.append(run(*args, **kwargs))
            return summaries[-1]

        return call

    def closing(pool):
        if forced and seen["engines"] and not pool._closed:
            data = np.load(forced)
            np.save(forced + ".logits.npy", _forced(seen["engines"][-1].executor.teacher_forced_logits,
                                                    data["prompts"], data["tokens"]))
        close(pool)

    serve.ServeConfig.from_env, entry.store_from_env = staticmethod(configured), counting_store
    serve.run_serving, serve.run_serve_engine = recorded(run_serving), recorded(run_serve_engine)
    sharded.RankPool.close = closing
    with recorded_serving() as seen:
        code = entry.main()
    summary = summaries[-1]
    tokens = engine_tokens(seen["engines"][-1]) if seen["engines"] else seen["calls"]
    keep = ("finished", "requests", "engine_steps", "decoded_tokens_per_second", "tpot_p50_s", "ttft_p50_s",
            "shard_stats", "engine_iterations", "ranks", "drained", "rounds", "elapsed_s")
    print("SERVE_RESULT " + json.dumps({"tokens": tokens, "terminal": terminal,
                                        "summary": {k: v for k, v in summary.items() if k in keep},
                                        "peak_memory": torch.cuda.max_memory_allocated()
                                        if torch.cuda.is_initialized() else 0}), flush=True)
    return code


class Containers:
    """``n`` launched processes of one run (``NEXUS_PROCESS_ID`` 0..n-1,
    ``NEXUS_NUM_PROCESSES`` n): its sqlite ledger seeded BUFFERED first (the
    launcher's order), each process's output in files under ``tmp``."""

    def __init__(self, tmp, name, n, argv=None, **env):
        from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
        from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
        from tpu_nexus_torch.parallel.distributed import free_port

        self.name, self.db = name, os.path.join(tmp, f"{name}.db")
        store = SqliteCheckpointStore(self.db)
        store.upsert_checkpoint(CheckpointedRequest(algorithm="serve", id=name,
                                                    lifecycle_stage=LifecycleStage.BUFFERED))
        store.close()
        base = {k: v for k, v in os.environ.items() if not k.startswith(("NEXUS", "SMOKE"))}
        base.update(NEXUS_RUN_ID=name, NEXUS_ALGORITHM="serve", NEXUS_DEVICE=SHARDED_DEVICE, NEXUS_TRACE="0",
                    NEXUS__CQL_STORE_TYPE="sqlite", NEXUS__SQLITE_STORE_PATH=self.db, NEXUS_DIST_TIMEOUT_S="300",
                    NEXUS_NUM_PROCESSES=str(n), PYTHONPATH=str(ROOT))
        if n > 1:
            base["NEXUS_COORDINATOR_ADDRESS"] = f"127.0.0.1:{free_port()}"
        base.update({k: str(v) for k, v in env.items()})
        argv = argv or ["-c", "import chip_smoke, sys; sys.exit(chip_smoke.serve_container())"]
        self.logs = [(os.path.join(tmp, f"{name}.{i}.out"), os.path.join(tmp, f"{name}.{i}.err")) for i in range(n)]
        self.t0 = time.perf_counter()
        self.procs = []
        for i, (out, err) in enumerate(self.logs):
            with open(out, "w") as fo, open(err, "w") as fe:  # files: a full pipe would stall a container
                self.procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, stdout=fo, stderr=fe,
                                                   env={**base, "NEXUS_PROCESS_ID": str(i)}))

    def row(self):
        from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore

        store = SqliteCheckpointStore(self.db)
        try:
            return store.read_checkpoint("serve", self.name)
        finally:
            store.close()

    def wait_for_keys(self, n, timeout=300.0):
        """Until ``n`` heartbeat keys are in the row (or a process ended)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and all(p.poll() is None for p in self.procs):
            row = self.row()
            if row is not None and len(row.per_chip_steps or {}) >= n:
                return row
            time.sleep(0.2)
        raise AssertionError(f"serve_multiprocess {self.name}: {n} heartbeat keys never arrived: "
                             f"{self.tail()}")

    def wait(self, timeout=600.0):
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        self.wall_s = time.perf_counter() - self.t0
        return [p.returncode for p in self.procs]

    def results(self):
        out = []
        for path, _err in self.logs:
            lines = [x for x in Path(path).read_text().splitlines() if x.startswith("SERVE_RESULT ")]
            out.append(json.loads(lines[-1][len("SERVE_RESULT "):]) if lines else None)
        return out

    def tail(self, n=3000):
        """Each process's standard error: its last ``n`` characters (all of
        it for None)."""
        return {i: Path(err).read_text()[-n:] if n else Path(err).read_text()
                for i, (_out, err) in enumerate(self.logs)}

    def check(self, codes=None):
        got = self.wait()
        if got != (codes or [0] * len(self.procs)):
            raise AssertionError(f"serve_multiprocess {self.name}: exit codes {got}: {self.tail()}")
        return self.results()


def _collectives_per_step(stats, steps):
    """Each rank's collectives a step: calls and bytes by name."""
    return [{name: {"calls": s["collectives"]["calls"][name] / steps, "bytes": s["collectives"]["bytes"][name] / steps}
             for name in s["collectives"]["calls"]} for s in stats]


def mp_main_path(results, tmp, out, pool):
    """(a) llama3_8b at full width, 8 of its 32 layers (depth cut for the
    script's time), bf16 params, tp 2 over two
    launched containers (one rank each, both on cuda:0): page 32, 8 slots,
    ``SERVE_MP_ROUNDS`` x 8 requests of 128 + 32 from seed 0.  Beside them
    the in-container tp-2 replica (``pool``: PR 17's path) serves the same
    requests, slots and seed.  Gates: the row COMPLETED with host0/chip0 and
    host1/chip0, written once by the coordinator; each rank's #1 and #4
    launches whole multiples of the 32 layers and equal to the in-container
    replica's; the greedy tokens equal it request for request."""
    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    preset, over = SERVE_MP_MODELS["a"]
    model = smoke_model(preset, over)
    knobs = dict(NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET=preset, NEXUS_PAGE_SIZE=32, NEXUS_BATCH=8,
                 NEXUS_PROMPT_LEN=SHARDED_PROMPT, NEXUS_GEN_TOKENS=SERVE_MP_GEN, NEXUS_STEPS=SERVE_MP_ROUNDS,
                 NEXUS_SERVE_MESH="tp=2", NEXUS_RANK_DEVICE_MAP="shared", SMOKE_MODEL=json.dumps(over))
    run = Containers(tmp, "mp-a", 2, **knobs)
    cfg = ServeConfig(model=model, batch_size=8, prompt_len=SHARDED_PROMPT, gen_tokens=SERVE_MP_GEN,
                      rounds=SERVE_MP_ROUNDS, device=SHARDED_DEVICE, page_size=32, serve_mesh="tp=2",
                      rank_map="shared")
    pool.reset_counts()
    with recorded_serving() as seen:
        ref = run_serve_engine(cfg, store=InMemoryCheckpointStore(), pool=pool,
                               ctx=ProcessContext("mp-a", "serve", 0, 1, None))
    ref.pop("replica").close()
    want = engine_tokens(seen["engines"][-1])
    p0, p1 = run.check()
    row = run.row()
    stats = p0["summary"]["shard_stats"]
    per_rank, ref_rank = _rank_launches(stats), _rank_launches(ref["shard_stats"])
    steps = p0["summary"]["engine_steps"]
    out["a"] = dict(
        config=f"{preset} {over} at full width, page 32, 8 slots, {8 * SERVE_MP_ROUNDS} requests x "
               f"({SHARDED_PROMPT} + {SERVE_MP_GEN}), tp 2 over 2 launched containers",
        stage=row.lifecycle_stage, per_chip_steps=row.per_chip_steps, terminal_writes=[p0["terminal"], p1["terminal"]],
        wall_s=run.wall_s, finished=p0["summary"]["finished"], engine_steps=steps,
        decoded_tokens_per_second=p0["summary"]["decoded_tokens_per_second"],
        tpot_p50_s=p0["summary"]["tpot_p50_s"], ttft_p50_s=p0["summary"]["ttft_p50_s"],
        in_container_decoded_tokens_per_second=ref["decoded_tokens_per_second"],
        tokens_per_second_is="two ranks in two processes sharing one card over gloo (a rehearsal)",
        launches_per_rank=per_rank, in_container_launches_per_rank=ref_rank,
        collectives_per_step_per_rank=_collectives_per_step(stats, steps),
        peak_memory_per_process=[p0["peak_memory"], p1["peak_memory"]],
        worker_engine_iterations=p1["summary"]["engine_iterations"],
        tokens_equal_in_container=p0["tokens"] == want, requests=len(want),
    )
    emit("serve_multiprocess", part="a", **out["a"])
    results.setdefault("launches", {})["serve_multiprocess"] = {
        "flash_attention": sum(c["flash_attention"] for c in per_rank), "decode_attention_paged": _paged_launches(stats)}
    layers = model.n_layers
    if row.lifecycle_stage != LifecycleStage.COMPLETED or set(row.per_chip_steps) != {"host0/chip0", "host1/chip0"} \
            or out["a"]["terminal_writes"] != [["COMPLETED"], []]:
        raise AssertionError(f"serve_multiprocess (a): row {row.lifecycle_stage} {row.per_chip_steps}, "
                             f"terminal writes {out['a']['terminal_writes']}")
    if [s["rank"] for s in stats] != [0, 1] or per_rank != ref_rank or any(
            not c["flash_attention"] or c["flash_attention"] % layers
            or not c["decode_attention"] or c["decode_attention"] % layers for c in per_rank):
        raise AssertionError(f"serve_multiprocess (a): launches {per_rank}, in the container {ref_rank}")
    if not out["a"]["tokens_equal_in_container"] or len(want) != 8 * SERVE_MP_ROUNDS:
        raise AssertionError("serve_multiprocess (a): the tokens differ from the in-container tp-2 replica's")


def mp_replicate(results, tmp, out, pool):
    """(b) nexus_moe at full width, 4 of its 8 layers (depth cut for the
    script's time), bf16, one container over
    ``dp=2,ep=2`` (four ranks: two copies of an ep-2 region), 8 requests of
    128 + 16; the in-container ep-2 replica serves the same.  Gates:
    COMPLETED; the tokens equal ep 2's; the copies' #1 and #4 launches
    equal; each rank's expert sum runs over its copy's two ranks, with the
    all-reduce bytes of an ep-2 rank."""
    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    preset, over = SERVE_MP_MODELS["b"]
    knobs = dict(NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET=preset, NEXUS_BATCH=8,
                 NEXUS_PROMPT_LEN=SHARDED_PROMPT, NEXUS_GEN_TOKENS=16, NEXUS_STEPS=1,
                 NEXUS_SERVE_MESH="dp=2,ep=2", NEXUS_RANK_DEVICE_MAP="shared", SMOKE_MODEL=json.dumps(over))
    run = Containers(tmp, "mp-b", 1, **knobs)
    cfg = ServeConfig(model=smoke_model(preset, over), batch_size=8, prompt_len=SHARDED_PROMPT, gen_tokens=16,
                      rounds=1, device=SHARDED_DEVICE, serve_mesh="ep=2", rank_map="shared")
    pool.reset_counts()
    with recorded_serving() as seen:
        ref = run_serve_engine(cfg, store=InMemoryCheckpointStore(), pool=pool,
                               ctx=ProcessContext("mp-b", "serve", 0, 1, None))
    ref.pop("replica").close()
    want = engine_tokens(seen["engines"][-1])
    (p0,) = run.check()
    row = run.row()
    stats = p0["summary"]["shard_stats"]
    per_rank = _rank_launches(stats)
    copies = [(0, 1), (2, 3)]
    reduce_bytes = [s["collectives"]["bytes"].get("all_reduce", 0) for s in stats]
    ep2_bytes = [s["collectives"]["bytes"].get("all_reduce", 0) for s in ref["shard_stats"]]
    out["b"] = dict(
        config=f"{preset} {over} at full width, dp 2 x ep 2 in one container (4 ranks), 8 x (128 + 16)",
        stage=row.lifecycle_stage, wall_s=run.wall_s, finished=p0["summary"]["finished"],
        tokens_equal_ep2=p0["tokens"] == want, launches_per_rank=per_rank,
        moe_groups=[s["groups"]["moe"] for s in stats], all_reduce_bytes_per_rank=reduce_bytes,
        ep2_all_reduce_bytes_per_rank=ep2_bytes,
        decoded_tokens_per_second=p0["summary"]["decoded_tokens_per_second"],
        ep2_decoded_tokens_per_second=ref["decoded_tokens_per_second"],
    )
    emit("serve_multiprocess", part="b", **out["b"])
    if row.lifecycle_stage != LifecycleStage.COMPLETED or not out["b"]["tokens_equal_ep2"]:
        raise AssertionError(f"serve_multiprocess (b): row {row.lifecycle_stage}, tokens equal "
                             f"{out['b']['tokens_equal_ep2']}")
    if any(per_rank[a] != per_rank[b] for a, b in zip(*copies)) or not per_rank[0]["flash_attention"] \
            or out["b"]["moe_groups"] != [[0, 1], [0, 1], [2, 3], [2, 3]] \
            or reduce_bytes != ep2_bytes * 2:
        raise AssertionError(f"serve_multiprocess (b): {out['b']}")


def mp_exact(results, tmp, out):
    """(c) nexus_1b at full width, 4 of 14 layers, f32 compute (bf16
    params), 8 requests of 64 + 16: tp 2 over two launched containers
    (contiguous) and one container at ``pp=2,tp=2`` (paged, page 32), each
    against the one-device f32 engine through the same entry point
    (``run_serve_engine``, the same schedule).  Gates: greedy tokens
    identical; and, in a separate step of the container that leads the
    replica, once serving is done and before its entry point closes the
    pool (``serve_container``'s ``SMOKE_FORCED``), the replica's
    teacher-forced logits of the requests along the one-device stream
    within 1e-5 x max|ref| of the one-device evaluation."""
    import numpy as np
    import torch

    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.models.llama import llama_init
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

    preset, over = SERVE_MP_MODELS["c"]
    model = smoke_model(preset, over)
    runs = {"tp2_two_containers": (2, "tp=2", 0), "pp2xtp2_one_container": (1, "pp=2,tp=2", 32)}
    started, refs = {}, {}
    for name, (n, mesh, page) in runs.items():
        cfg = ServeConfig(model=model, batch_size=8, prompt_len=64, gen_tokens=16, rounds=1, device=SHARDED_DEVICE,
                          page_size=page)
        with recorded_serving() as seen:
            run_serve_engine(cfg, store=InMemoryCheckpointStore(), ctx=ProcessContext("one", "serve", 0, 1, None))
        want = engine_tokens(seen["engines"][-1])
        prompt_of = {r.request_id: r.prompt for r in seen["engines"][-1].retired}
        prompts = np.asarray([prompt_of[rid] for rid in want], np.int32)
        tokens = np.asarray(list(want.values()), np.int32)
        params = llama_init(torch.Generator(device=SHARDED_DEVICE).manual_seed(0), model, device=SHARDED_DEVICE)
        one_logits = _forced(_one_device_forced(params, model), prompts, tokens)
        del params
        torch.cuda.empty_cache()
        forced = os.path.join(tmp, f"forced-{name}.npz")
        np.savez(forced, prompts=prompts, tokens=tokens)
        refs[name] = (want, one_logits, forced)
        started[name] = Containers(tmp, f"mp-c-{name}", n, NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET=preset,
                                   NEXUS_BATCH=8, NEXUS_PROMPT_LEN=64, NEXUS_GEN_TOKENS=16, NEXUS_STEPS=1,
                                   NEXUS_PAGE_SIZE=page, NEXUS_SERVE_MESH=mesh, NEXUS_RANK_DEVICE_MAP="shared",
                                   SMOKE_MODEL=json.dumps(over), SMOKE_FORCED=forced)
    out["c"] = {}
    for name, run in started.items():
        p0 = run.check()[0]
        want, one_logits, forced = refs[name]
        got = np.load(forced + ".logits.npy")
        err = float(np.abs(got - one_logits).max()) / float(np.abs(one_logits).max())
        out["c"][name] = dict(tokens_identical=p0["tokens"] == want, requests=len(want),
                              teacher_forced_max_err_over_max=err, stage=run.row().lifecycle_stage, wall_s=run.wall_s)
    emit("serve_multiprocess", part="c", config=f"{preset} {over}, 8 x (64 + 16)", **out["c"])
    bad = {k: v for k, v in out["c"].items() if not v["tokens_identical"] or v["requests"] != 8
           or v["teacher_forced_max_err_over_max"] > 1e-5}
    if bad:
        raise AssertionError(f"serve_multiprocess (c): {bad}")


def mp_lockstep(results, tmp, out):
    """(d) The lockstep loop (``NEXUS_MODE=serve``) on nexus_1b, bf16,
    two launched containers, no mesh, 2 rounds of 8 x (128 + 32): each
    process's greedy tokens equal a one-process run's; the row COMPLETED,
    written once by the coordinator, with both processes' keys (the
    coordinator's at round 2).  Starts
    the containers and runs the one-process reference; returns the check,
    to call once the work beside the containers is done."""
    from tpu_nexus_torch.checkpoint.models import LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

    preset, over = SERVE_MP_MODELS["d"]
    run = Containers(tmp, "mp-d", 2, NEXUS_MODE="serve", NEXUS_MODEL_PRESET=preset, NEXUS_BATCH=8,
                     NEXUS_PROMPT_LEN=SHARDED_PROMPT, NEXUS_GEN_TOKENS=32, NEXUS_STEPS=2, NEXUS_HEARTBEAT_EVERY=1,
                     SMOKE_MODEL=json.dumps(over))
    cfg = ServeConfig(model=smoke_model(preset, over), batch_size=8, prompt_len=SHARDED_PROMPT, gen_tokens=32,
                      rounds=2, heartbeat_every=1, device=SHARDED_DEVICE)
    with recorded_serving() as seen:
        run_serving(cfg, store=InMemoryCheckpointStore(), ctx=ProcessContext("one", "serve", 0, 1, None))

    def check():
        p0, p1 = run.check()
        row = run.row()
        out["d"] = dict(stage=row.lifecycle_stage, per_chip_steps=row.per_chip_steps, wall_s=run.wall_s,
                        terminal_writes=[p0["terminal"], p1["terminal"]],
                        tokens_equal_one_process=[p0["tokens"] == seen["calls"], p1["tokens"] == seen["calls"]],
                        generate_calls=len(seen["calls"]))
        emit("serve_multiprocess", part="d", config=f"{preset} {over} lockstep, 2 containers, 3 x 8 x (128 + 32)",
             **out["d"])
        if row.lifecycle_stage != LifecycleStage.COMPLETED or set(row.per_chip_steps) != {
                "host0/chip0", "host1/chip0"} or row.per_chip_steps["host0/chip0"] != 2 \
                or out["d"]["terminal_writes"] != [["COMPLETED"], []] \
                or out["d"]["tokens_equal_one_process"] != [True] * 2:
            raise AssertionError(f"serve_multiprocess (d): {out['d']}")

    return check


def mp_drills(results, tmp, out):
    """(e) Two tp-2 replicas of nexus_1b (bf16) over two launched
    ``python -m tpu_nexus_torch.workload`` containers each, 8 x (64 + 64) a
    round for many rounds; once both rows hold both keys, SIGTERM to both
    containers of one (PREEMPTED with the retirement counts, both exit 0)
    and SIGKILL to the worker container of the other (the leader's exits
    non-zero within ``NEXUS_DIST_TIMEOUT_S`` = 60 s, the row FAILED naming
    rank 1).  Beside them a third tp-2 replica in one container, whose
    spawned shard worker (rank 1, a child of the leader's ``RankPool``) is
    SIGKILLed once its row heartbeats: the container exits non-zero within
    the timeout, the row FAILED naming rank 1."""
    import signal as _signal

    from tpu_nexus_torch.checkpoint.models import LifecycleStage

    knobs = dict(NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET=SERVE_MP_MODELS["d"][0], NEXUS_BATCH=8,
                 NEXUS_PROMPT_LEN=64, NEXUS_GEN_TOKENS=64, NEXUS_STEPS=1000, NEXUS_HEARTBEAT_EVERY=1,
                 NEXUS_SERVE_MESH="tp=2", NEXUS_RANK_DEVICE_MAP="shared", NEXUS_DIST_TIMEOUT_S=60,
                 NEXUS_DRAIN_GRACE_S=2)
    argv = ["-m", "tpu_nexus_torch.workload"]
    term = Containers(tmp, "mp-e-term", 2, argv=argv, **knobs)
    kill = Containers(tmp, "mp-e-kill", 2, argv=argv, **knobs)
    lost = Containers(tmp, "mp-e-lost", 1, argv=argv, **knobs)
    term.wait_for_keys(2)
    kill.wait_for_keys(2)
    lost.wait_for_keys(1)
    worker = re.search(r"started shard worker rank 1 pid (\d+)", lost.tail(None)[0])
    if worker is None:
        raise AssertionError(f"serve_multiprocess (e): the one-container replica logged no shard worker: "
                             f"{lost.tail()}")
    for p in term.procs:
        p.send_signal(_signal.SIGTERM)
    kill.procs[1].kill()
    os.kill(int(worker.group(1)), _signal.SIGKILL)
    t0 = time.monotonic()
    kill_codes = kill.wait(timeout=180)
    kill_s = time.monotonic() - t0
    lost_codes = lost.wait(timeout=180)
    lost_s = time.monotonic() - t0
    term_codes = term.wait(timeout=180)
    term_s = time.monotonic() - t0
    trow, krow, lrow = term.row(), kill.row(), lost.row()
    causes = json.loads(trow.algorithm_failure_details or "{}").get("retired_causes")
    out["e"] = dict(
        sigterm=dict(exit_codes=term_codes, seconds_signal_to_exit=term_s, stage=trow.lifecycle_stage,
                     per_chip_steps=trow.per_chip_steps, retired_causes=causes,
                     worker_served_on="served on through the leader's drain" in term.tail(None)[1]),
        sigkill=dict(exit_codes=kill_codes, seconds_kill_to_exit=kill_s, stage=krow.lifecycle_stage,
                     cause=(krow.algorithm_failure_cause or "")[:240]),
        sigkill_spawned_worker=dict(exit_codes=lost_codes, seconds_kill_to_exit=lost_s, stage=lrow.lifecycle_stage,
                                    cause=(lrow.algorithm_failure_cause or "")[:240]),
    )
    emit("serve_multiprocess", part="e", **out["e"])
    if term_codes != [0, 0] or trow.lifecycle_stage != LifecycleStage.PREEMPTED or not causes \
            or not out["e"]["sigterm"]["worker_served_on"]:
        raise AssertionError(f"serve_multiprocess (e): SIGTERM {out['e']['sigterm']}")
    for name, codes, secs, row in (("sigkill", kill_codes, kill_s, krow),
                                   ("sigkill_spawned_worker", lost_codes, lost_s, lrow)):
        if codes[0] in (0, None) or secs > 60.0 or row.lifecycle_stage != LifecycleStage.FAILED \
                or "rank(s) [1] stopped answering" not in (row.algorithm_failure_cause or ""):
            raise AssertionError(f"serve_multiprocess (e): {name} {out['e'][name]}")


def mp_rank_shape_kernels(results, out):
    """#1 and #4 at the shapes part (b)'s ranks meet (nexus_moe keeps its
    heads whole under ep: Hq 8, Hkv 4, D 128, bf16): the prefill's flash
    forward (B1 S128, causal) and the contiguous decode step (B8, cache 144
    = 128 + 16, kv 136), each against its plain version (the parity
    phase's bf16 limits), twice bit-identical, then timed beside its bound,
    its plain version and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

    dt, hq, hkv, d = torch.bfloat16, 8, 4, 128
    rows = {}
    q, k, v = flash_inputs(1, 128, hq, hkv, d, dt, seed=9300)
    (o, lse), (o2, lse2) = flash_attention(q, k, v, causal=True), flash_attention(q, k, v, causal=True)
    ref_o, ref_lse = flash_attention_plain(q, k, v, causal=True)
    sets = [flash_inputs(1, 128, hq, hkv, d, dt, seed=9310 + i) for i in range(32)]
    lib_sets = [(x.transpose(1, 2), y.transpose(1, 2), z.transpose(1, 2)) for x, y, z in sets]
    bound, by = flash_bound(1, 128, hq, hkv, d, dt)
    ms, enqueue_ms = timed([lambda x=x: flash_attention(*x, causal=True) for x in sets], iters=64)
    rows["flash_attention"] = dict(
        shape=[1, 128, hq, hkv, d], causal=True, max_abs_err=max_err(o, ref_o), lse_err=max_err(lse, ref_lse),
        worst_row_rel_l2=row_rel_err(o, ref_o), bit_identical=bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
        ms=ms, enqueue_ms=enqueue_ms,
        plain_ms=cuda_ms([lambda x=x: flash_attention_plain(*x, causal=True) for x in sets], iters=16),
        library_ms=cuda_ms([lambda x=x: F.scaled_dot_product_attention(*x, is_causal=True, enable_gqa=True)
                            for x in lib_sets], iters=64), bound_ms=bound, bound_by=by)
    b, max_len, kv_len = 8, 144, 136
    q, k, v = decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=9400)
    got, again = decode_attention(q, k, v, kv_len), decode_attention(q, k, v, kv_len)
    ref = decode_attention_plain(q, k, v, kv_len)
    layers = [decode_inputs(b, 1, max_len, hq, hkv, d, dt, seed=9410 + i) for i in range(32)]
    lib_sets = [(x.transpose(1, 2), y[:, :kv_len].transpose(1, 2), z[:, :kv_len].transpose(1, 2))
                for x, y, z in layers]
    bound, by = decode_bound(b, 1, kv_len, hq, hkv, d, dt)
    ms, enqueue_ms = timed([lambda x=x: decode_attention(*x, kv_len) for x in layers], iters=64)
    rows["decode_attention"] = dict(
        shape=[b, 1, max_len, kv_len, hq, hkv, d], max_abs_err=max_err(got, ref), worst_row_rel_l2=row_rel_err(got, ref),
        bit_identical=bool(torch.equal(got, again)), ms=ms, enqueue_ms=enqueue_ms,
        plain_ms=cuda_ms([lambda x=x: decode_attention_plain(*x, kv_len) for x in layers], iters=32),
        library_ms=cuda_ms([lambda x=x: F.scaled_dot_product_attention(*x, enable_gqa=True) for x in lib_sets],
                           iters=64), bound_ms=bound, bound_by=by)
    del sets, lib_sets, layers
    torch.cuda.empty_cache()
    out["rank_shapes"] = results["serve_multiprocess_rank_shapes"] = rows
    emit("serve_multiprocess", part="rank_shapes", config="nexus_moe's ep-2 rank (heads whole), bf16",
         library_ms_is="scaled_dot_product_attention", **rows)
    f, dd = rows["flash_attention"], rows["decode_attention"]
    if not (f["bit_identical"] and dd["bit_identical"] and f["max_abs_err"] <= TOL["bfloat16"][0]
            and f["lse_err"] <= TOL["bfloat16"][1] and dd["max_abs_err"] <= TOL["bfloat16"][0]
            and max(f["worst_row_rel_l2"], dd["worst_row_rel_l2"]) <= ROW_REL_TOL):
        raise AssertionError(f"serve_multiprocess (rank shapes): {rows}")


def phase_serve_multiprocess(results):
    """Serving across launched processes and over a replicate axis, every
    rank on cuda:0 over gloo (the rehearsal map): (a) llama3_8b tp 2 over
    two containers beside the in-container tp-2 replica, (b) nexus_moe
    dp 2 x ep 2 in one container beside the ep-2 replica, (c) nexus_1b f32
    tp 2 over two containers and pp 2 x tp 2 in one against one device,
    (d) the lockstep loop over two containers, (e) the SIGTERM and SIGKILL
    drills; (e)'s containers run beside (b), (c) and (d), (d)'s beside (c).
    Then #1 and #4 at (b)'s rank shapes."""
    import tempfile

    import torch

    from tpu_nexus_torch.serving.sharded import RankPool

    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with RankPool(2, device=SHARDED_DEVICE, rank_map="shared", timeout_s=300.0) as pool:
            mp_main_path(results, tmp, out, pool)
            emit("serve_multiprocess_part_done", part="a", seconds=time.perf_counter() - t0)
            t1 = time.perf_counter()
            drills = _beside(mp_drills, results, tmp, out)
            mp_replicate(results, tmp, out, pool)
            emit("serve_multiprocess_part_done", part="b", seconds=time.perf_counter() - t1)
        torch.cuda.empty_cache()
        lockstep = mp_lockstep(results, tmp, out)
        mp_exact(results, tmp, out)
        emit("serve_multiprocess_part_done", part="c", seconds=time.perf_counter() - t1)
        lockstep()
        emit("serve_multiprocess_part_done", part="d (beside c)", seconds=time.perf_counter() - t1)
        drills()
        emit("serve_multiprocess_part_done", part="e (beside b, c and d)", seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    mp_rank_shape_kernels(results, out)
    emit("serve_multiprocess_part_done", part="rank shapes", seconds=time.perf_counter() - t1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases among " + ",".join(PHASES + OPT_IN) + " (default: all but the opt-in "
        + ",".join(OPT_IN) + ")",
    )
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(OPT_IN)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to test", file=sys.stderr)
        return 2
    if not (ROOT / "tpu_nexus_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpu_nexus_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu_nexus_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    results = {}
    if "build" in phases:
        t0 = time.perf_counter()
        _build.library()
        emit("build", seconds=time.perf_counter() - t0, library=str(_build.library_path().name),
             sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
             **hopper_kernel_resources(_build))
    runners = {
        "parity": phase_parity, "train_parity": phase_train_parity, "times": phase_times,
        "e2e": phase_e2e, "train_e2e": phase_train_e2e, "serve": phase_serve, "serve_quant": phase_serve_quant,
        "train": phase_train, "moe_parity": phase_moe_parity, "moe_train_e2e": phase_moe_train_e2e,
        "serve_moe": phase_serve_moe, "train_moe": phase_train_moe,
        "engine_parity": phase_engine_parity, "engine_e2e": phase_engine_e2e, "serve_engine": phase_serve_engine,
        "profile": phase_profile, "train_profile": phase_train_profile,
        "train_moe_profile": phase_train_moe_profile, "decode_probe": phase_decode_probe,
        "profile_int8": lambda r: phase_profile(r, "int8", "int8"),
        "profile_int4": lambda r: phase_profile(r, "int4", ""),
        "quant_rms_times": phase_quant_rms_times, "int4_probe": phase_int4_probe, "int8_probe": phase_int8_probe,
        "train_ckpt": phase_train_ckpt, "serve_reload": phase_serve_reload, "ckpt_probe": phase_ckpt_probe,
        "fleet": phase_fleet, "disagg": phase_disagg, "fleet_rollout": phase_fleet_rollout,
        "serve_moe_quant": phase_serve_moe_quant, "quant_gate": phase_quant_gate, "profile_hook": phase_profile_hook,
        "control_plane": phase_control_plane, "fleet_supervisor": phase_fleet_supervisor,
        "cql_ledger": phase_cql_ledger, "serve_sharded": phase_serve_sharded,
        "train_sharded": phase_train_sharded, "train_pp_ep": phase_train_pp_ep,
        "serve_multiprocess": phase_serve_multiprocess,
    }
    # quant_gate (the card busy, the host idle) runs on a thread beside the
    # phases of BESIDE_QUANT_GATE (the card idle, the host starting their
    # containers), from the end of control_plane's OOM container on
    beside = []

    def join_beside():
        for t0, done in beside:
            done()
            emit("quant_gate_done", seconds=time.perf_counter() - t0, beside=BESIDE_QUANT_GATE)
        beside.clear()

    if {"quant_gate", "control_plane"} <= set(phases):
        runners["control_plane"] = lambda r: phase_control_plane(r, after_oom=lambda: beside.append(
            (time.perf_counter(), _beside(phase_quant_gate, r))))
        del runners["quant_gate"]
    for name in PHASES + OPT_IN:
        if name in runners and name in phases:
            if name not in BESIDE_QUANT_GATE:
                join_beside()
            t0 = time.perf_counter()
            runners[name](results)
            emit(name + "_done", seconds=time.perf_counter() - t0)

    join_beside()
    if set(PHASES) <= set(phases):
        # (source, TPU kernel it replaces, the main path whose run counts it)
        meta = {
            "flash_attention": ("tpu_nexus_torch/csrc/flash_attention.cu",
                                "tpu_nexus/ops/flash_attention.py:127", "train"),
            "flash_attention_bwd_dq": ("tpu_nexus_torch/csrc/flash_attention_bwd.cu",
                                       "tpu_nexus/ops/flash_attention.py:242", "train"),
            "flash_attention_bwd_dkv": ("tpu_nexus_torch/csrc/flash_attention_bwd.cu",
                                        "tpu_nexus/ops/flash_attention.py:297", "train"),
            "decode_attention": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                 "tpu_nexus/ops/decode_attention.py:125", "serve"),
            "decode_attention_int8kv": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                        "tpu_nexus/ops/decode_attention.py:125", "serve_int8"),
            "quant_matmul_int8": ("tpu_nexus_torch/csrc/quant_matmul.cu",
                                  "tpu_nexus/ops/quant_matmul.py:131", "serve_int8"),
            "quant_matmul_int4": ("tpu_nexus_torch/csrc/quant_matmul.cu",
                                  "tpu_nexus/ops/quant_matmul.py:154", "serve_int4"),
            "nexus_gmm": ("tpu_nexus_torch/csrc/grouped_matmul.cu",
                          "tpu_nexus/ops/grouped_matmul.py:68", "train_moe"),
            "nexus_tgmm": ("tpu_nexus_torch/csrc/grouped_matmul.cu",
                           "tpu_nexus/ops/grouped_matmul.py:84", "train_moe"),
            # kernel #4's paged mode (decode, extend) and its paged + q_starts
            # mode (speculative verify), on the serve-engine runs
            "decode_attention_paged": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                       "tpu_nexus/ops/decode_attention.py:125", "serve_engine_paged"),
            "decode_attention_ragged": ("tpu_nexus_torch/csrc/decode_attention.cu",
                                        "tpu_nexus/ops/decode_attention.py:125", "serve_engine_spec"),
            # kernel #9: no path of the JAX package launches it; its launches
            # are summed over every main-path run of this script
            "rms_norm": ("tpu_nexus_torch/csrc/rmsnorm.cu", "tpu_nexus/ops/rmsnorm.py:27", None),
        }
        kernels = []
        whole_bwd = results["times"]["flash_attention_bwd"]
        for name, (source, replaces, path) in meta.items():
            t = results["times"][name]
            by_path = ({p: n[name] for p, n in results["launches"].items() if name in n} if path
                       else results["rms_norm_launches"])
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": results["launches"][path][name] if path else sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": results["max_abs_err"][name],
                "ms": t["ms"], "enqueue_ms": t["enqueue_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            }
            if name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                entry.update(design="wgmma+tma")
                if "train_sharded_rank_shapes" in results:  # the parallel training's per-rank shapes
                    entry.update(rank_shapes={label: row[name]
                                              for label, row in results["train_sharded_rank_shapes"].items()})
            if name in ("nexus_gmm", "nexus_tgmm"):
                entry.update(design="wgmma+tma, persistent")
                if "train_pp_ep_gmm_rank_shape" in results:  # an ep-2 rank's padded layout
                    entry.update(rank_shapes={k: v for k, v in results["train_pp_ep_gmm_rank_shape"].items()
                                              if k.startswith(name)})
            if name.startswith("decode_attention"):
                entry.update(design="wgmma+cp.async ring, merge in the launch")
            if name in ("flash_attention", "decode_attention") and "serve_multiprocess_rank_shapes" in results:
                # the rank shapes of serve_multiprocess (b): nexus_moe at ep 2
                entry.setdefault("rank_shapes", {})["serve_moe_ep2"] = {
                    k: v for k, v in results["serve_multiprocess_rank_shapes"][name].items()
                    if k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
            if name == "decode_attention_ragged" and "decode_attention_ragged_tp2" in results["times"]:
                # the speculative verify at a tp-2 rank's shape (serve_sharded (g))
                entry.setdefault("rank_shapes", {})["verify_tp2"] = {
                    k: v for k, v in results["times"]["decode_attention_ragged_tp2"].items()
                    if k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
            if name in ("quant_matmul_int8", "quant_matmul_int4"):
                entry.update(design="stream-K, TMA ring fed by a producer warp, mma.sync, merge in the launch",
                             other_shapes={k: {f: results["times"][k][f] for f in ("shape", "ms", "bound_ms",
                                                                                    "library_ms")}
                                           for k in (f"{name}_down", f"{name}_wq", f"{name}_wk",
                                                     f"{name}_moe_wq", f"{name}_moe_wk")})
            if name == "rms_norm":
                entry.update(design="16-byte vector streams, persistent, next row prefetched",
                             other_shapes={"rms_norm_1024x4096": {f: results["times"]["rms_norm_1024x4096"][f]
                                                                  for f in ("shape", "ms", "bound_ms",
                                                                            "library_ms")}})
            if name == "nexus_gmm":
                entry.update(library_ms_is=t["library_ms_is"],
                             mixtral_8x7b_gate={k: results["times"]["nexus_gmm_mixtral"][k]
                                                for k in ("shape", "ms", "bound_ms", "plain_ms", "library_ms")})
            if name in ("nexus_tgmm", "decode_attention_paged", "decode_attention_ragged", "rms_norm"):
                entry.update(library_ms_is=t["library_ms_is"])
            if path is None:
                entry.update(on_a_main_path=False)
            if name.startswith("flash_attention_bwd"):
                # plain_ms and library_ms are of the whole backward; so is this pair
                entry.update(bound_matmuls=t["bound_matmuls"], backward_ms=whole_bwd["ms"],
                             backward_wrapper_ms=whole_bwd["wrapper_ms"], backward_bound_ms=whole_bwd["bound_ms"])
            kernels.append(entry)
        print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

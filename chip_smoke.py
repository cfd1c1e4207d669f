#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``horovod_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from the checkout's sources (nvcc, sm_90a, one
   process per source, all at once) and print ptxas's register /
   shared-memory report and, per source, which kernels spill;
2. hold the paged-attention kernels against their plain PyTorch version
   on the card, at the serving path's shapes (gpt2-small: H=12, Dh=64,
   BT=16; decode B=8 with contexts up to 1024, prefill chunks of C=64,
   speculative verify chunks of C=8 from mid-block starts 17, 100, 513,
   1000 with f32 and bf16 pools)
   and at the tiny test shapes, for every mask mode and pool type (f32,
   bf16, int8, fp8) and with all-hole rows, a bf16 chunk and a table of
   73 blocks (10 splits): every decode case (one query row)
   on the decode route, every chunk on the prefill route (3xTF32 on the
   tensor cores, each case's error printed beside its derived rounding
   bound); time each route, its plain version and the library yardstick
   (SDPA over the gathered K/V) with CUDA events;
3. hold the three FlashAttention-2 kernels (forward, dQ, dK/dV) against
   their plain versions, in every mask mode, f32 and bf16 (the bf16 route
   of each is its wgmma kernel; the f32 route of each is 3xTF32 on the
   tensor cores, held at the fixed f32 tolerance), with a row that sees
   no key and a repeat of each forward that must give the same bits,
   at the tiny test shapes and the training paths' shapes (BERT-large
   bench [32, 128, 16, 64], GPT-2 small [4, 1024, 12, 64] causal, and
   bf16 GPT-2 medium [4, 128, 16, 64] causal, phase 8's); time
   each kernel, its plain version and SDPA's forward / backward at those
   shapes, the f32 kernels' bounds reckoned as three TF32 passes (the
   f32 FMA pipe's printed beside them);
4. drive the serving path: the port's HTTP server, in process, serving
   gpt2-small at full width and depth with random weights from a fixed
   seed, f32, ``attn_impl`` auto; check identical prompts give
   identical tokens, batched == single, /healthz reports the kernel and
   paged KV, the decode route launched once per layer of every decode
   step and the prefill route once per layer of every prefill chunk,
   and an ``attn_impl="gather"`` engine on the card gives the same
   tokens.  Then the decode-algorithm layer on the same model: the
   device sampler's 20000 draws from fixed keys against the filtered
   distribution (chi-square); a sampled drive over HTTP (temperature
   0.8, top_k 40, top_p 0.95, fixed seeds, one n = 3 request) checking
   the same seed twice, batched == single, kernel engine == gather
   engine, full-length completions, fork and CoW counters above 0 and
   no block reference held after it; a speculative drive (k = 4, a
   2-layer draft) whose greedy tokens equal greedy's (else the position
   and logit margin are printed) and whose sampled run completes, with
   the decode route launched 12 × decode steps + 2 × draft steps and the
   prefill route 12 × (prefill chunks + verify steps); the same drive
   on a copy whose blocks 2..11 have zero output projections, so the
   draft agrees with the target: its greedy run must accept drafts and
   still give that model's plain greedy tokens; an ``MLPAdapter`` spec
   run accepting every draft (one target call per k + 1 tokens); and
   slot mode giving the paged engine's greedy tokens.  The drives'
   tokens/s (smoke readings of a few requests, not throughput), the
   same-batch greedy and sampled step times, the mean inter-token step
   and the acceptance rates are printed;
5. drive the training path: ``examples/bert_pretraining.main`` at the
   bench configuration (BERT-large, 32 sequences of 128 tokens per
   micro-batch, 2 micro-batches per optimizer step, 20 masked positions,
   flash attention, bf16 products) through ``DistributedOptimizer`` over
   NCCL; check the losses are finite and fall, no gradient is NaN, and
   each flash kernel (on its wgmma route) launched 24
   times per micro-batch; report samples/s, step time, peak memory and
   the device's busy share of a traced step.  Then hold one f32 and one
   bf16 step of a 2-layer BERT-large-width model through the kernels
   against the dense attention path (the f32 step must launch the 3xTF32
   forward and backward pair once per layer: those counts are the f32
   instances' launches), and run 3 steps of GPT-2 small
   (bf16) with causal flash attention at 1024 tokens;
6. drive the ResNet-50 training path: ``examples/synthetic_benchmark.main``
   at the JAX configuration (ResNet-50, 224x224x3, 1000 classes, 128
   images per slot, bf16, synchronized batch norm) through
   ``DistributedOptimizer`` over NCCL, 5 warm-up and 10 timed steps;
   check the losses are finite and each step ran 53 statistics
   allreduces forward and 53 backward; report images/s, step time, peak
   memory, the device's busy share of 2 traced steps of bench.py's
   configuration (the fast stem) and their ten largest device ops.  Then
   hold the space-to-depth stem against the naive stem at 224,
   max_pool_eq_grad's backward against the naive pool's, and a small f32
   ResNet step against the same step on the CPU;
7. drive the collective API over NCCL in a world of one (one card hosts
   one NCCL rank), through ``hvd.init()``: allgather (even, 0 rows,
   grouped, async), alltoall (with and without splits, async),
   reducescatter (Sum and Average with pre/post scale, grouped, async),
   broadcast and the in-place and async forms on CUDA tensors of f32,
   bf16, f16, int32, int64 and bool, ``broadcast_object`` /
   ``allgather_object`` of a nested dict, ``sparse_allreduce`` of a COO
   tensor, ``add_process_set([0])``, ``partition_process_sets(1)`` and 3
   steps of ``DistributedOptimizer(process_set=...)`` on the MLP; check
   each output against what a world of one must give, computed on the
   CPU, that it lies on the card and that the backend is NCCL; time one
   call of allreduce, allgather, alltoall and reducescatter (through the
   eager engine) at 4 KiB and 64 MiB of f32 and a device-to-device copy
   of the same bytes with CUDA events;
8. drive GPT-2-medium training with Adasum:
   ``examples/gpt2_adasum.main`` at full width and depth (24 layers,
   d_model 1024, 16 heads, vocab 50257, remat, causal flash attention,
   bf16 products), 4 sequences of 128 tokens, 10 steps (2 warm-up, as
   the example times) of ``local_value_and_grad`` +
   ``adasum_delta_step(SGD(0.05))`` over NCCL in a world of one; check
   the losses are finite and fall and each flash kernel launched on its
   wgmma route 2 × 24 times a step (forward, run again by remat) or 24
   times (dQ, dK/dV); report samples/s, step time, peak memory and the
   busy share of 2 traced steps.  Then Adasum in the world of one
   (``allreduce``, grouped, ``DistributedOptimizer(op=Adasum)``: the
   input back, on the card, over NCCL); Adasum's combine on the card
   (``pair_combine`` and the tree of 4 correlated "ranks", f32 with f32
   and f64 islands and bf16) at wte [50257, 1024] and a block's [1024,
   4096] against a float64 model on the CPU, where a plain Sum and a
   combine without the factor 2 must fail the same check; one
   ``pair_combine`` at wte's
   shape timed with CUDA events beside a device copy of one operand
   and its bytes bound;
9. drive the negotiated eager engine in an NCCL world of one: build
   the native core (``csrc/hvd_core.cc``, g++) and check each of its
   parts; run phase 5's GPT-2-small path (bf16, causal flash, 4 x 1024
   tokens, 3 steps) with ``hvd.start_timeline`` on and check the
   timeline: one ALLREDUCE and one NEGOTIATE_ALLREDUCE span per engine
   dispatch, every B with its E, no event dropped; and each flash kernel
   launched on its wgmma route 12 times a step; time a step with the
   timeline on and off; a second op under a claimed name raises
   DuplicateNameError; ``join()`` returns 0;
   ``hierarchical_allreduce(local_size=1)`` gives the flat allreduce's
   bits; a cached 4 KiB allreduce taken apart and timed per call (the
   engine with a data plane that does nothing, the data plane alone,
   the engine around it, the whole call) beside ``dist.all_reduce`` of
   as many bytes;
10. sequence parallelism on one card: GPT-2 small over 8192 tokens
   with ring attention at n = 1 (f32 logits against plain flash, then
   2 bf16 steps on the 3xTF32 hops), the ring's hops over 4 virtual
   shards, 2 Ulysses steps, and each kernel at each of those shapes;
11. model parallelism in a world of one: MoE GPT-2 small at full width
   (8 experts, top 2, capacity factor 1.25, every 2nd block, experts on
   a dp 1 × ep 1 mesh, where the MoE layer skips both alltoalls):
   first the MoE layer alone at that width (x [4096, 768], C = 1280,
   top 2, claims dropped), f32, against JAX's formula with the
   materialised dispatch and combine at 1e-4 / 1e-5; then the model's
   f32 logits with flash against dense
   attention at 2e-3 (every token on all 8 experts, so no routing choice
   can flip), then 2 bf16 AdamW steps on [4, 1024] tokens
   through ``DistributedOptimizer(reduce_axes=("dp", "ep"))``, each
   flash kernel launched on its wgmma route 12 times a step; then the
   dry-run MoE, pipeline and tensor-parallel steps
   (``entry.dryrun_{moe,pp,tp}_step``) on the card;
12. elastic training in a world of one: the port's launcher with
   ``--min-np 1 --max-np 1`` runs ``examples/elastic_resnet`` (ResNet-50
   at 224², 32 images, bf16, sync BN, SGD with momentum, ``TorchState``
   with a spill directory, a commit every 2 steps); the worker exits
   abruptly after step 5, the driver respawns it and it resumes from the
   spill at step 4 to step 8; its final parameters must equal an
   uninterrupted deterministic 8-step run's bit for bit, and a
   ``save_model`` / ``load_model`` round trip saved mid-cycle at
   ``backward_passes_per_step=2`` must give the same bits;
13. the serving request surface on gpt2-small f32 at full width, random
   weights from the seed: ``checkpoint.save_model`` of the model, served
   by the CLI's factory with ``--checkpoint`` (``prompt_logits`` equal
   to the in-memory model's bit for bit); the first request's TTFT of a
   fresh engine started cold and of one started warm; then two replicas
   on the card (no process sets, warmup on, a ``ModelRegistry``) behind
   the HTTP server: greedy and sampled requests with ``logprobs: 5``
   (each logprob against log_softmax of the plain route's logits,
   1e-4; greedy tokens equal without logprobs), ``/score`` over 1024
   tokens against the plain route (2e-4 / 2e-5), a stream against the
   buffered answer (same tokens, no duplicate; the first SSE token's
   time beside the buffered TTFT), ``schema`` decoding on a model of
   GPT-2 small's widths with vocab 256 (every greedy and sampled
   document conforms) and on gpt2-small (the JAX server's 400 streamed,
   500 buffered), a rank-8 delta on every block's query projection
   resident beside the default model and rolled to version 1 across
   both replicas under 16 mixed requests in flight (none fails, swap
   progress done == total, the answers after it equal the new weights
   served cold); a B = 8 decode step fused against host mode;
14. the serving fleet's front door and control plane on gpt2-small f32
   at full width, random weights from the seed, one reference engine
   holding every answer: (a) two endpoints (one replica each, paged,
   prefix cache, BT 16, chunk 64, 8 slots) behind the port's
   ``RouterServer``: 6 sessions of 3 append-only turns and 2 seeded
   sampled requests (none lost, every answer the reference's), a
   stream (its tokens the buffered answer's), the affinity hit rate,
   retries and ejections, TTFT on the client's clock through the router
   against straight to the endpoint, and a ``slow-route`` stall of 150
   ms on endpoint 0 unhedged and with a 30 ms hedge (same answers; both
   p99s, hedges won); (b) every request traced with a shard directory:
   one request through the router merges into one connected tree (the
   router's root and route span, the endpoint's request span, its
   queue-wait, prefill chunks and decode), ``/trace`` serves it, and a
   16-request storm's tokens/s traced against untraced, beside the same
   storm straight to one endpoint and through listeners with the JAX
   package's backlog of 5; (c) two
   replicas of 2 slots, one a dead spare, a ``FleetController`` with
   the JAX bench's autoscale settings under ``diurnal_load(8, peak 8,
   base 1)`` and a ``ctl.poll`` load-spike: a scale-up, the brownout
   ladder up and back to 0, every latency-tier answer the reference's;
   (d) the port's KV server and a local maintenance endpoint: a
   sentinel marks host h1, ``watch_preemption`` marks replica-1 dead
   with 16 requests in flight (none lost), and clearing the marker
   brings it back alive and warm;
15. the tiered KV hierarchy and sequence-parallel prefill on gpt2-small
   f32 at full width and depth, random weights from the seed, one
   reference engine (no prefix cache) holding every answer: (a) 6
   sessions whose retained prompt blocks need more than a device pool
   of two requests' lifetimes, served twice (the second turn promotes
   the spilled blocks; one block bit-equal across its spill and
   promote), then a 6-request storm on the tiered engine and an
   untiered one of the same pool bytes (same answers, more in flight);
   (b) the port's KV server in this process: endpoint A publishes a
   prompt's 17 blocks, fresh endpoints migrate them at k·BT - 1, k·BT
   and k·BT + 1 tokens (local prefill's tokens; TTFT beside local
   prefill's), a ``drop-tier-block`` train recomputes with the same
   tokens, and ``mark_dead`` empties A's directory entries; (c) 4
   emulated SP ranks at 639, 640, 641 and 1000 tokens (single-rank
   prefill's tokens; TTFT and the emulated wall beside single-rank TTFT,
   handoff bytes, ring hops) and a kill-rank drill that leaks no block;
   every decode step of the phase launches the decode route once per
   layer and every prefill step the prefill route once per layer;
16. print the card's name and power limit, one JSON line of phase 7's
   times, one of phase 8's numbers, one of phase 9's, one of phase
   11's, one of phase 12's (``{"elastic": ...}``: seconds from the kill
   to the first step of the new incarnation, steps redone, host ms of a
   commit with and without the spill and of a restore, images/s before
   and after), one of phase 13's (``{"serve_surface": ...}``), one of
   phase 14's (``{"fleet": ...}``), one of phase 15's
   (``{"tiering": ...}``), one JSON
   line describing every ported kernel (a bf16 flash kernel has one
   entry for phase 5's BERT-large path, one, ``*_gpt2_medium``, for
   phase 8's and one, ``*_gpt2_small``, for phase 9's, ``*_ring_hop``
   and ``*_ulysses`` for phase 10's and ``*_moe`` for phase 11's, each
   with that path's launches, counted from 0, and the error and times at
   its shape; the paged kernels' launches sum phases 4, 13, 14 and
   15),
   and as
   the last line ``{"ok": true, "device": ...}``.

It imports nothing of JAX.  Without a CUDA device it exits non-zero and
prints no result.  ``--device cpu`` rehearses the same phases at a tiny
size through the plain versions (no build, no device numbers).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound: HBM bytes/s,
# f32 FMA-pipe flop/s and dense bf16 and TF32 tensor-core flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
RTOL, ATOL = 2e-4, 2e-5   # the JAX package's paged-attention tolerance
# Flash kernels against their plain versions, (forward, gradients) as
# (rtol, atol).  f32: the JAX package's flash tolerances
# (tests/test_flash.py).  bf16: both sides sum in f32 and round the
# output once, so they may differ by a rounding step: 2 bf16 ulps (rtol
# 2**-6), and an atol of 1e-3 times the plain output's largest magnitude.
# lse is f32 on both sides and is held at the f32 forward tolerance.
# The bf16 outputs come from the tensor-core routes, which also round P
# (forward and backward) and dS (backward) to bf16 before the second
# products: each element may move by a further 2**-8 (bf16's unit
# roundoff) times the same sum over magnitudes, P·|v|/l for the output,
# |P|·|dO|, scale·|dS|·|q| or scale·|dS|·|k| for the gradients
# (flash.attention_fwd_rounding_bound, attention_bwd_rounding_bound), and
# is held to that as well.
FLASH_TOL = {"float32": ((2e-4, 2e-5), (2e-3, 2e-4)),
             "bfloat16": ((2**-6, 1e-3), (2**-6, 1e-3))}


def log(msg: str) -> None:
    print(msg, flush=True)


def spill_report(build_log: str) -> dict:
    """ptxas's spill stores by source: ``{source: [(kernel, bytes), ...]}``
    over the kernels that spill (an empty list: none does)."""
    report, source, kernel = {}, None, None
    for line in build_log.splitlines():
        if " -c " in line and ".cu" in line:
            source = next(w for w in line.split() if w.endswith(".cu"))
            source = source.rsplit("/", 1)[-1]
            report[source] = []
        elif "Compiling entry function" in line:
            kernel = line.split("'")[1]
            # _ZN..._<name>ILi0ELi2ELi32EEEv... -> <name><0,2,32>
            m = re.search(r"([a-z0-9_]+_kernel)I((?:Li\d+E)+)E", kernel)
            if m:
                kernel = m.group(1) + "<" + ",".join(
                    re.findall(r"Li(\d+)E", m.group(2))) + ">"
        elif "bytes spill stores" in line and source is not None:
            n = int(line.split("bytes spill stores")[0].split(",")[-1])
            if n:
                report[source].append((kernel, n))
    return report


# ---------------------------------------------------------------------------
# Phase 2: paged attention cases
# ---------------------------------------------------------------------------

def make_case(torch, pa, rng, *, B, C, H, Dh, BT, starts, kv, device,
              hole_rows=(), q_dtype="f32"):
    """A paged-attention problem: row b's queries start at ``starts[b]``
    and its table maps the blocks up to its last query onto a random
    permutation of the pool; ``hole_rows`` carry all-hole tables.  The
    pool's last block is never mapped and holds huge garbage, so any read
    of a clamped hole would show."""
    need = [0 if b in hole_rows else (starts[b] + C - 1) // BT + 1
            for b in range(B)]
    MB = max(max(need), 1)
    NB = sum(need) + 1
    perm = rng.permutation(NB - 1)
    tables = np.full((B, MB), NB, np.int32)
    cur = 0
    for b in range(B):
        tables[b, :need[b]] = perm[cur:cur + need[b]]
        cur += need[b]
    pos = np.array([0 if b in hole_rows else starts[b] for b in range(B)],
                   np.int32)
    kf = rng.randn(NB, BT, H, Dh).astype(np.float32)
    vf = rng.randn(NB, BT, H, Dh).astype(np.float32)
    # Garbage stays finite after quantization: f16 scales top out at 65504.
    garbage = 1e4 if kv in ("int8", "fp8") else 1e30
    kf[NB - 1] = garbage
    vf[NB - 1] = -garbage
    q = torch.as_tensor(rng.randn(B, C, H, Dh).astype(np.float32),
                        device=device)
    if q_dtype == "bf16":
        q = q.to(torch.bfloat16)
    k = torch.as_tensor(kf, device=device)
    v = torch.as_tensor(vf, device=device)
    ks = vs = None
    if kv == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif kv in ("int8", "fp8"):
        k, ks = pa.quantize_kv(k, kv)
        v, vs = pa.quantize_kv(v, kv)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs,
                tables=torch.as_tensor(tables, device=device),
                pos=torch.as_tensor(pos, device=device), need=need,
                BT=BT, C=C)


def run_case(pa, case, mask_mode, use_kernel):
    args = (case["q"], case["k"], case["v"], case["tables"], case["pos"])
    kw = dict(k_scale=case["ks"], v_scale=case["vs"])
    if use_kernel:
        return pa.paged_prefill_attention(*args, mask_mode=mask_mode, **kw)
    return pa.paged_attention_reference(*args, mask_mode=mask_mode, **kw)


def live_work(case, mask_mode, H, Dh):
    """(bytes, flops) this case's data needs: q and the output once, the
    K/V (+ scale) bytes of every block some query can see once, the
    tables and positions; 4*Dh flops per (query, key) pair the mask
    keeps (Q·K and P·V, 2 each)."""
    q, k = case["q"], case["k"]
    B, C = q.shape[0], q.shape[1]
    BT = case["BT"]
    tables = case["tables"].cpu().numpy()
    pos = case["pos"].cpu().numpy()
    NB = k.shape[0]
    blocks = pairs = 0
    for b in range(B):
        qpos = int(pos[b]) + np.arange(C)
        for j in range(tables.shape[1]):
            if tables[b, j] >= NB:
                continue
            kpos = j * BT + np.arange(BT)
            seen = {0: np.ones((C, BT), bool),
                    1: kpos[None, :] <= qpos[:, None],
                    2: kpos[None, :] < qpos[:, None]}[mask_mode]
            if seen.any():
                blocks += 1
                pairs += int(seen.sum())
    per_block = BT * H * Dh * k.element_size() * 2
    if case["ks"] is not None:
        per_block += BT * H * 2 * 2
    nbytes = (q.numel() * q.element_size() + blocks * per_block
              + tables.size * 4 + pos.size * 4 + B * C * H * Dh * 4)
    return nbytes, pairs * H * 4 * Dh


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` calls, each timed alone
    with CUDA events after ``flush`` (a buffer larger than the 50 MB L2)
    is overwritten, so every call finds the cache cold, as a decode step
    does when it moves from one layer's pool to the next.  The device
    first sleeps long enough for the host to enqueue every call, so no
    host time (argument checks, allocation, launch) falls between two
    events; if the host did not get ahead, the sleep grows and the
    measurement is taken again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 10**7
    while True:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        host_ahead = not slept.query()
        torch.cuda.synchronize()
        if host_ahead:
            return sum(s.elapsed_time(e) for s, e in pairs) / iters
        cycles *= 4
        if cycles > 10**10:
            raise SystemExit("timing: the host never got ahead of the device")


def sdpa_inputs(torch, pa, case, mask_mode):
    """The K/V gathered to dense [B, H, S, Dh] f32 and the boolean mask,
    built outside the timed region: the library yardstick times one
    ``scaled_dot_product_attention`` call on them."""
    q, k, v = case["q"], case["k"], case["v"]
    B, C, H, Dh = q.shape
    tables = case["tables"]
    NB, BT = k.shape[0], k.shape[1]
    idx = tables.long().clamp(0, NB - 1)
    S = tables.shape[1] * BT
    kk = k[idx].reshape(B, S, H, Dh).float()
    vv = v[idx].reshape(B, S, H, Dh).float()
    if case["ks"] is not None:
        kk = pa.dequantize_kv(kk, case["ks"][idx].reshape(B, S, H))
        vv = pa.dequantize_kv(vv, case["vs"][idx].reshape(B, S, H))
    qpos = case["pos"].long()[:, None, None] \
        + torch.arange(C, device=q.device)[None, :, None]
    kpos = torch.arange(S, device=q.device)[None, None, :]
    keep = {0: torch.ones_like(kpos <= qpos), 1: kpos <= qpos,
            2: kpos < qpos}[mask_mode]
    keep = keep & ~(tables >= NB).repeat_interleave(BT, dim=1)[:, None, :]
    return (q.float().transpose(1, 2).contiguous(),
            kk.transpose(1, 2).contiguous(), vv.transpose(1, 2).contiguous(),
            keep[:, None])


def kernel_phase(torch, pa, device, rehearsal):
    """Phase 2.  Returns the measured record of the main-path shapes."""
    rng = np.random.RandomState(2024)
    main = dict(H=12, Dh=64, BT=16)
    tiny = dict(H=2, Dh=16, BT=8)
    decode_ctx = [1024, 1000, 777, 513, 256, 17, 1, 0]   # last: all holes
    prefill_starts = [0, 960, 448, 100]
    verify_starts = [17, 100, 513, 1000, 333, 64, 900, 0]  # last: all holes
    specs = []
    for kv in ("f32", "bf16", "int8", "fp8"):
        specs.append((f"decode B=8 ctx=1024 {kv}", main, 8, 1, [1023] * 8,
                      kv, (), (1,), "f32"))
        specs.append((f"decode B=8 ctx<=1024 {kv}", main, 8, 1,
                      [c - 1 if c else 0 for c in decode_ctx], kv, (7,),
                      (1,), "f32"))
        specs.append((f"prefill C=64 {kv}", main, 4, 64, prefill_starts, kv,
                      (), (0, 1, 2), "f32"))
        specs.append((f"tiny decode {kv}", tiny, 4, 1, [7, 8, 9, 0], kv,
                      (3,), (1,), "f32"))
        specs.append((f"tiny prefill {kv}", tiny, 3, 5, [7, 15, 0], kv,
                      (), (0, 1, 2), "f32"))
    specs.append(("decode bf16 q", main, 3, 1, [511, 300, 0], "bf16", (2,),
                  (1,), "bf16"))
    # GPT-2's default compute type: a bf16 chunk over a bf16 pool.
    specs.append(("prefill C=64 bf16 q", main, 4, 64, prefill_starts, "bf16",
                  (), (0, 1, 2), "bf16"))
    # 73 blocks: 10 splits, a table wider than the serving path's.
    specs.append(("prefill wide table", main, 3, 64, [1100, 40, 0], "f32",
                  (2,), (0, 1, 2), "f32"))
    for dh in (32, 128):
        specs.append((f"prefill Dh={dh}", dict(H=4, Dh=dh, BT=32), 2, 20,
                      [0, 50], "f32", (), (0, 1, 2), "f32"))
    # Speculative decoding's verify chunk at the serving shape: k + 1 = 5
    # rows padded to the chunk bucket of 8, causal, starting mid-block
    # (after a rollback a row restarts anywhere), one all-hole row.
    for kv in ("f32", "bf16"):
        specs.append((f"verify C=8 {kv}", main, 8, 8, verify_starts, kv,
                      (7,), (1,), "f32"))
    specs.append(("tiny verify C=8", tiny, 3, 8, [9, 21, 0], "f32", (2,),
                  (1,), "f32"))
    if rehearsal:
        specs = [s for s in specs if s[0].startswith("tiny")]
    max_err = 0.0
    cases = {}
    for name, shp, B, C, starts, kv, holes, masks, qd in specs:
        case = make_case(torch, pa, rng, B=B, C=C, starts=starts, kv=kv,
                         device=device, hole_rows=holes, q_dtype=qd, **shp)
        cases[name] = case
        for mask in masks:
            ref = run_case(pa, case, mask, use_kernel=False)
            before = dict(pa.LAUNCHES)
            got = run_case(pa, case, mask, use_kernel=True)
            if not rehearsal:
                torch.cuda.synchronize()
                # One query row takes the decode route, a chunk the
                # prefill route.
                if (pa.LAUNCHES["paged_attention_decode"]
                        - before["paged_attention_decode"],
                        pa.LAUNCHES["paged_attention_prefill"]
                        - before["paged_attention_prefill"]) != \
                        (int(C == 1), int(C > 1)):
                    raise SystemExit(f"{name}: C={C} took the wrong route")
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
            for b in holes:
                ok = ok and float(got[b].abs().max()) == 0.0
            beside = ""
            if C > 1:  # the prefill route's derived rounding bound
                bound = pa.paged_prefill_rounding_bound(
                    case["q"], case["k"], case["v"], case["tables"],
                    case["pos"], mask_mode=mask, k_scale=case["ks"],
                    v_scale=case["vs"])
                beside = (f", bound max {float(bound.max()):.3e}, "
                          f"err/bound max "
                          f"{float(((got - ref).abs() / bound.clamp_min(1e-38)).max()):.3e}")
            log(f"  {name} mask={mask}: max_abs_err {err:.3e}{beside} "
                f"({'ok' if ok else 'MISMATCH'} at rtol {RTOL} atol {ATOL})")
            if not ok:
                raise SystemExit(f"kernel disagrees with its plain version: "
                                 f"{name} mask={mask}")
    if rehearsal:
        return {"max_abs_err": max_err}
    record = {"max_abs_err": max_err}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in ("decode B=8 ctx=1024 f32", "decode B=8 ctx<=1024 f32",
                 "prefill C=64 f32", "prefill C=64 bf16 q",
                 "verify C=8 f32", "verify C=8 bf16",
                 "decode B=8 ctx=1024 bf16", "decode B=8 ctx=1024 int8",
                 "decode B=8 ctx=1024 fp8"):
        case, mask, iters = cases[name], 1, 50
        nbytes, flops = live_work(case, mask, main["H"], main["Dh"])
        bytes_s = nbytes / HBM_BYTES_PER_S
        # The decode route's products run on the f32 FMA pipe; the prefill
        # route's on the tensor cores in split-precision TF32: three
        # passes a product, two when the pool's values are TF32 already.
        ops_s = flops / F32_FLOPS_PER_S
        f32_bound_ms = max(bytes_s, ops_s) * 1e3
        if case["C"] > 1:
            ops_s = (3 if case["k"].dtype == torch.float32 else 2) \
                * flops / TF32_FLOPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        ms = time_ms(torch, lambda: run_case(pa, case, mask, True), iters,
                     flush)
        plain_ms = time_ms(torch, lambda: run_case(pa, case, mask, False),
                           iters // 5, flush)
        sq, sk, sv, smask = sdpa_inputs(torch, pa, case, mask)
        lib_ms = time_ms(torch, lambda: sdpa(sq, sk, sv, attn_mask=smask),
                         iters, flush)
        # What this timing shows for moving the same bytes with no
        # arithmetic: one PyTorch copy reading and writing half as many.
        half = torch.empty(nbytes // 8, dtype=torch.float32, device=device)
        copy_ms = time_ms(torch, half.clone, iters, flush)
        del half
        record[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": nbytes, "flops": flops}
        f32_pipe = ("" if case["C"] == 1 else
                    f"; on the f32 FMA pipe the bound would be "
                    f"{f32_bound_ms:.4f} ms, share {f32_bound_ms / ms:.3f}")
        log(f"  timing {name} (cold L2): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa on gathered f32 K/V {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} "
            f"flop), roofline share {bound_ms / ms:.3f}{f32_pipe}; a copy "
            f"moving the same bytes {copy_ms:.4f} ms")
    del flush
    return record


# ---------------------------------------------------------------------------
# Phase 3: the FlashAttention-2 kernels
# ---------------------------------------------------------------------------

def _pairs(S, mode):
    """(query, key) pairs per (b, h) that the mask keeps."""
    return {0: S * S, 1: S * (S + 1) // 2, 2: S * (S - 1) // 2}[mode]


def flash_work(shape, dtype_bytes, mode):
    """(bytes, flops) each kernel's function needs at ``shape``: every
    [B, S, H, D] operand read once and output written once (lse / delta
    rows in f32); 2*D flops per kept pair and product — 2 products
    forward (q·kᵀ, p·v), 3 for dQ (q·kᵀ, dO·vᵀ, ds·k), 4 for dK/dV
    (q·kᵀ, dO·vᵀ, pᵀ·dO, dsᵀ·q)."""
    B, S, H, D = shape
    t = B * S * H * D * dtype_bytes
    row = B * H * S * 4
    pair_flops = 2 * D * _pairs(S, mode) * B * H
    return {"flash_fwd": (4 * t + row, 2 * pair_flops),
            "flash_bwd_dq": (5 * t + 2 * row, 3 * pair_flops),
            "flash_bwd_dkv": (6 * t + 2 * row, 4 * pair_flops)}


def flash_case(torch, fl, rng, shape, dtype, mode, device):
    """Run the three kernels (the plain versions on the CPU) and their
    plain versions on one problem; returns the max abs error of each
    kernel, whether every output is within tolerance, the inputs, and the
    output's and the gradients' largest error over their tolerance (bf16:
    also over the fixed tolerance alone, without the rounding bound)."""
    mk = lambda: torch.as_tensor(  # noqa: E731
        (rng.randn(*shape) * 0.5).astype(np.float32), device=device).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    scale = 1.0 / np.sqrt(shape[-1])
    (frt, fat), (grt, gat) = FLASH_TOL[str(dtype).split(".")[-1]]
    out, lse = fl.flash_fwd(q, k, v, mode, scale)
    again = fl.flash_fwd(q, k, v, mode, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, mode, scale)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, mode, scale)
    kw = dict(mask_mode=mode, scale=scale)
    r_out, r_lse = fl.attention_fwd_reference(q, k, v, **kw)
    r_dq = fl.attention_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    r_dk, r_dv = fl.attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def ratio(a, b, rt, at, extra=0.0):
        """max |a - b| / (at + rt·|b| + extra), at scaled by max|b| for
        bf16; inf for a NaN."""
        if a.dtype == torch.bfloat16:
            at *= float(b.float().abs().max())
        diff = (a.float() - b.float()).abs()
        r = torch.where(diff == 0, 0.0,
                        diff / (at + rt * b.float().abs() + extra)).max()
        return float(r) if bool(torch.isfinite(r)) else float("inf")

    grads = ((dq, r_dq), (dk, r_dk), (dv, r_dv))
    bf16 = dtype == torch.bfloat16
    bounds = (fl.attention_bwd_rounding_bound(q, k, v, do, lse, delta, **kw)
              if bf16 else (0.0,) * 3)
    worst = max(ratio(a, b, grt, gat, x) for (a, b), x in zip(grads, bounds))
    worst_fixed = max(ratio(a, b, grt, gat) for a, b in grads)
    fwd = ratio(out, r_out, frt, fat,
                fl.attention_fwd_rounding_bound(q, k, v, **kw) if bf16
                else 0.0)
    fwd_fixed = ratio(out, r_out, frt, fat)
    errs = {"flash_fwd": max(err(out, r_out), err(lse, r_lse)),
            "flash_bwd_dq": err(dq, r_dq),
            "flash_bwd_dkv": max(err(dk, r_dk), err(dv, r_dv))}
    ok = (fwd <= 1.0
          and ratio(lse, r_lse, *FLASH_TOL["float32"][0]) <= 1.0
          and worst <= 1.0
          and torch.equal(out, again[0]) and torch.equal(lse, again[1]))
    if mode == fl.MASK_STRICT:  # row 0 sees no key
        ok = ok and float(out[:, 0].float().abs().max()) == 0.0 \
            and bool(torch.all(lse[:, :, 0] == fl.NEG_INF / 2)) \
            and float(dq[:, 0].float().abs().max()) == 0.0
    ok = ok and all(bool(torch.isfinite(t.float()).all())
                    for t in (out, lse, dq, dk, dv))
    return (errs, ok, (q, k, v, do, lse, delta, scale),
            (fwd, fwd_fixed, worst, worst_fixed))


def flash_timing(torch, fl, name, shape, dtype, mode, inputs, flush):
    """Time each kernel, its plain version and SDPA (forward; backward
    for both backward kernels) at one of the path's shapes."""
    q, k, v, do, lse, delta, scale = inputs
    kw = dict(mask_mode=mode, scale=scale)
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    if mode == fl.MASK_STRICT:
        # STRICT as an explicit mask (key < query); row 0 sees no key,
        # which SDPA leaves undefined where the kernel gives 0.
        i = torch.arange(shape[1], device=q.device)
        keep = i[:, None] > i[None, :]

        def sdpa(a, b, c):
            return torch.nn.functional.scaled_dot_product_attention(
                a, b, c, attn_mask=keep)
    else:
        def sdpa(a, b, c):
            return torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=mode == fl.MASK_CAUSAL)
    s_out = sdpa(sq, sk, sv)
    s_g = do.transpose(1, 2).contiguous()
    lib_fwd = time_ms(torch, lambda: sdpa(sq, sk, sv), 20, flush)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        s_out, (sq, sk, sv), s_g, retain_graph=True), 20, flush)
    runs = {
        "flash_fwd": (lambda: fl.flash_fwd(q, k, v, mode, scale),
                      lambda: fl.attention_fwd_reference(q, k, v, **kw),
                      lib_fwd),
        "flash_bwd_dq": (
            lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, mode, scale),
            lambda: fl.attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  **kw), lib_bwd),
        "flash_bwd_dkv": (
            lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta, mode, scale),
            lambda: fl.attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   **kw), lib_bwd),
    }
    work = flash_work(shape, q.element_size(), mode)
    record = {}
    for kname, (kern, plain, lib_ms) in runs.items():
        nbytes, flops = work[kname]
        t_bytes = nbytes / HBM_BYTES_PER_S
        # bf16 runs on the tensor cores at the bf16 rate.  f32 runs on
        # the tensor cores in split-precision TF32, three passes a
        # product: the card's least time for f32-accurate work.
        if dtype == torch.bfloat16:
            t_ops = flops / BF16_FLOPS_PER_S
        else:
            t_ops = 3 * flops / TF32_FLOPS_PER_S
        rec = {"ms": time_ms(torch, kern, 20, flush),
               "plain_ms": time_ms(torch, plain, 5, flush),
               "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        record[kname] = rec
        f32_pipe = ""
        if dtype != torch.bfloat16:
            pipe_ms = max(t_bytes, flops / F32_FLOPS_PER_S) * 1e3
            f32_pipe = (f"; on the f32 FMA pipe the bound would be "
                        f"{pipe_ms:.4f} ms, share {pipe_ms / rec['ms']:.3f}")
        log(f"  timing {kname} {name} (cold L2): kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, sdpa "
            f"{'fwd' if kname == 'flash_fwd' else 'bwd'} {lib_ms:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} B, "
            f"{flops} flop), roofline share {rec['bound_ms'] / rec['ms']:.3f}"
            f"{f32_pipe}")
    return record


def flash_phase(torch, device, rehearsal):
    """Phase 3.  Returns the max abs error of each kernel over every
    case and the timings at the training paths' shapes: BERT-large's
    and GPT-2-small's, bf16 and f32, and GPT-2-medium's (phase 8), bf16."""
    from horovod_tpu_torch.parallel import flash as fl
    rng = np.random.RandomState(7)
    f32, bf16 = torch.float32, torch.bfloat16
    modes = (fl.MASK_NONE, fl.MASK_CAUSAL, fl.MASK_STRICT)
    cases = [(f"tiny {shape}", shape, dt, m)
             for shape in ((2, 8, 2, 16), (2, 128, 4, 32), (1, 96, 3, 64),
                           (1, 80, 2, 128))
             for dt in (f32, bf16) for m in modes]
    bert, gpt2 = (32, 128, 16, 64), (4, 1024, 12, 64)
    gpt2m = (4, 128, 16, 64)   # phase 8's GPT-2-medium path
    if not rehearsal:
        cases += [("bert-large", bert, bf16, fl.MASK_NONE),
                  ("bert-large", bert, f32, fl.MASK_NONE),
                  ("gpt2-small", gpt2, bf16, fl.MASK_CAUSAL),
                  ("gpt2-small", gpt2, f32, fl.MASK_CAUSAL),
                  ("gpt2-medium", gpt2m, bf16, fl.MASK_CAUSAL)]
    max_err = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    max_err_f32 = dict(max_err)   # the f32 instances alone
    timed = {}
    # Largest err/tol of the output ("fwd") and the gradients ("grad"), by
    # dtype; "fixed": bf16 over FLASH_TOL alone, without the bound.
    worst = {f"{part} {kind}": 0.0 for part in ("fwd", "grad")
             for kind in ("float32", "bfloat16", "bfloat16 fixed")}
    for name, shape, dt, mode in cases:
        errs, ok, inputs, ratios = flash_case(torch, fl, rng, shape, dt,
                                              mode, device)
        for kname, e in errs.items():
            max_err[kname] = max(max_err[kname], e)
            if dt == f32:
                max_err_f32[kname] = max(max_err_f32[kname], e)
        dname = str(dt).split(".")[-1]
        for part, r, r_fixed in (("fwd", *ratios[:2]), ("grad", *ratios[2:])):
            worst[f"{part} {dname}"] = max(worst[f"{part} {dname}"], r)
            if dt == bf16:
                worst[f"{part} bfloat16 fixed"] = max(
                    worst[f"{part} bfloat16 fixed"], r_fixed)
        tol = FLASH_TOL[dname]
        bf16_note = " (atol x max|plain|) + rounding bound" if dt == bf16 \
            else ""
        fixed = (f" (fixed part alone {ratios[1]:.3f} / {ratios[3]:.3f})"
                 if dt == bf16 else "")
        log(f"  {name} {dname} mask={mode}: max_abs_err "
            + ", ".join(f"{k[6:]} {e:.3e}" for k, e in errs.items())
            + f"; err/tol fwd {ratios[0]:.3f}, grad {ratios[2]:.3f}{fixed}"
            + f" ({'ok' if ok else 'MISMATCH'} at fwd {tol[0]} grad "
              f"{tol[1]}{bf16_note})")
        if not ok:
            raise SystemExit(f"flash kernels disagree with their plain "
                             f"versions: {name} {dt} mask={mode}")
        if not rehearsal and shape in (bert, gpt2, gpt2m):
            # bf16 (the training path's type) under the bare name; the
            # f32 routes (f32 models, the f32 step check) too.
            timed[name if dt == bf16 else f"{name} f32"] = (shape, dt, mode,
                                                           inputs, errs)
    for part in ("fwd", "grad"):
        log(f"  largest {part} err/tol: f32 {worst[part + ' float32']:.3f}, "
            f"bf16 {worst[part + ' bfloat16']:.3f} (over the fixed "
            f"tolerance alone {worst[part + ' bfloat16 fixed']:.3f})")
    record = {"max_abs_err": max_err, "max_abs_err_f32": max_err_f32}
    if rehearsal:
        return record
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
    for name, (shape, dt, mode, inputs, errs) in timed.items():
        record[name] = flash_timing(
            torch, fl, f"{name.split()[0]} {list(shape)} "
            f"{str(dt).split('.')[-1]} mask={mode}", shape, dt, mode, inputs,
            flush)
        for kname, e in errs.items():   # the error at the timed shape
            record[name][kname]["max_abs_err"] = e
    del flush
    return record


# ---------------------------------------------------------------------------
# Phase 4: the serving path
# ---------------------------------------------------------------------------

def http_json(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def trace_batch(torch, concurrent_batch):
    """The concurrent batch once more under ``torch.profiler`` (device
    activity only): the device's busy and idle share of the batch's wall
    time, and where its device time goes by kernel.  A separate pass, so
    the numbers above are untraced."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_s = concurrent_batch()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log("  traced batch: the profiler saw no device time (not measured)")
        return
    log(f"  traced batch: wall {wall_s * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / (wall_s * 1e3):.3f} of wall; idle "
        f"{1 - busy_ms / (wall_s * 1e3):.3f})")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    for route, kernel in (("decode", "paged_decode_kernel"),
                          ("prefill", "paged_prefill_kernel")):
        mine = [r for r in rows if kernel in r[2]]
        us, n = sum(r[0] for r in mine), sum(r[1] for r in mine)
        log(f"    paged {route} route: {us / 1e3:.3f} ms of device time in "
            f"{n} launches ({us / max(n, 1):.2f} us a launch)")


def serving_model(torch, device, rehearsal, seed):
    """gpt2-small at full width and depth in f32 (a 2-layer model on the
    CPU), random weights from ``seed``, and the serving drives' prompts
    (5, 16, 17, 32 and 900 tokens) and new-token count."""
    from horovod_tpu_torch.models import TransformerConfig, create_gpt2
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      init_gpt2_)
    if rehearsal:
        cfg = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                                d_model=32, d_ff=64, max_len=64,
                                dtype=torch.float32)
        model = init_gpt2_(Transformer(cfg, device=device),
                           torch.Generator(device=device).manual_seed(seed))
        lens, long_len, max_new = (3, 8, 9, 16), 40, 6
    else:
        model = create_gpt2("small", device=device, seed=seed,
                            dtype=torch.float32)
        cfg = model.cfg
        lens, long_len, max_new = (5, 16, 17, 32), 900, 16
    log(f"  model: {cfg.num_layers} layers x d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, max_len "
        f"{cfg.max_len}, f32, random weights from seed {seed}")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in lens + (long_len,)]
    return cfg, model, prompts, max_new


def reset_launches(pa):
    for name in pa.LAUNCHES:
        pa.LAUNCHES[name] = 0


def check_launches(pa, cfg, rehearsal, decode_want, prefill_want, what,
                   failures):
    """The paged routes' launches of one drive against what its steps
    need; returns (decode, prefill) launches."""
    dec = pa.LAUNCHES["paged_attention_decode"]
    pre = pa.LAUNCHES["paged_attention_prefill"]
    log(f"  {what} launches: decode route {dec} (want {decode_want}), "
        f"prefill route {pre} (want {prefill_want}), all "
        f"{pa.LAUNCHES['paged_attention']}")
    if not rehearsal and (dec, pre, pa.LAUNCHES["paged_attention"]) != (
            decode_want, prefill_want, decode_want + prefill_want):
        failures.append(f"{what}: paged launches do not match the steps")
    return dec, pre


def main_path(torch, device, rehearsal, cfg, model, prompts, max_new):
    """The greedy drive: the HTTP server over gpt2-small.  Returns the
    paged routes' launches and the greedy tokens of each prompt."""
    from horovod_tpu_torch.serve import (InferenceEngine, ServeServer,
                                         TransformerAdapter, build_replicas)
    from horovod_tpu_torch.serve import paged_attention as pa

    sched = build_replicas(
        lambda: TransformerAdapter(cfg, model, device=device),
        num_replicas=1, max_batch=8, prefill_chunk=64)
    eng = sched.replicas[0].engine
    server = ServeServer(sched)
    port = server.start(port=0, host="127.0.0.1")
    try:
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        # The launch counts cover exactly the main path's run.
        reset_launches(pa)
        steps0, pre0 = eng.steps, eng.prefill_steps
        t0 = time.monotonic()
        singles = [http_json(port, "/generate",
                             {"tokens": p, "max_new_tokens": max_new})
                   for p in prompts]
        t_single = time.monotonic() - t0
        again = http_json(port, "/generate",
                          {"tokens": prompts[0], "max_new_tokens": max_new})

        def concurrent_batch():
            out = [None] * len(prompts)

            def post(i):
                out[i] = http_json(port, "/generate", {
                    "tokens": prompts[i], "max_new_tokens": max_new})

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(prompts))]
            t1 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return out, time.monotonic() - t1

        results, t_batch = concurrent_batch()
        health = http_json(port, "/healthz")
        metrics = http_json(port, "/metrics")
        decode_launches = pa.LAUNCHES["paged_attention_decode"]
        prefill_launches = pa.LAUNCHES["paged_attention_prefill"]
        all_launches = pa.LAUNCHES["paged_attention"]
        steps = eng.steps - steps0
        prefills = eng.prefill_steps - pre0
        step_ms = eng.metrics.snapshot()["token_step"]
        peak = (torch.cuda.max_memory_allocated() if not rehearsal else 0)
        if not rehearsal:
            trace_batch(torch, concurrent_batch)
    finally:
        server.stop()
    tokens = [r["tokens"] for r in singles]
    failures = []
    if again["tokens"] != tokens[0]:
        failures.append("identical prompts gave different tokens")
    if any(r is None for r in results) or \
            [r["tokens"] for r in results] != tokens:
        failures.append("batched != single")
    if any(len(t) != max_new for t in tokens):
        failures.append(f"expected {max_new} tokens per request")
    rep = health["replicas"][0]
    want_impl = "gather" if rehearsal else "kernel"
    if rep["attn_impl"] != want_impl or rep["kv_mode"] != "paged":
        failures.append(f"healthz reports {rep['attn_impl']}/"
                        f"{rep['kv_mode']}, expected {want_impl}/paged")
    for family in ("hvd_serve_ttft_ms_bucket", "hvd_serve_tokens_total",
                   'hvd_serve_requests_total{outcome="ok"}',
                   "hvd_serve_batch_occupancy_max",
                   f'impl="{want_impl}"'):
        if family not in metrics:
            failures.append(f"/metrics lacks {family}")
    log(f"  decode steps {steps}, prefill chunks {prefills}; launches: "
        f"decode route {decode_launches} (num_layers x steps = "
        f"{cfg.num_layers * steps}), prefill route {prefill_launches} "
        f"(num_layers x chunks = {cfg.num_layers * prefills}), all "
        f"{all_launches}")
    if not rehearsal and (decode_launches, prefill_launches,
                          all_launches) != (
            cfg.num_layers * steps, cfg.num_layers * prefills,
            cfg.num_layers * (steps + prefills)):
        failures.append("paged launches do not match num_layers x decode "
                        "steps / prefill chunks")
    # The same prompts through the plain version ("gather") on the device.
    gather = InferenceEngine(
        TransformerAdapter(cfg, model, attn_impl="gather", device=device),
        max_batch=8, prefill_chunk=64, replica_id="gather").start()
    try:
        g_tokens = [gather.generate(p, max_new_tokens=max_new)
                    for p in prompts]
    finally:
        gather.stop()
    if g_tokens != tokens:
        failures.append("kernel engine tokens != gather engine tokens")
    ttfts = [r["ttft_ms"] for r in results if r is not None]
    n_tok = sum(len(t) for t in tokens)
    log(f"  prompts {[len(p) for p in prompts]}, {max_new} new tokens each")
    if not rehearsal:
        log(f"  TTFT ms (concurrent batch): {ttfts}")
        log(f"  tokens/s: sequential {n_tok / t_single:.1f}, concurrent "
            f"batch {n_tok / t_batch:.1f}; peak device memory "
            f"{peak / 2**20:.1f} MiB")
        log(f"  inter-token step (host clock, prefill chunks between "
            f"decode steps included): mean "
            f"{step_ms['sum_ms'] / max(step_ms['count'], 1):.3f} ms over "
            f"{step_ms['count']} steps")
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("main path failed")
    return decode_launches, prefill_launches, tokens


# The sampled drives' filters: GPT-2's usual sampling settings.
SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)


def chi2_bound(df: int) -> float:
    """Above the 99.9th percentile of chi2(df) over the df used here (the
    bound of the JAX package's sampling tests)."""
    return df + 4 * (2 * df) ** 0.5 + 11


def sampler_check(torch, device):
    """``sampling.sample_batched`` on the device, fed by ``pack_params``
    as the sampled decode step feeds it: 20000 draws from fixed keys over
    a filtered 64-token distribution against ``filtered_probs`` by
    chi-square (deterministic once the keys are fixed); nothing may land
    outside the filtered support."""
    from horovod_tpu_torch.serve import sampling as sm
    rng = np.random.RandomState(11)
    x = (rng.randn(64) * 1.5).astype(np.float32)
    N = 20000
    keys = np.stack([sm.seq_key(2024, i) for i in range(N)])
    packed = torch.as_tensor(sm.pack_params(
        keys, np.full(N, 9), np.full(N, SAMPLING["temperature"]),
        np.full(N, SAMPLING["top_k"]), np.full(N, SAMPLING["top_p"])),
        device=device)
    out = sm.sample_batched(torch.as_tensor(x, device=device)[None].expand(
        N, 64), packed)
    if out.device.type != device.type:
        raise SystemExit("the sampler left the device")
    counts = np.bincount(out.cpu().numpy(), minlength=64)
    expected = sm.filtered_probs(x, **SAMPLING) * N
    live = expected > 0
    chi2 = float(((counts[live] - expected[live]) ** 2
                  / expected[live]).sum())
    df = int(live.sum()) - 1
    log(f"  device sampler: {N} draws on {device.type}, support "
        f"{int(live.sum())} of 64, chi2 {chi2:.2f} (bound "
        f"{chi2_bound(df):.2f}, df {df}), outside the support "
        f"{int(counts[~live].sum())}")
    if counts[~live].sum() or chi2 >= chi2_bound(df):
        raise SystemExit("the device sampler does not follow the filtered "
                         "distribution")


def sampled_path(torch, device, rehearsal, cfg, model, prompts, max_new):
    """The sampled drive over HTTP: each prompt sampled with its own seed
    and one n = 3 request on the 17-token prompt (one full block and a
    shared partial one, so the forks copy it on write).  Returns the
    paged routes' launches."""
    from horovod_tpu_torch.serve import (InferenceEngine, Request,
                                         ServeServer, TransformerAdapter,
                                         build_replicas)
    from horovod_tpu_torch.serve import paged_attention as pa

    bodies = [dict(tokens=p, max_new_tokens=max_new, seed=11 + i,
                   **SAMPLING) for i, p in enumerate(prompts)]
    bodies.append(dict(tokens=prompts[2], max_new_tokens=max_new, seed=99,
                       n=3, **SAMPLING))
    sched = build_replicas(
        lambda: TransformerAdapter(cfg, model, device=device),
        num_replicas=1, max_batch=8, prefill_chunk=64)
    eng = sched.replicas[0].engine
    server = ServeServer(sched)
    port = server.start(port=0, host="127.0.0.1")
    failures = []
    try:
        reset_launches(pa)
        steps0, pre0 = eng.steps, eng.prefill_steps
        t0 = time.monotonic()
        singles = [http_json(port, "/generate", b) for b in bodies]
        t_single = time.monotonic() - t0
        again = http_json(port, "/generate", bodies[0])
        batched = [None] * len(bodies)

        def post(i):
            batched[i] = http_json(port, "/generate", bodies[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        t1 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_batch = time.monotonic() - t1
        kv = eng.kv_stats()
        launches = check_launches(
            pa, cfg, rehearsal, cfg.num_layers * (eng.steps - steps0),
            cfg.num_layers * (eng.prefill_steps - pre0), "sampled drive",
            failures)
        step_ms = eng.metrics.snapshot()["token_step"]
    finally:
        server.stop()

    def streams(r):
        return r["completions"] if "completions" in r else [r["tokens"]]

    want = [streams(r) for r in singles]
    if again["tokens"] != singles[0]["tokens"]:
        failures.append("the same seed twice gave different tokens")
    if any(r is None for r in batched) or \
            [streams(r) for r in batched] != want:
        failures.append("sampled batched != single given the same seeds")
    if any(len(t) != max_new for w in want for t in w) or \
            len(want[-1]) != 3 or singles[-1]["n"] != 3:
        failures.append("a completion is not full length")
    if [r["seed"] for r in singles] != [b["seed"] for b in bodies]:
        failures.append("the seed was not echoed")
    if not (kv["seq_forks"] > 0 and kv["cow"] > 0):
        failures.append(f"fork / CoW counters not above 0: "
                        f"{kv['seq_forks']} / {kv['cow']}")
    if kv["used"] != 0:
        failures.append(f"{kv['used']} block references held after the "
                        f"drive beyond the prefix cache")
    # The same seeds through the plain version ("gather") on the device.
    gather = InferenceEngine(
        TransformerAdapter(cfg, model, attn_impl="gather", device=device),
        max_batch=8, prefill_chunk=64, replica_id="gather").start()
    try:
        g = []
        for b in bodies:
            r = Request(b["tokens"], max_new_tokens=max_new, seed=b["seed"],
                        n=b.get("n", 1), **SAMPLING)
            gather.batcher.submit(r)
            first = r.result(timeout=600)
            g.append(r.samples if r.samples is not None else [first])
    finally:
        gather.stop()
    if g != want:
        failures.append("kernel engine sampled tokens != gather engine's")
    n_tok = sum(len(t) for w in want for t in w)
    log(f"  sampled: {len(bodies)} requests ({SAMPLING}, fixed seeds, one "
        f"n=3), forks {kv['seq_forks']}, CoW copies {kv['cow']}, blocks "
        f"used after {kv['used']}")
    if not rehearsal:
        log(f"  sampled drive smoke reading ({len(bodies)} requests of "
            f"{max_new} tokens; not a throughput): sequential "
            f"{n_tok / t_single:.1f} tokens/s, concurrent batch "
            f"{n_tok / t_batch:.1f}; inter-token step "
            f"(host clock) mean "
            f"{step_ms['sum_ms'] / max(step_ms['count'], 1):.3f} ms over "
            f"{step_ms['count']} steps")
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("sampled path failed")
    return launches


def sampled_step_timing(torch, device, cfg, model):
    """One decode step at B = 8 (contexts 5 to 900) through
    ``decode_paged`` and ``decode_paged_sampled`` on one pool, in turns
    (greedy, sampled, sampled, greedy, ...): host-clock ms per step, each
    ending in its device-to-host copy of the tokens.  Then the sampler
    alone on the step's [8, V] logits, enqueued behind a ~0.1 s device
    sleep: if the host returns from the call before the device wakes, the
    call does not wait for the device, and CUDA events around it read
    its device time alone; the host-clock ms per call, synchronized,
    beside it."""
    from horovod_tpu_torch.serve import TransformerAdapter
    from horovod_tpu_torch.serve import sampling as sm
    ad = TransformerAdapter(cfg, model, device=device)
    B, MB = 8, ad.max_blocks_per_seq
    pool = ad.init_paged_cache(B * MB, B)
    tables = np.arange(B * MB).reshape(B, MB)
    positions = np.array([5, 16, 17, 32, 900, 100, 300, 600])
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, B)
    keys = np.stack([sm.seq_key(11, b) for b in range(B)])
    extra = (keys, np.full(B, SAMPLING["temperature"], np.float32),
             np.full(B, SAMPLING["top_k"]),
             np.full(B, SAMPLING["top_p"], np.float32))
    steps = {"greedy": lambda: ad.decode_paged(pool, tokens, positions,
                                               tables),
             "sampled": lambda: ad.decode_paged_sampled(
                 pool, tokens, positions, tables, *extra)}
    ms = {"greedy": [], "sampled": []}
    for _ in range(2):
        for fn in steps.values():
            fn()
    for _ in range(15):
        for name in ("greedy", "sampled", "sampled", "greedy"):
            t0 = time.perf_counter()
            steps[name]()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    logits = ad._paged_step_body(pool, tokens, positions, tables)
    packed = torch.as_tensor(sm.pack_params(keys, positions + 1, *extra[1:]),
                             device=device)
    sm.sample_batched(logits, packed)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(2 * 10**8)
    t0 = time.perf_counter()
    start.record()
    sm.sample_batched(logits, packed)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    waited = enqueue_ms > 0.5 * (time.perf_counter() - t0) * 1e3
    dev_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(20):
        sm.sample_batched(logits, packed)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    g, smp = np.median(ms["greedy"]), np.median(ms["sampled"])
    log(f"  decode step at B=8 (median of 30, host clock): greedy "
        f"{g:.3f} ms, sampled {smp:.3f} ms (sampled/greedy {smp / g:.3f}; "
        f"tokens/s at the same batch {B * 1e3 / g:.1f} vs "
        f"{B * 1e3 / smp:.1f}); the sampler alone on [8, "
        f"{cfg.vocab_size}] logits: {host_ms:.3f} ms a call on the host "
        f"clock; enqueued in {enqueue_ms:.3f} ms behind a device sleep, "
        + ("it WAITED for the device (events read "
           f"{dev_ms:.4f} ms, host gaps included)" if waited else
           f"it did not wait for the device, which then took "
           f"{dev_ms:.4f} ms"))


def first_divergence(ad, prompt, got, want):
    """Where a speculative greedy stream first leaves the plain one, and
    the target's logit margin (top-1 minus top-2) there."""
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = np.sort(ad.prompt_logits(list(prompt) + want[:j]))
    return j, float(logits[-1] - logits[-2])


def draft_layers_of(rehearsal):
    """The spec drives' draft depth: 2 of gpt2-small's 12 blocks, 1 of
    the CPU rehearsal's 2."""
    return 1 if rehearsal else 2


def spec_path(torch, device, rehearsal, cfg, model, prompts, max_new,
              greedy, what="spec drive"):
    """A speculative drive: k = 4 with a ``draft_layers_of`` draft, the
    prompts greedy and batched (their tokens must be ``greedy``), then
    sampled.  Returns the paged routes' launches and the greedy run's
    spec counters."""
    from horovod_tpu_torch.serve import (InferenceEngine, Request,
                                         ServeMetrics, TransformerAdapter)
    from horovod_tpu_torch.serve import paged_attention as pa

    k, dl = 4, draft_layers_of(rehearsal)
    ad = TransformerAdapter(cfg, model, device=device, draft_layers=dl)
    eng = InferenceEngine(ad, max_batch=8, prefill_chunk=64, spec_k=k,
                          metrics=ServeMetrics(), replica_id="spec").start()
    failures = []

    def run(kw):
        reqs = [Request(p, max_new_tokens=max_new, **kw(i))
                for i, p in enumerate(prompts)]
        t0 = time.monotonic()
        for r in reqs:
            eng.batcher.submit(r)
        out = [r.result(timeout=600) for r in reqs]
        return out, time.monotonic() - t0

    try:
        reset_launches(pa)
        got, t_greedy = run(lambda i: {})
        g_spec = dict(eng.metrics.snapshot()["spec"])
        sampled, t_sampled = run(lambda i: dict(seed=11 + i, **SAMPLING))
        snap = eng.metrics.snapshot()
        kv = eng.kv_stats()
        launches = check_launches(
            pa, cfg, rehearsal,
            cfg.num_layers * (eng.steps - eng.spec_steps)
            + dl * eng.draft_steps,
            cfg.num_layers * (eng.prefill_steps + eng.spec_steps),
            what, failures)
    finally:
        eng.stop()
    for p, a, b in zip(prompts, got, greedy):
        if a != b:
            j, margin = first_divergence(ad, p, a, b)
            failures.append(f"greedy spec != greedy for the {len(p)}-token "
                            f"prompt at new token {j} (logit margin "
                            f"{margin:.3e})")
    if any(len(t) != max_new for t in sampled):
        failures.append("a sampled spec request is not full length")
    if kv["used"] != 0:
        failures.append(f"{kv['used']} block references leaked")
    spec = snap["spec"]
    s_drafted = spec["drafted"] - g_spec["drafted"]
    s_accepted = spec["accepted"] - g_spec["accepted"]
    log(f"  greedy streams: {[len(set(t)) for t in greedy]} distinct "
        f"tokens of {max_new} per prompt")
    log(f"  {what}: k={k}, draft {dl} of {cfg.num_layers} layers; "
        f"{eng.spec_steps} verify steps, {eng.draft_steps} draft steps, "
        f"{eng.prefill_steps} prefill chunks; greedy run drafted "
        f"{g_spec['drafted']}, accepted {g_spec['accepted']} (acceptance "
        f"rate {g_spec['acceptance_rate']}); sampled run drafted "
        f"{s_drafted}, accepted {s_accepted}")
    if not rehearsal:
        n_tok = len(prompts) * max_new
        step_ms = snap["token_step"]
        log(f"  {what} smoke reading ({len(prompts)} requests of {max_new} "
            f"tokens, batched; not a throughput): greedy "
            f"{n_tok / t_greedy:.1f} tokens/s, sampled "
            f"{n_tok / t_sampled:.1f}; inter-step (one verify each, host "
            f"clock) mean "
            f"{step_ms['sum_ms'] / max(step_ms['count'], 1):.3f} ms over "
            f"{step_ms['count']} steps")
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit(f"{what} failed")
    return launches, g_spec


def aligned_spec_path(torch, device, rehearsal, cfg, model, prompts,
                      max_new):
    """A speculative drive whose draft agrees with its target: a copy of
    the model whose blocks from ``draft_layers`` up have zero output
    projections (attention and MLP, kernels and biases), so they add
    nothing to the residual stream and the truncated stack computes the
    full stack's hidden state.  Every block still runs its attention on
    the kernels.  The greedy run must accept drafts — so the accepted
    path runs on the card: m > 0, the bonus token, later decode steps
    reading K/V that verify wrote at accepted positions — and still give
    plain greedy's tokens on this model; the sampled run (point-mass
    accept at temperature 0.8) accepts some drafts and rolls back
    others.  Returns the spec drive's paged launches."""
    import copy
    from horovod_tpu_torch.serve import InferenceEngine, TransformerAdapter
    aligned = copy.deepcopy(model)
    with torch.no_grad():
        for blk in aligned.blocks[draft_layers_of(rehearsal):]:
            for p in (blk.attn.proj.kernel, blk.attn.proj.bias,
                      blk.fc2.kernel, blk.fc2.bias):
                p.zero_()
    plain = InferenceEngine(TransformerAdapter(cfg, aligned, device=device),
                            max_batch=8, prefill_chunk=64,
                            replica_id="aligned").start()
    try:
        greedy = [plain.generate(p, max_new_tokens=max_new) for p in prompts]
    finally:
        plain.stop()
    launches, g_spec = spec_path(torch, device, rehearsal, cfg, aligned,
                                 prompts, max_new, greedy,
                                 what="aligned-draft spec drive")
    if not g_spec["accepted"] > 0:
        raise SystemExit("the aligned-draft greedy spec run accepted no "
                         "draft")
    return launches


def mlp_spec_path(torch, device, seed):
    """``MLPAdapter`` is its own draft: a spec run accepts every draft and
    makes one target call per k + 1 decode tokens, and emits plain
    greedy's tokens."""
    from horovod_tpu_torch.models import create_mlp
    from horovod_tpu_torch.serve import (InferenceEngine, MLPAdapter,
                                         ServeMetrics)
    V, k, new = 256, 4, 21
    ad = MLPAdapter(create_mlp((64, V), in_features=V, device=device,
                               seed=seed), vocab_size=V, max_len=256)
    outs, snaps = [], []
    for spec_k in (0, k):
        eng = InferenceEngine(ad, max_batch=8, kv_mode="paged",
                              spec_k=spec_k, metrics=ServeMetrics(),
                              replica_id=f"mlp-{spec_k}").start()
        try:
            outs.append(eng.generate([1, 2, 3], max_new_tokens=new))
            snaps.append(eng.metrics.snapshot())
        finally:
            eng.stop()
    snap = snaps[1]
    calls = snap["decode_steps"] / (snap["tokens_total"] - 1)
    log(f"  MLPAdapter spec (k={k}): acceptance rate "
        f"{snap['spec']['acceptance_rate']}, target calls per decode token "
        f"{calls:.4f} (1/(k+1) = {1 / (k + 1):.4f})")
    if outs[0] != outs[1] or snap["spec"]["acceptance_rate"] != 1.0 \
            or snap["decode_steps"] * (k + 1) != snap["tokens_total"] - 1:
        raise SystemExit("MLPAdapter spec run did not accept every draft")


def slot_path(torch, device, cfg, model, prompts, max_new, greedy):
    """Slot mode (dense f32 attention over a contiguous cache) gives the
    paged engine's greedy tokens."""
    from horovod_tpu_torch.serve import InferenceEngine, TransformerAdapter
    eng = InferenceEngine(TransformerAdapter(cfg, model, device=device),
                          kv_mode="slot", max_batch=8,
                          replica_id="slot").start()
    try:
        got = [eng.generate(p, max_new_tokens=max_new) for p in prompts]
    finally:
        eng.stop()
    log(f"  slot mode: {len(prompts)} prompts, greedy tokens "
        f"{'equal' if got == greedy else 'DIFFER from'} the paged engine's")
    if got != greedy:
        raise SystemExit("slot-mode tokens != paged tokens")


def serving_phase(torch, device, rehearsal, seed):
    """Phase 4: every serving drive over one gpt2-small.  Returns the
    paged routes' launches summed over the drives that run them (each
    drive counted from 0)."""
    cfg, model, prompts, max_new = serving_model(torch, device, rehearsal,
                                                 seed)
    dec, pre, greedy = main_path(torch, device, rehearsal, cfg, model,
                                 prompts, max_new)
    log("  -- seeded sampling and n > 1 forks")
    sampler_check(torch, device)
    sdec, spre = sampled_path(torch, device, rehearsal, cfg, model, prompts,
                              max_new)
    if not rehearsal:
        sampled_step_timing(torch, device, cfg, model)
    log("  -- speculative decoding")
    (xdec, xpre), _ = spec_path(torch, device, rehearsal, cfg, model,
                                prompts, max_new, greedy)
    adec, apre = aligned_spec_path(torch, device, rehearsal, cfg, model,
                                   prompts, max_new)
    mlp_spec_path(torch, device, seed)
    log("  -- slot mode")
    slot_path(torch, device, cfg, model, prompts, max_new, greedy)
    return dec + sdec + xdec + adec, pre + spre + xpre + apre


# ---------------------------------------------------------------------------
# Phase 5: the training path
# ---------------------------------------------------------------------------

def _top_ops(torch, prof, n=10):
    """The profile's largest device kernels and host ops by self time."""
    cpu = torch.autograd.DeviceType.CPU
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type != cpu and not e.is_user_annotation),
                 reverse=True)
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cpu),
                  reverse=True)
    for title, rows in (("device kernels", dev), ("host ops", host)):
        log(f"    {title}: {sum(r[0] for r in rows) / 1e3:.1f} ms in all")
        for us, count, key in rows[:n]:
            log(f"    {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def _busy_ms(torch, prof):
    """Device busy time of a profiled window: the kernels' own time, not
    the host ops that launched them nor the device-side spans of
    annotations such as ``Optimizer.step``."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU
               and not e.is_user_annotation) / 1e3


def _flash_share(torch, prof, busy_ms):
    """The flash kernels' device time in the profiled window, by kernel
    (the wgmma forward, dQ and dK/dV), beside the total."""
    cpu = torch.autograd.DeviceType.CPU
    names = {"::flash_fwd_kernel<": "fwd (wgmma)",
             "::dq_kernel<": "dQ (wgmma)", "::dkv_kernel<": "dK/dV (wgmma)"}
    found = {label: [0.0, 0] for label in names.values()}
    for e in prof.key_averages():
        for tag, label in names.items():
            if e.device_type != cpu and tag in e.key:
                found[label][0] += e.self_device_time_total / 1e3
                found[label][1] += e.count
    log("    flash kernels: " + ", ".join(
        f"{label} {ms:.3f} ms ({n}x)" for label, (ms, n) in found.items())
        + f"; {sum(ms for ms, _ in found.values()):.3f} ms of "
          f"{busy_ms:.1f} ms device time")


def bf16_launches(launches, want):
    """Whether a bf16 model's flash counts are ``want`` launches of each
    kernel, every one on its wgmma route, and none on the f32 route
    (``_tf32x3``, forward and backward)."""
    return all(n == (0 if name.endswith("_tf32x3") else want)
               for name, n in launches.items())


def bert_main_path(torch, fl, rehearsal):
    """``bert_pretraining.main`` at the bench configuration; returns the
    flash launch counts of its run.  Then a trainer built as ``main``
    builds it takes one accumulation boundary (its reduced gradients
    must be finite) and, on the card, 2 more micro-batches under
    ``torch.profiler``."""
    from horovod_tpu_torch.examples import bert_pretraining as bp
    steps, traced, batch = (6, 0, 4) if rehearsal else (8, 2, 32)
    if rehearsal:
        argv = ["--device", "cpu", "--size", "tiny", "--seq-len", "32",
                "--mlm-positions", "5"]
    else:
        argv = ["--size", "large", "--seq-len", "128", "--mlm-positions",
                "20"]
    argv += ["--batch-per-slot", str(batch), "--accum", "2", "--attention",
             "flash", "--steps", str(steps)]
    log(f"  bert_pretraining.main({argv})")
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    for name in fl.LAUNCHES:  # the counts cover exactly the main path's run
        fl.LAUNCHES[name] = 0
    losses, samples_s = bp.main(argv)
    launches = dict(fl.LAUNCHES)
    peak = 0 if rehearsal else torch.cuda.max_memory_allocated()
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  flash launches {launches} over {steps} micro-batches")
    failures = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses not finite and falling: {losses}")
    if not rehearsal:
        want = 24 * steps
        if not bf16_launches(launches, want):
            failures.append(f"flash launches {launches}, expected {want} "
                            f"each (24 layers x {steps} micro-batches), "
                            f"none on the f32 route")
    model, _, micro_batch = bp.build(bp.parse_args(argv))
    micro_batch()
    micro_batch()  # the boundary: p.grad holds the reduced gradients
    if not all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters()):
        failures.append("a gradient is not finite")
    if not rehearsal:
        micro_ms = batch / samples_s * 1e3   # world size 1
        log(f"  samples/s {samples_s:.1f}; micro-batch {micro_ms:.2f} ms, "
            f"optimizer step (2 micro-batches) {2 * micro_ms:.2f} ms; peak "
            f"device memory {peak / 2**20:.1f} MiB")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(traced):
                micro_batch()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        busy_ms = _busy_ms(torch, prof)
        log(f"  traced {traced} micro-batches: wall {wall_ms:.1f} ms, device "
            f"busy {busy_ms / wall_ms:.3f} of wall (idle "
            f"{1 - busy_ms / wall_ms:.3f})")
        # The profiler's host tracing slows the host, not the device: the
        # traced device time per micro-batch over the untraced micro-batch
        # time is the busy share the timed steps had.
        dev_ms = busy_ms / traced
        log(f"  device time per micro-batch {dev_ms:.2f} ms (traced) of "
            f"{micro_ms:.2f} ms untraced: busy {dev_ms / micro_ms:.3f} of an "
            f"untraced micro-batch")
        _top_ops(torch, prof)
        _flash_share(torch, prof, busy_ms)
    del model, micro_batch
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("training path failed")
    return launches, samples_s


# The bf16 flash step against the dense step, norm-wise per parameter:
# ||g_flash - g_dense|| / ||g_dense||.  The two paths round to bf16 at
# different places inside attention: the flash path rounds out, dq, dk
# and dv from its own f32 sums and P and dS before the wgmma products;
# the dense path rounds out and the input gradients from autograd's f32
# sums.  Each such rounding moves a value by at most 2**-8 (bf16's unit
# roundoff); a layer's attention gradients pass through at most 4 of
# them (out, P, dS, the rounded gradient), so the 2 layers move a
# gradient by at most 2 * 4 * 2**-8 = 2**-5 of its norm when the maps
# between them (LayerNorm, the residual stream, the bf16 products both
# paths share) do not amplify it, as at this random initialization.
BF16_STEP_BOUND = 2**-5


def flash_vs_dense_step(torch, device, rehearsal, dtype):
    """One step of a 2-layer model at BERT-large width through the flash
    kernels, against the same model with dense attention (the plain
    formula).  f32 (the kernels' split-precision TF32 route): loss and
    every gradient at 2e-3 / 2e-4.  bf16 (the main path's products, so
    the kernels' wgmma route): the loss and each parameter's
    gradient norm-wise within BF16_STEP_BOUND.  Returns the flash launch
    counts of the flash model's step, counted from 0."""
    import dataclasses
    from horovod_tpu_torch.models import BERT_LARGE, Transformer, lm_loss
    from horovod_tpu_torch.models.transformer import init_gpt2_
    from horovod_tpu_torch.parallel import flash as fl
    cfg = dataclasses.replace(BERT_LARGE, num_layers=2, max_len=128,
                              dtype=dtype, attention_impl="flash")
    B, S, K = 8, 128, 20
    if rehearsal:
        cfg = dataclasses.replace(cfg, vocab_size=97, num_heads=4,
                                  d_model=64, d_ff=128)
        B, S, K = 2, 32, 5
    rng = np.random.RandomState(3)
    tokens = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, S)),
                             device=device)
    pos = torch.as_tensor(np.sort(np.stack(
        [rng.choice(S, K, replace=False) for _ in range(B)])), device=device)
    labels = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, K)),
                             device=device)
    flash = init_gpt2_(Transformer(cfg, device=device),
                       torch.Generator(device=device).manual_seed(5))
    dense = Transformer(dataclasses.replace(cfg, attention_impl=None),
                        device=device)
    dense.load_state_dict(flash.state_dict())
    out = []
    for m in (flash, dense):
        for name in fl.LAUNCHES:  # the counts cover exactly this step
            fl.LAUNCHES[name] = 0
        loss = lm_loss(m(tokens, predict_positions=pos), labels)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out.append((loss.detach(), grads, dict(fl.LAUNCHES)))
    (lf, gf, launches), (ld, gd, _) = out
    head = (f"  {str(dtype).split('.')[-1]} 2-layer BERT-large width, B={B} "
            f"S={S}: loss flash {float(lf):.6f} dense {float(ld):.6f}, ")
    if dtype == torch.float32:
        err = max(float((a - b).abs().max()) for a, b in zip(gf, gd))
        ok = bool(torch.allclose(lf, ld, rtol=2e-3, atol=2e-4)) and all(
            bool(torch.allclose(a, b, rtol=2e-3, atol=2e-4))
            for a, b in zip(gf, gd))
        if not rehearsal:  # one launch of each per layer, on its route
            ok = ok and all(
                launches[f"flash_{k}_{route}"] == n
                for k in ("fwd", "bwd_dq", "bwd_dkv")
                for route, n in (("tf32x3", cfg.num_layers), ("wgmma", 0)))
        log(head + f"max grad abs err {err:.3e}, launches {launches} "
            f"({'ok' if ok else 'MISMATCH'} at 2e-3/2e-4)")
    else:
        names = [n for n, _ in flash.named_parameters()]
        rel = sorted(((float((a - b).norm() / b.norm()), n)
                      for a, b, n in zip(gf, gd, names)), reverse=True)
        loss_rel = float((lf - ld).abs() / ld.abs())
        ok = all(np.isfinite(r) and r <= BF16_STEP_BOUND for r, _ in rel) \
            and loss_rel <= BF16_STEP_BOUND
        log(head + f"loss rel err {loss_rel:.3e}, largest norm-wise "
            f"grad rel err " + ", ".join(f"{n} {r:.3e}" for r, n in rel[:4])
            + f" ({'ok' if ok else 'MISMATCH'} at {BF16_STEP_BOUND})")
    if not ok:
        raise SystemExit("flash step disagrees with the dense step")
    return launches


def gpt2_flash_steps(torch, fl, device, rehearsal):
    """3 steps of GPT-2 small (bf16 products) with causal flash attention
    at 1024 tokens through DistributedOptimizer."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import create_gpt2, lm_loss
    kw = dict(attention_impl="flash", dtype=torch.bfloat16)
    B, S = 4, 1024
    if rehearsal:
        kw.update(num_layers=2, num_heads=2, d_model=32, d_ff=64,
                  vocab_size=97, max_len=64, dtype=torch.float32)
        B, S = 2, 64
    model = create_gpt2("small", device=device, seed=9, **kw)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    tokens = torch.as_tensor(np.random.RandomState(4).randint(
        0, model.cfg.vocab_size, (B, S)), device=device)
    before = dict(fl.LAUNCHES)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = lm_loss(model(tokens)[:, :-1], tokens[:, 1:])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    launches = {k: fl.LAUNCHES[k] - before[k] for k in before}
    log(f"  gpt2-small causal flash, B={B} S={S}: losses "
        f"{[round(x, 4) for x in losses]}, launches {launches}")
    bad = not all(np.isfinite(losses)) or not losses[-1] < losses[0]
    if not rehearsal and not bf16_launches(launches,
                                           3 * model.cfg.num_layers):
        bad = True
    if bad:
        raise SystemExit("GPT-2 flash steps failed")


def training_phase(torch, device, rehearsal):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import flash as fl
    try:
        launches, _ = bert_main_path(torch, fl, rehearsal)
        f32_launches = flash_vs_dense_step(torch, device, rehearsal,
                                           torch.float32)
        flash_vs_dense_step(torch, device, rehearsal, torch.bfloat16)
        gpt2_flash_steps(torch, fl, device, rehearsal)
    finally:
        hvd.shutdown()  # the process group the trainer's init formed
    return launches, f32_launches


# ---------------------------------------------------------------------------
# Phase 6: the ResNet-50 training path
# ---------------------------------------------------------------------------

# Batch norms of ResNet-50: the stem's, three in each of 16 blocks and the
# four projections'.  Synchronized, each runs one statistics allreduce
# forward and one backward per step.
RESNET50_BATCH_NORMS = 1 + 3 * 16 + 4


def card_tag() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {smi.stderr.strip()}"


def resnet_checks(torch, device, rehearsal):
    """The ResNet path's pieces on the device in f32: the space-to-depth
    stem against the naive 7x7/s2 SAME conv at 224, max_pool_eq_grad's
    backward against the naive pool's (tie-free) and its gradient sum
    (every window tied), and a small ResNet step against the same step on
    the CPU (logits, loss, statistics 2e-4 / 2e-4, gradients
    2e-3 / 2e-4)."""
    from horovod_tpu_torch.models import resnet as tr
    f32 = torch.float32
    rng = np.random.RandomState(21)
    n, hw = (2, 32) if rehearsal else (8, 224)
    x = torch.as_tensor(rng.randn(n, hw, hw, 3).astype(np.float32),
                        device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    naive = tr.NaiveStem(3, 64, dtype=f32, device=device)
    naive.reset_parameters(gen)
    s2d = tr.SpaceToDepthStem(3, 64, dtype=f32, device=device)
    s2d.load_state_dict(naive.state_dict())
    with torch.no_grad():
        a, b = s2d(x), naive(x)
    err = float((a - b).abs().max())
    ok = bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))
    log(f"  SpaceToDepthStem vs 7x7/s2 SAME conv, {list(x.shape)} f32: max "
        f"abs err {err:.3e} ({'ok' if ok else 'MISMATCH'} at 1e-5)")
    failures = [] if ok else ["SpaceToDepthStem != naive stem"]

    c, ph = 64, hw // 2
    perm = rng.permutation(n * ph * ph * c).reshape(n, ph, ph, c)
    xs = {"tie-free": torch.as_tensor(perm.astype(np.float32),
                                      device=device),
          "all tied": torch.ones((n, ph, ph, c), device=device)}
    g = torch.as_tensor(rng.rand(n, ph // 2, ph // 2, c).astype(np.float32),
                        device=device)
    for name, xp in xs.items():
        grads = []
        for pool in (tr.max_pool_eq_grad, tr.max_pool_3x3s2):
            xg = xp.clone().requires_grad_()
            (pool(xg) * g).sum().backward()
            grads.append(xg.grad)
        if name == "tie-free":
            err = float((grads[0] - grads[1]).abs().max())
            ok = bool(torch.allclose(grads[0], grads[1], rtol=1e-6,
                                     atol=1e-6))
            what = f"backward vs the naive pool's: max abs err {err:.3e}"
        else:
            got, want = float(grads[0].double().sum()), float(g.double().sum())
            ok = abs(got - want) <= 1e-5 * abs(want)
            what = f"gradient sum {got:.6f}, pooled gradient sum {want:.6f}"
        log(f"  max_pool_eq_grad {name} {list(xp.shape)}: {what} "
            f"({'ok' if ok else 'MISMATCH'})")
        if not ok:
            failures.append(f"max_pool_eq_grad {name}")

    xb = rng.randn(4, 32, 32, 3).astype(np.float32)
    yb = rng.randint(0, 10, (4,))
    small = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8,
                 dtype=f32)
    ref = tr.init_kernels_(tr.ResNet(**small, device="cpu"),
                           torch.Generator().manual_seed(4))
    mine = tr.ResNet(**small, device=device)
    mine.load_state_dict(ref.state_dict())
    out = []
    for m in (ref, mine):
        dev = next(m.parameters()).device
        logits = m(torch.as_tensor(xb, device=dev), train=True)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.as_tensor(yb, device=dev))
        loss.backward()
        out.append((logits.detach().cpu(), loss.detach().cpu(),
                    {k: v.cpu() for k, v in m.named_buffers()},
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (l0, s0, b0, g0), (l1, s1, b1, g1) = out
    checks = [("logits", l1, l0, 2e-4, 2e-4), ("loss", s1, s0, 2e-4, 2e-4)]
    checks += [(k, b1[k], v, 2e-4, 2e-4) for k, v in b0.items()]
    checks += [(k, g1[k], v, 2e-3, 2e-4) for k, v in g0.items()]
    bad = [k for k, a, b, rt, at in checks
           if not torch.allclose(a, b, rtol=rt, atol=at)]
    err = max(float((a - b).abs().max()) for _, a, b, _, _ in checks)
    log(f"  ResNet([1, 1]) f32 step, 4x32x32, {device.type} vs cpu: "
        f"{len(checks)} tensors, max abs err {err:.3e} "
        f"({'ok' if not bad else 'MISMATCH ' + ', '.join(bad[:4])})")
    if bad:
        failures.append("small ResNet step on the device != on the CPU")
    return failures


def resnet_phase(torch, device, rehearsal):
    """``synthetic_benchmark.main`` at the JAX configuration (ResNet-50,
    224x224x3, 1000 classes, 128 images per slot, bf16, synchronized
    batch norm, an NCCL world of one; 5 warm-up and 10 timed steps), then
    3 steps of bench.py's configuration (the fast stem) on a second
    trainer, 2 of them traced; returns the statistics allreduces per
    step of the main run."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import sync_batch_norm as sbn
    from horovod_tpu_torch.examples import synthetic_benchmark as sb
    warm, iters, batch, hw = (1, 1, 2, 32) if rehearsal else (5, 10, 128, 224)
    argv = ["--model", "resnet50", "--batch-size", str(batch),
            "--num-warmup-batches", str(warm), "--num-iters", str(iters),
            "--image-size", str(hw)]
    if rehearsal:
        argv += ["--device", "cpu"]
    tag = "" if rehearsal else f" [{card_tag()}]"
    failures = []
    try:
        log(f"  synthetic_benchmark.main({argv})")
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        for k in sbn.STATS_ALLREDUCES:  # the counts cover the main run only
            sbn.STATS_ALLREDUCES[k] = 0
        losses, img_s = sb.main(argv)
        counts = dict(sbn.STATS_ALLREDUCES)
        peak = 0 if rehearsal else torch.cuda.max_memory_allocated()
        steps = warm + iters
        per_step = {k: v / steps for k, v in counts.items()}
        log(f"  losses {[round(x, 4) for x in losses]}")
        log(f"  statistics allreduces per step {per_step} (expected "
            f"{RESNET50_BATCH_NORMS} each)")
        if not all(np.isfinite(losses)) or len(losses) != steps:
            failures.append(f"losses not finite: {losses}")
        if per_step != {"forward": RESNET50_BATCH_NORMS,
                        "backward": RESNET50_BATCH_NORMS}:
            failures.append(f"statistics allreduces {counts} over {steps} "
                            f"steps")
        if not rehearsal:
            log(f"  images/s {img_s:.1f}; step {batch / img_s * 1e3:.2f} ms "
                f"(128 images); peak device memory {peak / 2**20:.1f} "
                f"MiB{tag}")
        bench = sb.parse_args(argv + ["--fast-stem"])
        log(f"  bench.py configuration (fast stem): 3 steps on a trainer "
            f"from build()")
        model, step = sb.build(bench)
        n0 = dict(sbn.STATS_ALLREDUCES)
        bench_losses = [float(step())]
        if not all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters()):
            failures.append("a gradient is not finite")
        if rehearsal:
            bench_losses += [float(step()) for _ in range(2)]
        else:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                traced = [step() for _ in range(2)]
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            bench_losses += [float(x) for x in traced]
            busy_ms = _busy_ms(torch, prof)
            step_ms = batch / img_s * 1e3
            log(f"  traced 2 steps: wall {wall_ms:.1f} ms, device busy "
                f"{busy_ms / wall_ms:.3f} of wall (idle "
                f"{1 - busy_ms / wall_ms:.3f}){tag}")
            log(f"  device time per step {busy_ms / 2:.2f} ms (traced) of "
                f"{step_ms:.2f} ms untraced: busy "
                f"{busy_ms / 2 / step_ms:.3f} of an untraced step{tag}")
            cpu = torch.autograd.DeviceType.CPU
            rows = sorted(((e.self_device_time_total, e.count, e.key)
                           for e in prof.key_averages()
                           if e.device_type != cpu
                           and not e.is_user_annotation), reverse=True)
            for us, count, key in rows[:10]:
                log(f"    {us / 1e3:9.3f} ms  {count:6d}x  {key[:80]}{tag}")
            # The convolutions' share: the device time of the kernels
            # that cuDNN's forward and backward ops launched.
            conv_ms = sum(e.device_time_total for e in prof.key_averages()
                          if e.device_type == cpu and e.key in (
                              "aten::convolution",
                              "aten::convolution_backward")) / 1e3
            log(f"    convolutions (forward, dgrad, wgrad): {conv_ms:.2f} ms "
                f"of {busy_ms:.2f} ms device time; the rest (batch norms, "
                f"ReLU, residual adds, casts, pools, optimizer) "
                f"{busy_ms - conv_ms:.2f} ms{tag}")
        bench_counts = {k: sbn.STATS_ALLREDUCES[k] - n0[k] for k in n0}
        log(f"  bench losses {[round(x, 4) for x in bench_losses]}, "
            f"statistics allreduces {bench_counts} over 3 steps")
        if not all(np.isfinite(bench_losses)):
            failures.append(f"bench losses not finite: {bench_losses}")
        if bench_counts != {"forward": 3 * RESNET50_BATCH_NORMS,
                            "backward": 3 * RESNET50_BATCH_NORMS}:
            failures.append(f"bench statistics allreduces {bench_counts}")
        del model, step
        failures += resnet_checks(torch, device, rehearsal)
    finally:
        hvd.shutdown()  # the process group the trainer's init formed
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("ResNet training path failed")
    return per_step


# ---------------------------------------------------------------------------
# Phase 7: the collective API over NCCL
# ---------------------------------------------------------------------------

COLLECTIVE_DTYPES = ("float32", "bfloat16", "float16", "int32", "int64",
                     "bool")


def single_scale(torch, x, factor):
    """What a world of one gives for a pre- or postscale: f16/bf16 scale
    in f32 and round once, integers truncate (the JAX package's
    ``_apply_scale``), on the CPU."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() * factor).to(x.dtype)
    if not x.is_floating_point():
        return (x * factor).to(x.dtype)
    return x * factor


def collective_checks(torch, hvd, device):
    """Every new op of the collective API in a world of one, on each
    dtype, against the value a world of one must give (``single`` in the
    JAX package's ops), computed on the CPU.  Returns the failures."""
    failures, n_checked = [], 0

    def check(what, got, want):
        nonlocal n_checked
        n_checked += 1
        outs = got if isinstance(got, (list, tuple)) else [got]
        wants = want if isinstance(want, (list, tuple)) else [want]
        for g, w in zip(outs, wants):
            if g.device.type != device.type:
                failures.append(f"{what}: output on {g.device}")
            elif g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.equal(g.cpu(), w):
                failures.append(f"{what}: {g.dtype} {tuple(g.shape)} != "
                                f"{w.dtype} {tuple(w.shape)} or values")
        if len(outs) != len(wants):
            failures.append(f"{what}: {len(outs)} outputs, {len(wants)} "
                            f"expected")

    rng = np.random.RandomState(7)
    ps0 = hvd.add_process_set([0])
    whole = hvd.partition_process_sets(1)[0]
    if whole is not ps0 or ps0.process_set_id != 1:
        failures.append(f"set registration: {ps0!r}, {whole!r}")
    for name in COLLECTIVE_DTYPES:
        dt = getattr(torch, name)
        cpu = torch.as_tensor(rng.randn(5, 3) * 8).to(dt)
        x = cpu.to(device)
        empty = x[:0]
        check(f"allgather {name}", hvd.allgather(x), cpu)
        check(f"allgather {name} 0 rows", hvd.allgather(empty, process_set=ps0),
              cpu[:0])
        check(f"grouped_allgather {name}",
              hvd.grouped_allgather([x, x[:2]]), [cpu, cpu[:2]])
        check(f"allgather_async {name}",
              hvd.synchronize(hvd.allgather_async(x)), cpu)
        check(f"alltoall {name}", hvd.alltoall(x, process_set=ps0), cpu)
        out, recv = hvd.alltoall(x, splits=[5])
        check(f"alltoall splits {name}", [out, recv],
              [cpu, torch.tensor([5], dtype=torch.int32)])
        h = hvd.alltoall_async(x)
        hvd.poll(h)
        check(f"alltoall_async {name}", hvd.synchronize(h), cpu)
        check(f"broadcast {name}", hvd.broadcast(x, 0, process_set=ps0), cpu)
        t = x.clone()
        check(f"broadcast_ {name}", [hvd.broadcast_(t, 0), t], [cpu, cpu])
        check(f"broadcast_async_ {name}",
              hvd.synchronize(hvd.broadcast_async_(x.clone(), 0)), cpu)
        if dt == torch.bool:
            # A bool sum counts (int32), as lax.psum does; JAX refuses a
            # bool reduce-scatter.
            check("allreduce Sum bool", hvd.allreduce(x, op=hvd.Sum),
                  cpu.to(torch.int32))
            try:
                hvd.reducescatter(x)
                failures.append("reducescatter of bool did not raise")
            except TypeError:
                pass
            continue
        for op in (hvd.Sum, hvd.Average):
            want = single_scale(torch, single_scale(torch, cpu, 0.5), 3.0)
            check(f"reducescatter {op.name} {name}", hvd.reducescatter(
                x, op=op, prescale_factor=0.5, postscale_factor=3.0,
                process_set=ps0), want)
            check(f"allreduce_ {op.name} {name}", hvd.allreduce_(
                x.clone(), op=op, prescale_factor=0.5, postscale_factor=3.0),
                want)
        check(f"grouped_reducescatter {name}",
              hvd.grouped_reducescatter([x, x[:1]]), [cpu, cpu[:1]])
        check(f"reducescatter_async {name}",
              hvd.synchronize(hvd.reducescatter_async(x)), cpu)
        ts = [x.clone(), x[:2].clone()]
        check(f"grouped_allreduce_ {name}", hvd.grouped_allreduce_(
            ts, op=hvd.Sum, process_set=ps0) + ts, [cpu, cpu[:2]] * 2)
        t = x.clone()
        h = hvd.allreduce_async_(t, op=hvd.Sum)
        check(f"allreduce_async_ {name}", [hvd.synchronize(h), t], [cpu, cpu])
        check(f"grouped_allreduce_async {name}", hvd.synchronize(
            hvd.grouped_allreduce_async([x, x[:1]], op=hvd.Sum)),
            [cpu, cpu[:1]])

    obj = {"step": 3, "lr": [0.1, 0.01], "name": "phase 7",
           "nested": {"shape": (5, 3), "tags": {"a", "b"}, "none": None}}
    got = [hvd.broadcast_object(obj), hvd.broadcast_object_fn()(obj),
           hvd.allgather_object(obj, process_set=ps0)]
    n_checked += 3
    if got != [obj, obj, [obj]]:
        failures.append(f"object helpers gave {got}")

    dense = torch.zeros(6, 4)
    dense[[0, 2, 5], [1, 1, 3]] = torch.tensor([1.5, -2.0, 4.0])
    sp = dense.to_sparse().to(device)
    for op in (hvd.Sum, hvd.Average):
        out = hvd.sparse_allreduce(sp, op=op, process_set=ps0)
        if not out.is_sparse:
            failures.append(f"sparse_allreduce {op.name}: dense output")
        check(f"sparse_allreduce {op.name}", hvd.densify_if_sparse(out),
              dense)

    # Three SGD-momentum steps of the MLP through the optimizer over the
    # set, against plain SGD on the same gradients.
    from horovod_tpu_torch.models.mlp import create_mlp
    model = create_mlp((128, 10), in_features=784, device=device, seed=0)
    plain = create_mlp((128, 10), in_features=784, device=device, seed=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9), process_set=ps0)
    ref = torch.optim.SGD(plain.parameters(), lr=0.05, momentum=0.9)
    gen = torch.Generator(device=device).manual_seed(11)
    for _ in range(3):
        xb = torch.randn(32, 784, device=device, generator=gen)
        for m, o in ((model, opt), (plain, ref)):
            o.zero_grad()
            (m(xb) ** 2).mean().backward()
            o.step()
    n_checked += 1
    for (k, a), b in zip(model.state_dict().items(),
                         plain.state_dict().values()):
        if not a.is_cuda == (device.type == "cuda") or \
                not torch.equal(a, b):
            failures.append(f"DistributedOptimizer(process_set) {k} != "
                            f"plain SGD")
    log(f"  {n_checked} checks of the new ops on {device.type} tensors of "
        f"{', '.join(COLLECTIVE_DTYPES)} over {hvd.ops.dist.get_backend()}"
        f": {'ok' if not failures else f'{len(failures)} FAILED'}")
    return failures


def collective_timing(torch, hvd, device):
    """Device time of one call of allreduce, allgather, alltoall and
    reducescatter at 4 KiB and 64 MiB of f32 (CUDA events around each
    call, mean over the calls), every call through the eager engine, and
    of one device-to-device copy of the same bytes, the yardstick.  In a
    world of one these show the port's per-call overhead (the engine, the
    launches), not the link."""
    ops = {"allreduce": hvd.allreduce, "allgather": hvd.allgather,
           "alltoall": hvd.alltoall, "reducescatter": hvd.reducescatter}
    out = {}
    for label, numel, iters in (("4KiB", 1024, 50), ("64MiB", 16 << 20, 10)):
        x = torch.randn(numel, device=device)
        dst = torch.empty_like(x)
        calls = dict(ops)
        calls["d2d_copy"] = lambda t: dst.copy_(t)
        for name, fn in calls.items():
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(iters)]
            for start, end in pairs:
                start.record()
                fn(x)
                end.record()
            torch.cuda.synchronize()
            ms = sum(s.elapsed_time(e) for s, e in pairs) / iters
            out.setdefault(name, {})[label] = ms
            log(f"  {name:13s} {label:>5s} f32: {ms:.4f} ms per call")
    return out


def collectives_phase(torch, device, rehearsal):
    """Phase 7: ``hvd.init()`` (an NCCL world of one on the card, gloo on
    the CPU), every new op checked, then timed on the card; returns the
    times (None on the CPU)."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu" if rehearsal else None)
    try:
        backend = hvd.ops.dist.get_backend()
        want = "gloo" if rehearsal else "nccl"
        failures = [] if backend == want else [f"backend {backend}"]
        failures += collective_checks(torch, hvd, device)
        for f in failures[:20]:
            log(f"  FAIL: {f}")
        if failures:
            raise SystemExit("collective API failed")
        if rehearsal:
            return None
        return {"card": card_tag(), "world_size": hvd.size(),
                "backend": backend, "ms_per_call":
                collective_timing(torch, hvd, device)}
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Phase 8: Adasum and GPT-2-medium training
# ---------------------------------------------------------------------------

# GPT-2-medium's two largest parameter shapes: the token embedding and a
# block's fc1 kernel.
ADASUM_SHAPES = {"wte [50257, 1024]": (50257, 1024),
                 "fc1 [1024, 4096]": (1024, 4096)}
ADASUM_REHEARSAL_SHAPES = {"[97, 32]": (97, 32), "[32, 128]": (32, 128)}


def adasum_model(torch, stack, round_to=None, half=True):
    """The float64 model of Adasum's tree over a [n, ...] stack (the
    reference's pair combine, adasum.h:396-409, zero-padded to a power of
    two), on the CPU; ``round_to`` rounds each level's result to that
    dtype, as the port and JAX cast each combine back to the input's.
    ``half=False`` drops the factor 2 of ``dot / (2·||a||²)``: a wrong
    combine, for the check's control."""
    level = [t.double() for t in stack]
    while len(level) & (len(level) - 1):
        level.append(torch.zeros_like(level[0]))
    d = 2 if half else 1
    while len(level) > 1:
        nxt = []
        for a, b in zip(level[0::2], level[1::2]):
            dot, na, nb = (a * b).sum(), (a * a).sum(), (b * b).sum()
            out = (1 - dot / (d * na) if na > 0 else 1.0) * a \
                + (1 - dot / (d * nb) if nb > 0 else 1.0) * b
            nxt.append(out if round_to is None
                       else out.to(round_to).double())
        level = nxt
    return level[0]


def adasum_ranks(torch, shape, gen):
    """4 correlated "ranks" [4, *shape], so that every coefficient lies
    far from 1: r1 = 0.8·r0 + 0.6·n1 (the pair's coefficients ~0.6),
    r2 = -0.6·r0 + 0.8·n2 and r3 = r2 + 0.05·n3, nearly parallel to r2
    (~0.5); the tree's top pair then gets ~1.25 and ~1.3.  A plain Sum,
    or a combine without the factor 2, misses the result by tens of
    percent."""
    n = torch.randn((4,) + shape, generator=gen)
    n[1].mul_(0.6).add_(n[0], alpha=0.8)
    n[2].mul_(0.8).add_(n[0], alpha=-0.6)
    n[3].mul_(0.05).add_(n[2])
    return n


def adasum_checks(torch, device, shapes):
    """Adasum's combine on ``device`` against the float64 model on the
    CPU, for a stack of 4 correlated "ranks" (``adasum_ranks``) at each
    shape: ``pair_combine`` of the first two and
    ``_tree_reduce_gathered`` of all four, in f32 with f32 islands, in
    f32 with ``HVD_ADASUM_ACC_DTYPE=f64``, and in bf16 with f32 islands.
    f32: rtol 1e-4 (JAX's tests/test_adasum.py:73) and an atol of 1e-6
    times the model's largest magnitude (an element that cancels to ~0
    keeps f32's absolute rounding).  bf16: the model rounds each level
    to bf16 as the port does, and the two may then differ by one bf16
    step (2**-8) of the largest magnitude where an island's last bit
    moves a rounding.  Each line gives the largest error over its
    tolerance (err/tol, 1 at the limit) of the port and of two controls
    held to the same check, a plain Sum and the model without the
    factor 2: a control that passes fails the case, since the check
    could not tell it from Adasum.  Returns the failures and one line
    per case."""
    import os
    from horovod_tpu_torch.ops import adasum as ada
    failures, lines = [], []
    gen = torch.Generator().manual_seed(8)
    old = os.environ.get("HVD_ADASUM_ACC_DTYPE")

    def over_tol(got, want, rtol, atol):
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())

    try:
        for label, shape in shapes.items():
            host = adasum_ranks(torch, shape, gen)
            models = {}
            for dtype, acc in ((torch.float32, "f32"),
                               (torch.float32, "f64"),
                               (torch.bfloat16, "f32")):
                os.environ["HVD_ADASUM_ACC_DTYPE"] = acc
                x = host.to(dtype)
                round_to = dtype if dtype == torch.bfloat16 else None
                if dtype not in models:
                    models[dtype] = {
                        k: (adasum_model(torch, s, round_to),
                            s.double().sum(0),
                            adasum_model(torch, s, round_to, half=False))
                        for k, s in (("pair", x[:2]), ("tree", x))}
                dev = x.to(device)
                for what, key, got in (
                        ("pair_combine", "pair",
                         ada.pair_combine(dev[0], dev[1])),
                        ("tree of 4", "tree", ada._tree_reduce_gathered(dev))):
                    want, plain_sum, no_half = models[dtype][key]
                    top = float(want.abs().max())
                    rtol, atol = ((1e-4, 1e-6 * top) if round_to is None
                                  else (2**-8, 2**-8 * top))
                    got = got.double().cpu()
                    err = float((got - want).abs().max())
                    r, r_sum, r_half = (over_tol(t, want, rtol, atol)
                                        for t in (got, plain_sum, no_half))
                    ok = (got.dtype == torch.float64 and r <= 1.0
                          and r_sum > 1.0 and r_half > 1.0)
                    name = (f"{what} {label} {str(dtype).split('.')[-1]} "
                            f"islands {acc}")
                    lines.append(
                        f"{name}: max abs err {err:.3e}, err/tol {r:.3f} "
                        f"({'ok' if ok else 'MISMATCH'} at {rtol:.3g} / "
                        f"{atol:.3g}); controls err/tol: Sum {r_sum:.1f}, "
                        f"no factor 2 {r_half:.1f}")
                    if not ok:
                        failures.append(name)
                del dev
    finally:
        if old is None:
            os.environ.pop("HVD_ADASUM_ACC_DTYPE", None)
        else:
            os.environ["HVD_ADASUM_ACC_DTYPE"] = old
    return failures, lines


def adasum_main_path(torch, fl, rehearsal):
    """``gpt2_adasum.main``: GPT-2-medium at full width and depth (remat,
    causal flash attention, bf16 products), 4 sequences of 128 tokens, 10
    steps of ``local_value_and_grad`` + ``adasum_delta_step(SGD(0.05))``
    over NCCL in a world of one (the first 2 steps warm up, as the
    example times); the CPU rehearsal runs the example's TINY.  Returns
    the flash launch counts of the run and the numbers it printed."""
    from horovod_tpu_torch.examples import gpt2_adasum as ga
    steps, traced, size = (6, 0, "tiny") if rehearsal else (10, 2, "medium")
    argv = ["--size", size, "--steps", str(steps), "--batch-per-slot", "4",
            "--seq-len", "128", "--attention", "flash"]
    if rehearsal:
        argv += ["--device", "cpu"]
    log(f"  gpt2_adasum.main({argv})")
    if not rehearsal:
        torch.cuda.reset_peak_memory_stats()
    for name in fl.LAUNCHES:  # the counts cover exactly the main path's run
        fl.LAUNCHES[name] = 0
    failures = []
    try:
        losses, samples_s = ga.main(argv)
    except AssertionError as e:  # the example's own check: the loss falls
        raise SystemExit(f"GPT-2 Adasum training failed: {e}")
    launches = dict(fl.LAUNCHES)
    peak = 0 if rehearsal else torch.cuda.max_memory_allocated()
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  flash launches {launches} over {steps} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses not finite and falling: {losses}")
    numbers = {}
    if not rehearsal:
        # remat: each block's forward runs again in the backward pass.
        layers = 24
        want = {"flash_fwd": 2 * layers * steps,
                "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
        want.update({f"{k}_wgmma": n for k, n in list(want.items())})
        want.update({f"{k}_tf32x3": 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv")})
        log(f"  expected: forward 2 x 24 layers x {steps} steps = "
            f"{want['flash_fwd']}, dQ and dK/dV 24 x {steps} = "
            f"{want['flash_bwd_dq']} each, all on the wgmma route")
        if launches != want:
            failures.append(f"flash launches {launches}, expected {want}")
        step_ms = 4 / samples_s * 1e3   # world size 1
        tag = card_tag()
        log(f"  samples/s {samples_s:.2f}; step {step_ms:.2f} ms (4 x 128 "
            f"tokens); peak device memory {peak / 2**20:.1f} MiB [{tag}]")
        _, _, step = ga.build(ga.parse_args(argv))
        step()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(traced):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        busy_ms = _busy_ms(torch, prof)
        dev_ms = busy_ms / traced
        log(f"  traced {traced} steps: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms / wall_ms:.3f} of wall; device time per step "
            f"{dev_ms:.2f} ms (traced) of {step_ms:.2f} ms untraced: busy "
            f"{dev_ms / step_ms:.3f} of an untraced step [{tag}]")
        _top_ops(torch, prof)
        _flash_share(torch, prof, busy_ms)
        # Where the host clock goes: 3 steps with the device drained
        # before and after each step and each delta step.
        import horovod_tpu_torch as hvd
        real, spent = hvd.adasum_delta_step, []

        def timed_delta(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real(*args, **kwargs)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)

        hvd.adasum_delta_step = timed_delta
        try:
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        finally:
            hvd.adasum_delta_step = real
        wall_ms, delta_ms = (1e3 * sum(x) / 3 for x in (walls, spent))
        log(f"  drained steps: {wall_ms:.2f} ms a step, of which "
            f"adasum_delta_step {delta_ms:.2f} ms and the forward and "
            f"backward pass (local_value_and_grad) and the loss average "
            f"{wall_ms - delta_ms:.2f} ms [{tag}]")
        del step
        numbers = {"samples_per_s": samples_s, "step_ms": step_ms,
                   "peak_mib": peak / 2**20, "device_ms_per_step": dev_ms,
                   "busy_share": dev_ms / step_ms,
                   "drained_step_ms": wall_ms, "delta_step_ms": delta_ms,
                   "losses": losses}
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("GPT-2 Adasum training path failed")
    return launches, numbers


def adasum_phase(torch, device, rehearsal):
    """Phase 8: the main path (``adasum_main_path``); then Adasum over
    the world's one rank (NCCL on the card: ``allreduce``,
    ``grouped_allreduce`` and ``DistributedOptimizer(op=Adasum)`` give
    their input, on the card); ``adasum_checks`` at GPT-2-medium's
    largest leaf shapes; and, on the card, one ``pair_combine`` at wte's
    shape timed with CUDA events beside a device copy of one operand and
    the bytes bound (a and b read twice, the output written once).
    Returns the flash launch counts of the main path and the numbers."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as ada
    from horovod_tpu_torch.parallel import flash as fl
    try:
        launches, numbers = adasum_main_path(torch, fl, rehearsal)
        failures = []
        backend = hvd.ops.dist.get_backend()
        if backend != ("gloo" if rehearsal else "nccl"):
            failures.append(f"backend {backend}")
        x = torch.randn(1000, 7, device=device)
        outs = [hvd.allreduce(x, op=hvd.Adasum),
                hvd.allreduce(x, op=hvd.Adasum, postscale_factor=2.0) / 2]
        outs += hvd.grouped_allreduce([x, x[:3]], op=hvd.Adasum)
        w = torch.nn.Parameter(torch.zeros(7, device=device))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                       op=hvd.Adasum)
        w.grad = x[0].clone()
        opt.step()
        outs.append(-w.detach())
        for got, want in zip(outs, (x, x, x, x[:3], x[0])):
            if got.device != x.device or not torch.equal(got, want):
                failures.append(f"Adasum in a world of one changed its "
                                f"input (on {got.device})")
        log(f"  Adasum in a world of one over {backend}: allreduce, "
            f"postscale, grouped, DistributedOptimizer "
            f"{'ok' if not failures else 'MISMATCH'}")
        bad, lines = adasum_checks(
            torch, device,
            ADASUM_REHEARSAL_SHAPES if rehearsal else ADASUM_SHAPES)
        for line in lines:
            log("  " + line)
        failures += bad
        if not rehearsal:
            a, b = torch.randn((2,) + ADASUM_SHAPES["wte [50257, 1024]"],
                               device=device)
            flush = torch.empty(64 << 20, device=device)
            dst = torch.empty_like(a)
            ms = time_ms(torch, lambda: ada.pair_combine(a, b), 10, flush)
            copy_ms = time_ms(torch, lambda: dst.copy_(a), 10, flush)
            nbytes = 5 * a.numel() * a.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"  pair_combine wte [50257, 1024] f32: {ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB: a and b read "
                f"twice, the output written once), share "
                f"{bound_ms / ms:.3f}; device copy of a {copy_ms:.4f} ms "
                f"({2 * a.numel() * a.element_size() / copy_ms / 1e6:.0f} "
                f"GB/s) [{card_tag()}]")
            numbers["pair_combine"] = {"ms": ms, "bound_ms": bound_ms,
                                       "copy_ms": copy_ms}
            del a, b, flush, dst
        for f in failures:
            log(f"  FAIL: {f}")
        if failures:
            raise SystemExit("Adasum phase failed")
    finally:
        hvd.shutdown()  # the process group the trainer's init formed
    return launches, numbers


# ---------------------------------------------------------------------------
# Phase 9: the negotiated eager engine in a world of one
# ---------------------------------------------------------------------------

def native_core_check():
    """Build the native core (g++, from the checkout's hvd_core.cc) and
    exercise each of its parts once; returns (failures, build seconds)."""
    from horovod_tpu_torch.csrc import native
    t0 = time.monotonic()
    native.lib()
    build_s = time.monotonic() - t0
    bad = []
    c = native.NativeResponseCache(2)
    got = [c.lookup("t", "float32", [4]), c.put("t", "float32", [4]),
           c.lookup("t", "float32", [4]), c.lookup("t", "float32", [5])]
    if got != [native.CACHE_MISS, 0, native.CACHE_HIT, native.CACHE_INVALID]:
        bad.append(f"response cache {got}")
    mt = native.NativeMessageTable(2)
    mt.increment("g", "float32", [4], 1, 0)
    mt.increment("g", "float32", [5], 1, 1)
    if mt.validate("g") != "Mismatched shapes for collective g":
        bad.append(f"message table verdict {mt.validate('g')!r}")
    q = native.NativeTensorQueue()
    if [q.add("x", "", []), q.add("x", "", [])] != [True, False]:
        bad.append("tensor queue let a duplicate name in")
    si = native.NativeStallInspector(1.0, 0.0, 2)
    si.record_request("t", 0, 0.0)
    if si.check(2.0) != (1, [("t", 2.0, [0], [1])]):
        bad.append(f"stall report {si.check(2.0)}")
    if native.plan_fusion([("a", "float32", 8, 1, 0), ("b", "float16", 8, 1,
                                                        0),
                           ("c", "float32", 8, 1, 0)], 64) != [[0, 2], [1]]:
        bad.append("fusion plan")
    return bad, build_s


def timeline_spans(path):
    """Parse a timeline: the B/E spans by name, spans left open or closed
    without opening, and the dropped-events counter."""
    events = json.load(open(path))
    depth, spans, unmatched = {}, {}, 0
    for e in events:
        key = (e.get("tid"), e["name"])
        if e["ph"] == "B":
            depth[key] = depth.get(key, 0) + 1
            spans[e["name"]] = spans.get(e["name"], 0) + 1
        elif e["ph"] == "E":
            if depth.get(key, 0) == 0:
                unmatched += 1
            else:
                depth[key] -= 1
    last = events[-1]
    dropped = last["args"]["dropped"] \
        if last["name"] == "hvd_timeline_dropped_events_total" else None
    return {"events": len(events), "spans": spans,
            "open": sum(depth.values()), "unmatched_ends": unmatched,
            "dropped_events": dropped}


def eager_phase(torch, device, rehearsal):
    """Phase 9: the native core, then phase 5's GPT-2-small path (bf16,
    causal flash, 4 x 1024 tokens, 3 steps) in an NCCL world of one with
    ``hvd.start_timeline`` on: the timeline holds one ALLREDUCE and one
    NEGOTIATE_ALLREDUCE span per engine dispatch, every B has its E and
    nothing was dropped; a step timed with the timeline on and off (on,
    off, on, off; the means); a
    second op under a claimed name raises DuplicateNameError;
    ``join()`` returns 0; ``hierarchical_allreduce(local_size=1)`` gives
    the flat allreduce's bits; a cached 4 KiB allreduce taken apart and
    timed per call (``join_bench.engine_cost``: the engine with a data
    plane that does nothing, the data plane alone, the engine around
    it, the whole call, ``dist.all_reduce``).  Returns the flash launches of the timeline's
    3 steps and the numbers."""
    import os
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples.join_bench import engine_cost
    from horovod_tpu_torch.exceptions import DuplicateNameError
    from horovod_tpu_torch.models import create_gpt2, lm_loss
    from horovod_tpu_torch.parallel import flash as fl
    failures, build_s = native_core_check()
    log(f"  native core built in {build_s:.1f} s; self-check "
        f"{'ok' if not failures else failures}")
    kw = dict(attention_impl="flash", dtype=torch.bfloat16)
    B, S = 4, 1024
    if rehearsal:
        kw.update(num_layers=2, num_heads=2, d_model=32, d_ff=64,
                  vocab_size=97, max_len=64, dtype=torch.float32)
        B, S = 2, 64
    hvd.init(device="cpu" if rehearsal else None)
    tmp = tempfile.mkdtemp(prefix="hvd_timeline_")
    path = os.path.join(tmp, "timeline.json")
    try:
        eng = hvd.core._state.engine
        model = create_gpt2("small", device=device, seed=9, **kw)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        tokens = torch.as_tensor(np.random.RandomState(4).randint(
            0, model.cfg.vocab_size, (B, S)), device=device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize()

        def steps(n):
            losses = []
            t = time.perf_counter()
            for _ in range(n):
                opt.zero_grad()
                loss = lm_loss(model(tokens)[:, :-1], tokens[:, 1:])
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            sync()
            return losses, (time.perf_counter() - t) * 1e3 / n

        steps(1)  # warm-up
        for name in fl.LAUNCHES:  # the counts cover the timeline's steps
            fl.LAUNCHES[name] = 0
        d0 = eng.dispatches
        hvd.start_timeline(path)
        losses, on_ms = steps(3)
        hvd.stop_timeline()
        dispatches = eng.dispatches - d0
        launches = dict(fl.LAUNCHES)
        tl = timeline_spans(path)
        # Then off, on, off, so that neither side always runs first.
        _, off_ms = steps(3)
        hvd.start_timeline(os.path.join(tmp, "again.json"))
        _, on2_ms = steps(3)
        hvd.stop_timeline()
        os.remove(os.path.join(tmp, "again.json"))
        _, off2_ms = steps(3)
        on_ms, off_ms = (on_ms + on2_ms) / 2, (off_ms + off2_ms) / 2
        spans = tl["spans"]
        log(f"  gpt2-small B={B} S={S}, 3 steps with the timeline: losses "
            f"{[round(x, 4) for x in losses]}, {dispatches} engine "
            f"dispatches, timeline {tl}")
        log(f"  step {on_ms:.2f} ms with the timeline on, {off_ms:.2f} ms "
            f"off; flash launches {launches}")
        if not all(np.isfinite(losses)):
            failures.append(f"losses {losses}")
        if not (dispatches > 0
                and spans.get("ALLREDUCE") == dispatches
                and spans.get("NEGOTIATE_ALLREDUCE") == dispatches
                and tl["open"] == 0 and tl["unmatched_ends"] == 0
                and tl["dropped_events"] == 0):
            failures.append(f"timeline {tl} for {dispatches} dispatches")
        if not rehearsal and not bf16_launches(launches,
                                               3 * model.cfg.num_layers):
            failures.append(f"flash launches {launches}, expected "
                            f"{3 * model.cfg.num_layers} each on wgmma")
        del model, opt
        x = torch.randn(1024, device=device)  # 4 KiB of f32
        eng.claim_name("phase9.claimed")
        try:
            hvd.allreduce(x, name="phase9.claimed")
            failures.append("no DuplicateNameError under a claimed name")
        except DuplicateNameError:
            pass
        finally:
            eng.release_name("phase9.claimed")
        last = hvd.join()
        if last != 0:
            failures.append(f"join() returned {last}")
        y = torch.randn(50257, device=device)
        if not torch.equal(hvd.hierarchical_allreduce(y, local_size=1),
                           hvd.allreduce(y, op=hvd.Sum)):
            failures.append("hierarchical_allreduce(local_size=1) != flat")
        per_call = engine_cost(device, 100 if rehearsal else 1000)
        for label, c in per_call.items():
            log(f"  4 KiB allreduce, {label}: {c['host_us_per_call']:.1f} "
                f"us of host per call" + (
                    f", {c['device_ms_per_call']:.4f} ms of device"
                    if c["device_ms_per_call"] is not None else ""))
    finally:
        hvd.shutdown()
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("eager engine phase failed")
    return launches, {
        "native_build_s": build_s, "dispatches_per_step": dispatches / 3,
        "timeline": tl, "step_ms_timeline_on": on_ms,
        "step_ms_timeline_off": off_ms,
        "per_call_4KiB": per_call, "join": last,
        "flash_launches": launches}


# ---------------------------------------------------------------------------
# Phase 10: sequence parallelism on one card
# ---------------------------------------------------------------------------

RING_SHARDS = 4        # phase 10(b)'s virtual shards
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _by_mode(fl, launches, route):
    """Each kernel's launches on ``route`` by mask mode, from the
    wrappers' own counts (a copy of ``flash.LAUNCHES_BY_MODE``)."""
    return {k: {m: launches[f"{k}_{route}_{m}"] for m in fl.MODE_NAMES}
            for k in KERNELS}


def _gpt2_long(torch, rehearsal):
    """GPT-2 small at 8192 tokens (tiny at 64 in the rehearsal)."""
    kw = dict(attention_impl="flash", max_len=8192)
    if rehearsal:
        kw.update(num_layers=2, num_heads=4, d_model=64, d_ff=128,
                  vocab_size=97, max_len=64)
    return kw, kw["max_len"]


def seqpar_steps(torch, fl, device, rehearsal, seq_parallel):
    """2 bf16 steps of GPT-2 small over 8192 tokens with
    ``seq_parallel`` in the world of one, AdamW through
    DistributedOptimizer: the main path of phase 10 (a) (ring) or (c)
    (Ulysses).  Every count is set to 0 just before the steps; returns
    the flash launches of the steps alone, and by route and mask mode."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import create_gpt2, lm_loss
    from horovod_tpu_torch.parallel import ring
    kw, S = _gpt2_long(torch, rehearsal)
    model = create_gpt2("small", device=device, seed=11,
                        dtype=torch.float32 if rehearsal else torch.bfloat16,
                        seq_parallel=seq_parallel, **kw)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        0, model.cfg.vocab_size, (1, S + 1)), device=device)
    for counts in (fl.LAUNCHES, fl.LAUNCHES_BY_MODE):
        for name in counts:
            counts[name] = 0
    ring.ROTATIONS.update(forward=0, backward=0)
    calls = []
    ring.set_ring_kernel_callback(calls.append)
    losses = []
    try:
        for _ in range(2):
            opt.zero_grad()
            loss = lm_loss(model(toks[:, :-1]), toks[:, 1:])
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    finally:
        ring.set_ring_kernel_callback(None)
    launches, by_mode = dict(fl.LAUNCHES), dict(fl.LAUNCHES_BY_MODE)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"  {seq_parallel} gpt2-small S={S}, 2 steps in a world of one: "
        f"losses {[round(x, 4) for x in losses]}, ring hop calls "
        f"{len(calls)}, rotations {ring.ROTATIONS['forward']}, flash "
        f"launches {({k: v for k, v in launches.items() if v})}")
    L = model.cfg.num_layers
    ok = all(np.isfinite(losses))
    if seq_parallel == "ring":
        # n = 1: one CAUSAL hop a layer, on the f32 (3xTF32) route.
        ok = ok and calls == [fl.MASK_CAUSAL] * 2 * L \
            and ring.ROTATIONS["forward"] == 0
        route, other = "tf32x3", "wgmma"
    else:
        ok = ok and not calls
        route, other = "wgmma", "tf32x3"
    if not rehearsal:
        ok = ok and all(launches[f"{k}_{route}"] == 2 * L
                        and by_mode[f"{k}_{route}_causal"] == 2 * L
                        and launches[f"{k}_{other}"] == 0 for k in KERNELS)
    if not ok:
        raise SystemExit(f"{seq_parallel} steps failed")
    del model, opt
    return launches, by_mode


def ring_logits_check(torch, device, rehearsal):
    """Phase 10(a)'s model check: the f32 GPT-2 small at 8192 tokens
    under ``seq_parallel='ring'`` (n = 1: one CAUSAL hop a layer through
    ``flash_attention_lse``) against the same weights under plain
    ``flash_attention``, logits at 2e-3 (the JAX ring flash
    transformer's tolerance).  Both take the same f32 kernels: this
    holds the ring's wiring (the lse partial, the merge, the casts); the
    kernels are held against their plain versions at this shape in
    ``seqpar_phase``."""
    from horovod_tpu_torch.models import create_gpt2
    kw, S = _gpt2_long(torch, rehearsal)
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        0, 97 if rehearsal else 50257, (1, S)), device=device)
    logits = []
    with torch.no_grad():
        for sp in ("ring", None):
            m = create_gpt2("small", device=device, seed=11,
                            dtype=torch.float32, seq_parallel=sp, **kw)
            logits.append(m(toks))
            del m
    a, b = logits
    err = float((a - b).abs().max())
    ratio = float(((a - b).abs() / (2e-3 + 2e-3 * b.abs())).max())
    log(f"  ring (n = 1) f32 logits against plain flash_attention, S={S}: "
        f"max abs err {err:.3e}, err/tol {ratio:.4f} at 2e-3")
    if not ratio <= 1.0:
        raise SystemExit("ring logits disagree with flash_attention")
    return err


def virtual_ring_check(torch, fl, device, rehearsal):
    """Phase 10(b): 4 virtual shards of one [1, 8192, 12, 64] f32 q/k/v,
    contiguous and striped causal, through
    ``ring.virtual_ring_flash_attention`` (the ring's own ``_rank_hops``
    for each shard): the merged output and dq, dk, dv against
    ``flash_attention`` over the whole sequence at the f32 flash
    tolerances.  Returns the hop kernels' launches of the two drives
    alone, by mask mode (the wrappers' counts)."""
    from horovod_tpu_torch.parallel import ring
    shape = (1, 64, 2, 16) if rehearsal else (1, 8192, 12, 64)
    rng = np.random.RandomState(8)
    mk = lambda: torch.as_tensor(  # noqa: E731
        (rng.randn(*shape) * 0.5).astype(np.float32), device=device)
    q0, k0, v0, do = mk(), mk(), mk(), mk()
    (frt, fat), (grt, gat) = FLASH_TOL["float32"]
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    want = fl.flash_attention(*leaves, causal=True)
    want_g = torch.autograd.grad(want, leaves, do)
    want = want.detach()
    before = dict(fl.LAUNCHES_BY_MODE)
    calls = []
    for striped in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
        ring.set_ring_kernel_callback(calls.append)
        try:
            out = ring.virtual_ring_flash_attention(
                *leaves, RING_SHARDS, causal=True, striped=striped)
            got_g = torch.autograd.grad(out, leaves, do)
        finally:
            ring.set_ring_kernel_callback(None)
        out = out.detach()
        fwd = float(((out - want).abs() / (fat + frt * want.abs())).max())
        grad = max(float(((a - b).abs() / (gat + grt * b.abs())).max())
                   for a, b in zip(got_g, want_g))
        log(f"  virtual ring, {RING_SHARDS} shards of {list(shape)} f32 "
            f"causal {'striped' if striped else 'contiguous'}: against "
            f"flash_attention over the whole sequence, err/tol fwd "
            f"{fwd:.4f}, grads {grad:.4f}; max abs err out "
            f"{float((out - want).abs().max()):.3e}")
        if not (fwd <= 1.0 and grad <= 1.0):
            raise SystemExit("the virtual ring disagrees with "
                             "flash_attention")
    launches = {k: fl.LAUNCHES_BY_MODE[k] - before[k] for k in before}
    by_mode = _by_mode(fl, launches, "tf32x3")
    n = RING_SHARDS
    # Contiguous: n(n+1)/2 hops (n CAUSAL); striped: n² (n(n+1)/2 CAUSAL).
    want_modes = {"none": n * (n - 1) // 2,
                  "causal": n + n * (n + 1) // 2, "strict": n * (n - 1) // 2}
    got_calls = {m: calls.count(i) for i, m in enumerate(fl.MODE_NAMES)}
    log(f"  virtual ring hop launches by mode {by_mode} (want "
        f"{want_modes} for each kernel); hop calls {got_calls}")
    if got_calls != want_modes or (not rehearsal and any(
            by_mode[k] != want_modes for k in KERNELS)):
        raise SystemExit("virtual ring launches")
    return by_mode


def kernel_cases(torch, fl, device, rehearsal, rng, cases, flush):
    """Each case ``(name, shape, dtype, mode)``: the three kernels held
    against their plain versions (``flash_case``) and timed
    (``flash_timing``); returns ``{name: {kernel: record}}``."""
    out = {}
    for name, shape, dt, mode in cases:
        errs, ok, inputs, ratios = flash_case(torch, fl, rng, shape, dt,
                                              mode, device)
        log(f"  {name} {list(shape)} {str(dt).split('.')[-1]} "
            f"{fl.MODE_NAMES[mode]}: max_abs_err "
            + ", ".join(f"{k[6:]} {e:.3e}" for k, e in errs.items())
            + f"; err/tol fwd {ratios[0]:.3f}, grad {ratios[2]:.3f} "
              f"({'ok' if ok else 'MISMATCH'})")
        if not ok:
            raise SystemExit(f"{name} kernels disagree with their plain "
                             f"versions")
        if not rehearsal:
            out[name] = flash_timing(torch, fl, f"{name} {list(shape)}",
                                     shape, dt, mode, inputs, flush)
            for kname, e in errs.items():
                out[name][kname]["max_abs_err"] = e
        del inputs
    return out


def seqpar_phase(torch, device, rehearsal):
    """Phase 10.  (a) GPT-2 small over 8192 tokens with
    ``seq_parallel='ring'`` in the world of one: its f32 logits against
    plain flash attention, then 2 bf16 steps, the main path (one CAUSAL
    hop a layer on the 3xTF32 route, forward and backward); (b) the
    ring's own hop code over 4 virtual shards (``virtual_ring_check``);
    (c) 2 bf16 steps with ``seq_parallel='ulysses'``, the main path of
    the bf16 kernels at Ulysses' shape.  Then each kernel at each shape
    these paths give it, held against its plain version and timed:
    (a)'s hop [1, 8192, 12, 64] f32 causal, the hops of 2 and 4 cards
    ([1, 4096 | 2048, 12, 64] f32) in modes NONE, CAUSAL and STRICT,
    (c)'s [1, 8192, 12, 64] bf16 causal and a 2- and 4-card rank's heads
    ([1, 8192, 6 | 3, 64]).  Returns the launches of (a), (b) and (c)
    and the records."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import flash as fl
    hvd.init(device="cpu" if rehearsal else None)
    try:
        logits_err = ring_logits_check(torch, device, rehearsal)
        ring_launches, ring_by_mode = seqpar_steps(torch, fl, device,
                                                   rehearsal, "ring")
        virtual = virtual_ring_check(torch, fl, device, rehearsal)
        uly_launches, _ = seqpar_steps(torch, fl, device, rehearsal,
                                       "ulysses")
    finally:
        hvd.shutdown()
    f32, bf16 = torch.float32, torch.bfloat16
    modes = (fl.MASK_NONE, fl.MASK_CAUSAL, fl.MASK_STRICT)
    if rehearsal:
        hops = {"n=1": (1, 64, 4, 16), "2 cards": (1, 32, 4, 16),
                "4 cards": (1, 16, 4, 16)}
        ulys = {"n=1": (1, 64, 4, 16), "2 cards": (1, 64, 2, 16),
                "4 cards": (1, 64, 1, 16)}
    else:
        hops = {"n=1": (1, 8192, 12, 64), "2 cards": (1, 4096, 12, 64),
                "4 cards": (1, 2048, 12, 64)}
        ulys = {"n=1": (1, 8192, 12, 64), "2 cards": (1, 8192, 6, 64),
                "4 cards": (1, 8192, 3, 64)}
    cases = [("ring hop n=1", hops["n=1"], f32, fl.MASK_CAUSAL)]
    cases += [(f"ring hop {cards} {fl.MODE_NAMES[m]}", hops[cards], f32, m)
              for cards in ("2 cards", "4 cards") for m in modes]
    cases += [(f"ulysses {cards}", ulys[cards], bf16, fl.MASK_CAUSAL)
              for cards in ("n=1", "2 cards", "4 cards")]
    flush = None if rehearsal else torch.empty(64 * 2**20, device=device)
    rng = np.random.RandomState(9)
    records = kernel_cases(torch, fl, device, rehearsal, rng, cases, flush)
    del flush
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"logits_err": logits_err, "ring_launches": ring_launches,
            "ring_by_mode": _by_mode(fl, ring_by_mode, "tf32x3"),
            "virtual_launches": virtual, "ulysses_launches": uly_launches,
            "hop_shapes": hops, "ulysses_shapes": ulys, "records": records}


# ---------------------------------------------------------------------------
# Phase 11: model parallelism in a world of one
# ---------------------------------------------------------------------------

MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2, expert_axis="ep")


def _moe_gpt2(torch, device, rehearsal, dtype, attention_impl, seed,
              **overrides):
    """MoE GPT-2 small (8 experts, top 2, every 2nd block) with its
    experts on the ``ep`` axis; tiny in the rehearsal."""
    from horovod_tpu_torch.models import create_gpt2
    kw = dict(MOE, **overrides)
    if rehearsal:
        kw.update(num_layers=2, num_heads=2, d_model=32, d_ff=64,
                  vocab_size=97, max_len=64)
    return create_gpt2("small", device=device, seed=seed, dtype=dtype,
                       attention_impl=attention_impl, **kw)


def moe_dispatch_check(torch, device, rehearsal):
    """Phase 11 (a), first: ``expert_parallel_ffn`` at the MoE block's
    full width (x [4096, 768], d_ff 3072, 8 experts, top 2, capacity
    factor 1.25: C = 1280; ``axis_name=None``, E_local = 8), f32, against
    JAX's formula with the materialised [T, E, C] dispatch and combine
    (``moe._dispatch_combine`` and its einsums) on the same device and
    inputs, at the JAX MoE tolerance 1e-4 / 1e-5: the output, the aux
    loss and the dropped share.  The tokens share a random mean
    direction, as hidden states do, which skews the router; on the card
    claims must be dropped, so the capacity path runs.  Both sides take
    their router logits from the same product on the same device, so
    they route alike.  Returns (max abs err, dropped share)."""
    from horovod_tpu_torch.parallel import moe
    T, d, f, E = (64, 32, 64, 8) if rehearsal else (4096, 768, 3072, 8)
    k, cf = 2, 1.25
    rng = np.random.RandomState(14)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    x = t(rng.randn(T, d) + 0.3 * rng.randn(d))
    gate, w_in, w_out = (t(rng.randn(*shape) * 0.02) for shape in
                         ((d, E), (E, d, f), (E, f, d)))
    with torch.no_grad():
        got = moe.expert_parallel_ffn(x, gate, w_in, w_out, axis_name=None,
                                      top_k=k, capacity_factor=cf)
        C = max(1, int(cf * k * T / E))
        idx, wts, probs = moe._top_k_gating(x.float() @ gate.float(), k)
        dispatch, combine, dropped = moe._dispatch_combine(idx, wts, probs,
                                                           E, C)
        h = torch.bmm(moe.gelu(torch.bmm(
            torch.einsum("tec,td->ecd", dispatch, x), w_in)), w_out)
        want = torch.einsum("tec,ecd->td", combine, h)
        aux = moe.switch_aux_loss(probs, dispatch)
        del dispatch, combine, h
    err = float((got.out - want).abs().max())
    ratio = max(float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
                for a, b in ((got.out, want), (got.aux_loss, aux)))
    drop = float(got.dropped_frac)
    log(f"  moe ffn top 2 at [{T}, {d}], E {E}, C {C}, f32, index dispatch "
        f"against the materialised one: max abs err {err:.3e}, err/tol "
        f"{ratio:.4f} at 1e-4 / 1e-5, dropped {drop:.4f} (reference "
        f"{float(dropped):.4f})")
    if not (ratio <= 1.0 and drop == float(dropped)
            and (rehearsal or drop > 0.0)):
        raise SystemExit("MoE ffn: the index dispatch disagrees with the "
                         "materialised one")
    return err, drop


def moe_path(torch, fl, device, rehearsal):
    """Phase 11 (a): MoE GPT-2 small at full width in the world of one
    (E_local = 8 on a dp 1 × ep 1 mesh; with one member the MoE layer
    skips both alltoalls, so no exchange runs on the card here: that is
    ``model_parallel_bench``'s).  First ``moe_dispatch_check``.  Then the
    model's f32 logits against the same weights with dense attention at
    2e-3, every token routed to all 8 experts: a top-2 router's choice
    is discontinuous, and flash and dense attention differ by enough
    (~1e-6) to flip a few of its 24576 choices and, through attention,
    the tokens after them; with every expert chosen and capacity for
    all, the layer is continuous.  Then 2 bf16 AdamW steps through
    ``DistributedOptimizer(reduce_axes=("dp", "ep"))`` on [4, 1024]
    tokens, every count set to 0 just before them.  Returns the flash
    launches of the two steps and numbers to print."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import lm_loss
    from horovod_tpu_torch.parallel import make_mesh
    make_mesh({"dp": 1, "ep": 1})
    ffn_err, ffn_dropped = moe_dispatch_check(torch, device, rehearsal)
    B, S = (2, 64) if rehearsal else (4, 1024)
    toks = torch.as_tensor(np.random.RandomState(12).randint(
        0, 97 if rehearsal else 50257, (B, S + 1)), device=device)
    x, y = toks[:, :-1], toks[:, 1:]
    logits = []
    with torch.no_grad():
        for impl in ("flash", None):
            m = _moe_gpt2(torch, device, rehearsal, torch.float32, impl, 13,
                          moe_top_k=8)
            logits.append(m(x))
            del m
    a, b = logits
    err = float((a - b).abs().max())
    ratio = float(((a - b).abs() / (2e-3 + 2e-3 * b.abs())).max())
    log(f"  moe gpt2-small f32 logits (top 8), flash against dense "
        f"attention, [{B}, {S}]: max abs err {err:.3e}, err/tol "
        f"{ratio:.4f} at 2e-3")
    del logits, a, b
    if not ratio <= 1.0:
        raise SystemExit("MoE logits: flash disagrees with dense attention")
    model = _moe_gpt2(torch, device, rehearsal,
                      torch.float32 if rehearsal else torch.bfloat16,
                      "flash", 13)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4),
        reduce_axes=("dp", "ep"))
    for counts in (fl.LAUNCHES, fl.LAUNCHES_BY_MODE):
        for name in counts:
            counts[name] = 0
    losses, t0 = [], time.monotonic()
    for _ in range(2):
        opt.zero_grad()
        loss = lm_loss(model(x), y) + 0.01 * sum(model.aux_losses)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    launches = dict(fl.LAUNCHES)
    by_mode = _by_mode(fl, dict(fl.LAUNCHES_BY_MODE), "wgmma")
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    dropped = [round(float(f), 4) for f in model.dropped_fracs]
    aux = float(sum(model.aux_losses).detach())
    L = model.cfg.num_layers
    log(f"  moe gpt2-small {str(model.cfg.dtype)[6:]}, 2 AdamW steps on "
        f"[{B}, {S}]: losses "
        f"{[round(v, 4) for v in losses]}, aux {aux:.4f}, dropped "
        f"{dropped} ({len(dropped)} MoE blocks), {seconds:.2f} s, flash "
        f"launches {({k: v for k, v in launches.items() if v})}")
    ok = all(np.isfinite(losses)) and len(dropped) == L // 2
    if not rehearsal:
        ok = ok and all(launches[f"{k}_wgmma"] == 2 * L
                        and by_mode[k]["causal"] == 2 * L
                        and launches[f"{k}_tf32x3"] == 0 for k in KERNELS)
    if not ok:
        raise SystemExit("MoE GPT-2 steps failed")
    del model, opt
    return launches, {"ffn_err": ffn_err, "ffn_dropped_frac": ffn_dropped,
                      "logits_err": err, "losses": losses, "aux": aux,
                      "dropped_frac": dropped, "steps_s": seconds}


def model_parallel_phase(torch, device, rehearsal):
    """Phase 11.  (a) ``moe_path``; (b) ``entry.dryrun_moe_step``,
    ``dryrun_pp_step`` and ``dryrun_tp_step`` (phases 3-5 of
    ``dryrun_multichip``) on the card.  Returns (a)'s launches and the
    numbers."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import entry
    from horovod_tpu_torch.parallel import flash as fl
    dev = "cpu" if rehearsal else None
    hvd.init(device=dev)
    try:
        launches, numbers = moe_path(torch, fl, device, rehearsal)
        losses = {"moe": entry.dryrun_moe_step(device=dev)[0],
                  "pp": entry.dryrun_pp_step(device=dev)[0],
                  "tp": entry.dryrun_tp_step(device=dev)[0]}
    finally:
        hvd.shutdown()
    log(f"  dry-run steps (phases 3-5 of dryrun_multichip): losses "
        f"{ {k: round(v, 4) for k, v in losses.items()} }")
    if not all(np.isfinite(list(losses.values()))):
        raise SystemExit("dry-run steps failed")
    numbers["dryrun_losses"] = losses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches, numbers


# ---------------------------------------------------------------------------
# Phase 12: elastic kill-and-rejoin in a world of one
# ---------------------------------------------------------------------------

def _startup(events):
    """Seconds from each incarnation's process start to its world, its
    model and its first step."""
    out = []
    for start in (e for e in events if e["event"] == "start"):
        later = [e for e in events if e["wall"] >= start["at"]
                 and e["world_version"] == start["world_version"]]

        def first(name):
            got = [e["wall"] for e in later if e["event"] == name]
            return round(min(got) - start["at"], 3) if got else None
        out.append({"world_version": start["world_version"],
                    "to_start": round(start["wall"] - start["at"], 3),
                    "to_init": first("init"), "to_built": first("built"),
                    "to_entry": first("entry"), "to_first_step":
                    first("step")})
    return out


def launch_in_process(argv, env):
    """``horovod_tpu_torch.runner.launch`` with ``argv`` in this process,
    ``env`` added to what the workers inherit; a CompletedProcess."""
    import os
    from horovod_tpu_torch.runner import launch
    saved = {k: os.environ.get(k) for k in list(env) + ["HVD_TPU_COORD_PORT"]}
    os.environ.update(env)
    try:
        rc = launch._run(launch.parse_args(argv))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return subprocess.CompletedProcess(argv, rc, "", "")


def elastic_phase(torch, device, rehearsal):
    """Phase 12.  The port's launcher runs ``examples/elastic_resnet``
    with ``--min-np 1 --max-np 1`` and a discovery script: ResNet-50 at
    224², 32 images a step, bf16, sync BN, SGD with momentum, under
    ``TorchState`` with a spill directory, committing every 2 steps; the
    worker ``os._exit(1)``s after step 5 of its first incarnation, the
    driver respawns it, and it resumes from the spill at step 4 and runs
    to step 8.  Beside it the same 8 steps uninterrupted, trained while
    the respawn starts up (with the ``save_model`` / ``load_model``
    round trip, mid-cycle at ``backward_passes_per_step=2``).  Both runs are deterministic
    (``torch.use_deterministic_algorithms``, the stem whose pool backward
    is deterministic); the final parameters and buffers must be equal bit
    for bit.  Returns the numbers."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="hvd_elastic_phase_")
    disc = os.path.join(work, "discover.sh")
    with open(disc, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(disc, 0o755)
    batch = 4 if rehearsal else 32
    common = ["--deterministic", "--fast-stem", "--commit-every", "2",
              "--steps", "8", "--epochs", "1",
              "--dataset-size", str(8 * batch)]
    common += ["--device", "cpu", "--small"] if rehearsal else \
        ["--image-size", "224", "--batch-size", str(batch)]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop("HVD_TPU_ELASTIC_SPILL_DIR", None)
    ev1, ev2 = os.path.join(work, "elastic.jsonl"), \
        os.path.join(work, "reference.jsonl")
    example = [sys.executable, "-m",
               "horovod_tpu_torch.examples.elastic_resnet"]
    spill = os.path.join(work, "spill")
    t0 = time.monotonic()
    # The uninterrupted run starts up beside the elastic one, which
    # trains once the reference has built its model (the ready file), so
    # the steps read as "before" have the card to themselves.  The
    # reference trains once the elastic worker has died (its marker in
    # the spill directory), while the respawn starts up: the two never
    # step at once, and the phase pays for one process start fewer.
    ready = os.path.join(work, "reference.ready")
    ref = subprocess.Popen(
        example + common + [
            "--events", ev2, "--roundtrip", os.path.join(work, "rt"),
            "--ready-file", ready,
            "--start-after", os.path.join(spill, "died"),
            "--save-params", os.path.join(work, "reference.pt")],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def release_if_reference_died():
        # A reference that dies before it is ready must not leave the
        # elastic worker waiting: the phase then fails on its exit code.
        while not os.path.exists(ready) and ref.poll() is None:
            time.sleep(0.2)
        if not os.path.exists(ready):
            open(ready, "w").close()
    threading.Thread(target=release_if_reference_died, daemon=True).start()
    try:
        # The port's launcher, in this process (it would import torch
        # again as a process of its own): its elastic driver spawns and
        # respawns the worker.
        run1 = launch_in_process(
            ["--min-np", "1", "--max-np", "1", "--host-discovery-script",
             disc] + example + common + [
                "--events", ev1, "--spill-dir", spill, "--die-after", "5",
                "--start-after", ready,
                "--save-params", os.path.join(work, "elastic.pt")],
            {k: env[k] for k in ("PYTHONPATH", "CUBLAS_WORKSPACE_CONFIG")})
        t1 = time.monotonic()
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    t2 = time.monotonic()
    run2 = subprocess.CompletedProcess(ref.args, ref.returncode, out, err)
    for name, run in (("elastic", run1), ("reference", run2)):
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"phase 12: the {name} run failed "
                             f"(rc {run.returncode})")
    a = torch.load(os.path.join(work, "elastic.pt"))
    b = torch.load(os.path.join(work, "reference.pt"))
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].float() - b[k].float()).abs().max())
                 for k in differ), default=0.0)
    from horovod_tpu_torch.examples.elastic_resnet import (read_events,
                                                           step_rate)
    e1, e2 = read_events(ev1), read_events(ev2)
    kill = [e for e in e1 if e["event"] == "kill"]
    resumed = [e for e in e1 if e["event"] == "resumed"]
    steps = [e for e in e1 if e["event"] == "step"]
    first_inc = [e for e in steps if e["world_version"] == 1]
    second = [e for e in steps if e["world_version"] > 1]
    commits = [e for e in e1 if e["event"] == "commit"]
    roundtrip = [e for e in e2 if e["event"] == "roundtrip"]
    ref_built = [e["wall"] for e in e2 if e["event"] == "built"]
    nondet = sorted({e["warning"] for e in e1 + e2
                     if e["event"] == "nondeterministic"})
    ok = (not differ and len(kill) == 1 and resumed
          and resumed[0]["step"] == 4 and second
          and second[0]["step"] == 5 and second[-1]["step"] == 8
          and roundtrip and roundtrip[0]["equal"])
    numbers = {
        "kill_to_first_step_s": second[0]["wall"] - kill[0]["wall"]
        if kill and second else None,
        "steps_redone": kill[0]["step"] - resumed[0]["step"]
        if kill and resumed else None,
        "commit_ms_with_spill": [round(c["commit_ms"], 3) for c in commits],
        "commit_ms_without_spill": [round(c["save_ms"], 3)
                                    for c in commits],
        "restore_ms": resumed[0]["restore_ms"] if resumed else None,
        # Each step's own time, the first of each incarnation left out.
        "images_per_s_before": step_rate(first_inc[1:], batch),
        "images_per_s_after": step_rate(second[1:], batch),
        # Whether the reference ran beside either side of the comparison:
        # built before the first incarnation's first step, and done
        # (its last event) before the respawn's first step ended.
        "reference_built_before_steps": bool(
            ref_built and first_inc and ref_built[0] < first_inc[0]["wall"]),
        "reference_done_before_respawn_steps": bool(
            e2 and second and max(e["wall"] for e in e2)
            < second[0]["wall"]),
        "params_equal_bitwise": not differ,
        "params_differing": len(differ), "max_abs_diff": worst,
        "roundtrip_equal_bitwise": bool(roundtrip and roundtrip[0]["equal"]),
        "nondeterministic_ops": nondet,
        "elastic_run_s": t1 - t0, "both_runs_s": t2 - t0,
        "startup_s": _startup(e1), "reference_startup_s": _startup(e2),
    }
    log(f"  elastic run {t1 - t0:.1f} s, both runs {t2 - t0:.1f} s; "
        f"kill to first step {numbers['kill_to_first_step_s']}; params "
        f"equal {not differ} ({len(differ)} differ, max {worst:.3e}); "
        f"round trip {numbers['roundtrip_equal_bitwise']}")
    if not ok:
        raise SystemExit(f"phase 12 failed: {json.dumps(numbers)}")
    return numbers


# ---------------------------------------------------------------------------
# Phase 13: the serving request surface
# ---------------------------------------------------------------------------

# The schema phase 13 decodes under: a document that always completes (a
# boolean and an enum), so every greedy and sampled answer must parse.
SURFACE_SCHEMA = {"type": "object",
                  "properties": {"ok": {"type": "boolean"},
                                 "tag": {"enum": ["red", "green", "blue"]}},
                  "required": ["ok", "tag"], "additionalProperties": False}


def sse_post(port, body):
    """POST /generate as a stream; returns (events, seconds to the first
    token event, total seconds), both on the client's clock."""
    import http.client
    from horovod_tpu_torch.serve.streaming import parse_sse
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    try:
        conn.request("POST", "/generate", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SystemExit(f"stream answered {resp.status}: "
                             f"{resp.read()[:300]!r}")
        raw, events, first = b"", [], None
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            raw += chunk
            cut = raw.rfind(b"\n\n")
            events = parse_sse(raw[:cut + 2]) if cut >= 0 else []
            if first is None and any(e[0] == "token" for e in events):
                first = time.monotonic() - t0
            if events and events[-1][0] in ("done", "error"):
                break
        return events, first, time.monotonic() - t0
    finally:
        conn.close()


def http_status(port, path, body):
    """POST ``body``; returns (status, parsed JSON body) on any status."""
    import urllib.error
    try:
        return 200, http_json(port, path, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def surface_checkpoint(torch, device, rehearsal, cfg, model, tmp):
    """``checkpoint.save_model`` of the serving model, then the CLI's
    factory with ``--checkpoint``: its adapter's ``prompt_logits`` must
    equal the in-memory model's bit for bit.  Returns the factory."""
    import argparse
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, models
    from horovod_tpu_torch.serve import TransformerAdapter
    from horovod_tpu_torch.serve import server as srv
    hvd.init(device="cpu" if rehearsal else None)
    try:
        t0 = time.monotonic()
        checkpoint.save_model(tmp, model)
        save_s = time.monotonic() - t0
    finally:
        hvd.shutdown()   # the replicas serve without a world
    saved = models.GPT2_SMALL
    if rehearsal:
        models.GPT2_SMALL = cfg   # the factory's gpt2-small, cut to size
    try:
        t0 = time.monotonic()
        factory = srv._build_adapter_factory(argparse.Namespace(
            model="gpt2-small", checkpoint=tmp, device=str(device),
            seed=0, max_len=cfg.max_len))
        ad = factory()
        load_s = time.monotonic() - t0
    finally:
        models.GPT2_SMALL = saved
    prompt = [i % cfg.vocab_size for i in range(1, 1 + min(64,
                                                          cfg.max_len))]
    got = ad.prompt_logits(prompt)
    want = TransformerAdapter(cfg, model, device=device).prompt_logits(prompt)
    log(f"  checkpoint: save_model {save_s:.2f} s, the CLI factory's load "
        f"{load_s:.2f} s; prompt_logits "
        f"{'equal bit for bit' if np.array_equal(got, want) else 'DIFFER'}")
    if not np.array_equal(got, want):
        raise SystemExit("--checkpoint serves other weights")
    return factory, {"save_s": round(save_s, 3), "load_s": round(load_s, 3)}


def surface_warmup(torch, factory, prompt, failures):
    """The first request's TTFT of a fresh engine started cold (warmup
    off) and of one started warm, in this process; the warm engine must
    have warmed once (a warmup that failed serves cold and reads 0 ms),
    the cold one never.  Returns the numbers."""
    from horovod_tpu_torch.serve import InferenceEngine, Request
    out = {}
    for warm in (False, True):
        eng = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                              warmup=warm, replica_id=f"warmup-{warm}")
        t0 = time.monotonic()
        eng.start()
        start_s = time.monotonic() - t0
        try:
            r = Request(prompt, max_new_tokens=4)
            eng.batcher.submit(r)
            r.result(timeout=600)
            ttft = (r.first_token_at - r.submitted_at) * 1e3
        finally:
            eng.stop()
        key = "warm" if warm else "cold"
        out[key] = {"first_ttft_ms": round(ttft, 3),
                    "start_ms": round(start_s * 1e3, 3)}
        runs = (eng.warmup_runs, eng.last_warmup_ms)
        if (warm and (runs[0] != 1 or runs[1] <= 0)) or \
                (not warm and runs[0] != 0):
            failures.append(f"{key} engine: warmup runs {runs[0]}, last "
                            f"{runs[1]:.3f} ms")
        if warm:
            out[key]["warmup_ms"] = round(eng.last_warmup_ms, 3)
    log(f"  first request's TTFT: cold {out['cold']['first_ttft_ms']:.1f} "
        f"ms, warm {out['warm']['first_ttft_ms']:.1f} ms (warmup "
        f"{out['warm']['warmup_ms']:.1f} ms); both engines fresh, in a "
        f"process whose earlier phases already loaded the kernels")
    return out


def surface_logprobs(torch, port, plain, prompt, max_new, failures):
    """Greedy and sampled requests with ``logprobs: 5``: each chosen
    token's logprob against log_softmax of the plain route's logits of
    that row (``score_logits`` of prompt + answer, 1e-4), and the tokens
    of each against the same request without logprobs (the host-mode
    draw is the fused step's, so a seeded answer does not change)."""
    worst = 0.0
    for extra in ({}, dict(SAMPLING, seed=7)):
        body = dict({"tokens": prompt, "max_new_tokens": max_new},
                    **extra)
        got = http_json(port, "/generate", dict(body, logprobs=5))
        toks, entries = got["tokens"], got["logprobs"]
        rows = plain.score_logits(prompt + toks[:-1]).astype(np.float64)
        rows = rows[len(prompt) - 1:]
        lse = rows.max(-1) + np.log(np.exp(
            rows - rows.max(-1, keepdims=True)).sum(-1))
        want = rows[np.arange(len(toks)), toks] - lse
        lps = np.array([e["logprob"] for e in entries])
        err = float(np.abs(lps - want).max())
        worst = max(worst, err)
        if [e["token"] for e in entries] != toks or err > 1e-4 or \
                any(len(e["top"]) != 5 for e in entries):
            failures.append(f"logprobs {extra or 'greedy'}: max error "
                            f"{err:.3g} (limit 1e-4)")
        if http_json(port, "/generate", body)["tokens"] != toks:
            failures.append(f"{'sampled' if extra else 'greedy'} tokens "
                            f"change when logprobs are asked")
    log(f"  logprobs: greedy and sampled, logprob - log_softmax(plain "
        f"route) max |err| {worst:.3g} (limit 1e-4)")
    return worst


def surface_score(torch, port, kernel_ad, plain, n, rng, failures):
    """``/score`` over ``n`` tokens against ``score_logits`` of the plain
    route (2e-4 / 2e-5); returns the numbers."""
    toks = rng.randint(0, kernel_ad.vocab_size, (n,)).tolist()
    t0 = time.monotonic()
    body = http_json(port, "/score", {"tokens": toks, "top_logprobs": 5})
    http_ms = (time.monotonic() - t0) * 1e3
    want = plain.score_logits(toks)
    t0 = time.monotonic()
    got = kernel_ad.score_logits(toks)
    direct_ms = (time.monotonic() - t0) * 1e3
    err = float(np.abs(got - want).max())
    w64 = want.astype(np.float64)
    lse = w64.max(-1) + np.log(np.exp(
        w64 - w64.max(-1, keepdims=True)).sum(-1))
    lp_want = w64[np.arange(n - 1), toks[1:]] - lse[:-1]
    lp_got = np.array([e["logprob"] for e in body["logprobs"][1:]])
    if body["logprobs"][0] is not None or len(lp_got) != n - 1 or \
            not np.allclose(got, want, rtol=RTOL, atol=ATOL) or \
            not np.allclose(lp_got, lp_want, rtol=RTOL, atol=ATOL):
        failures.append(f"/score over {n} tokens disagrees with the plain "
                        f"route (logits max |err| {err:.3g})")
    log(f"  /score over {n} tokens: {http_ms:.1f} ms over HTTP, "
        f"score_logits {direct_ms:.1f} ms; logits max |err| {err:.3g} "
        f"against the plain route")
    return {"tokens": n, "http_ms": round(http_ms, 3),
            "score_logits_ms": round(direct_ms, 3), "max_abs_err": err}


def surface_stream(port, prompt, max_new, failures):
    """``stream: true`` against the buffered answer of the same request:
    the same tokens in order, no duplicate; the first SSE token's time
    beside the buffered TTFT."""
    body = {"tokens": prompt, "max_new_tokens": max_new}
    t0 = time.monotonic()
    buffered = http_json(port, "/generate", body)
    buffered_s = time.monotonic() - t0
    events, first_s, total_s = sse_post(port, dict(body, stream=True))
    toks = [t for e in events if e[0] == "token" for t in e[1]["tokens"]]
    done = events[-1][1] if events and events[-1][0] == "done" else None
    if done is None or toks != buffered["tokens"] or \
            done["stream"]["duplicates"] != 0 or \
            done["stream"]["published"] != len(toks):
        failures.append("the stream's tokens differ from the buffered "
                        "answer's")
    out = {"first_sse_token_ms": round(first_s * 1e3, 3),
           "stream_total_ms": round(total_s * 1e3, 3),
           "stream_server_ttft_ms": done and done["ttft_ms"],
           "buffered_ttft_ms": buffered["ttft_ms"],
           "buffered_total_ms": round(buffered_s * 1e3, 3),
           "token_events": sum(1 for e in events if e[0] == "token")}
    log(f"  stream: first SSE token {out['first_sse_token_ms']:.1f} ms "
        f"(client clock; server TTFT {out['stream_server_ttft_ms']} ms), "
        f"buffered TTFT {out['buffered_ttft_ms']} ms and answer "
        f"{out['buffered_total_ms']:.1f} ms; {len(toks)} tokens in "
        f"{out['token_events']} events")
    return out


def surface_schema(torch, device, rehearsal, port, seed, failures):
    """Grammar-constrained decoding on a model of GPT-2 small's widths
    and a byte vocabulary (256): every greedy and sampled document
    parses and ``matches``; a ``schema`` request to gpt2-small (no token
    strings) gets the JAX server's answers (400 streamed, 500 buffered)."""
    from horovod_tpu_torch.models import TransformerConfig, create_gpt2
    from horovod_tpu_torch.models.transformer import Transformer, init_gpt2_
    from horovod_tpu_torch.serve import (InferenceEngine, Request,
                                         TransformerAdapter)
    from horovod_tpu_torch.serve.structured import TokenGrammar
    if rehearsal:
        cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                                d_model=32, d_ff=64, max_len=128,
                                dtype=torch.float32)
        model = init_gpt2_(Transformer(cfg, device=device),
                           torch.Generator(device=device).manual_seed(seed))
    else:
        model = create_gpt2("small", device=device, seed=seed,
                            vocab_size=256, dtype=torch.float32)
        cfg = model.cfg
    eng = InferenceEngine(TransformerAdapter(cfg, model, device=device),
                          max_batch=8, prefill_chunk=64,
                          replica_id="schema").start()
    grammar = TokenGrammar(SURFACE_SCHEMA, [chr(i) for i in range(256)],
                           eos_id=0)
    docs = []
    try:
        reqs = [Request([ord(c) for c in "Answer in JSON: "],
                        max_new_tokens=48, eos_id=0, schema=SURFACE_SCHEMA,
                        **({} if i == 0 else dict(SAMPLING, seed=seed + i)))
                for i in range(5)]
        for r in reqs:
            eng.batcher.submit(r)
        for r in reqs:
            toks = r.result(timeout=600)
            body = toks[:-1] if toks and toks[-1] == 0 else toks
            text = bytes(body).decode("latin-1")
            try:
                doc = json.loads(text)
            except ValueError:
                doc = None
            if doc is None or not grammar.matches(body) or \
                    r.finish_reason not in ("grammar", "stop"):
                failures.append(f"schema answer {text!r} "
                                f"({r.finish_reason}) does not conform")
            docs.append(text)
    finally:
        eng.stop()
    codes = {}
    for stream in (True, False):
        code, body = http_status(port, "/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 4, "eos_id": 0,
            "schema": SURFACE_SCHEMA, "stream": stream})
        codes["stream" if stream else "buffered"] = code
        if "token strings" not in body.get("error", ""):
            failures.append(f"gpt2-small schema answer: {body}")
    if codes != {"stream": 400, "buffered": 500}:
        failures.append(f"gpt2-small schema statuses {codes}, the JAX "
                        f"server's are 400 streamed and 500 buffered")
    log(f"  schema on a GPT-2-small-width model with vocab 256: "
        f"{docs[0]!r} greedy, {len(docs) - 1} sampled documents all "
        f"conform; gpt2-small's schema request answered {codes}")
    return {"documents": docs, "gpt2_small_statuses": codes}


def query_delta(torch, rng, cfg, scale=0.1):
    """A rank-8 delta on every block's query projection: A [d, 8] and
    B [8, 3, H, Dh] with the key and value parts of B zero."""
    H, Dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    delta = {}
    for i in range(cfg.num_layers):
        b = np.zeros((8, 3, H, Dh), np.float32)
        b[:, 0] = scale * rng.randn(8, H, Dh)
        delta[f"blocks.{i}.attn.qkv.kernel"] = {
            "a": (scale * rng.randn(cfg.d_model, 8)).astype(np.float32),
            "b": b}
    return delta


def surface_roll(torch, device, port, sched, reg, base, cfg, prompts,
                 max_new, rng, failures):
    """A rank-8 query delta resident beside the default model; its roll
    to version 1 across both replicas while 16 mixed requests are in
    flight: no request fails, swap progress ends at done == total, and
    the variant's answers after it equal the new weights served cold."""
    from horovod_tpu_torch.serve import (InferenceEngine, TransformerAdapter,
                                         apply_delta)
    reg.register("tuned", delta=query_delta(torch, rng, cfg))
    before = [http_json(port, "/generate", {
        "tokens": p, "max_new_tokens": max_new, "model": "tuned"})["tokens"]
        for p in prompts[:2]]
    delta2 = query_delta(torch, rng, cfg)
    warmed = {r.replica_id: r.engine.warmup_runs for r in sched.fleet()}
    results = [None] * 16

    def post(i):
        body = {"tokens": prompts[i % len(prompts)],
                "max_new_tokens": max_new}
        if i % 2:
            body["model"] = "tuned"
        if i % 4 == 3:
            body.update(SAMPLING, seed=i)
        try:
            if i % 8 == 5:
                events, _, _ = sse_post(port, dict(body, stream=True))
                results[i] = 200 if events[-1][0] == "done" else 500
            else:
                results[i] = http_status(port, "/generate", body)[0]
        except BaseException as e:  # noqa: BLE001 - counted as failed
            results[i] = repr(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    moved = reg.roll("tuned", delta=delta2)
    roll_s = time.monotonic() - t0
    for t in threads:
        t.join(timeout=600)
    failed = [r for r in results if r != 200]
    swap = sched.metrics.snapshot()["swap"]["tuned"]
    after = [http_json(port, "/generate", {
        "tokens": p, "max_new_tokens": max_new, "model": "tuned"})["tokens"]
        for p in prompts[:2]]
    cold = InferenceEngine(
        TransformerAdapter(cfg, apply_delta(base, delta2), device=device),
        max_batch=8, prefill_chunk=64, replica_id="cold").start()
    try:
        want = [cold.generate(p, max_new_tokens=max_new)
                for p in prompts[:2]]
    finally:
        cold.stop()
    if failed:
        failures.append(f"{len(failed)} of 16 requests failed across the "
                        f"roll: {failed}")
    if swap != {"done": 2, "total": 2} or moved != 2:
        failures.append(f"roll moved {moved}, swap progress {swap}")
    if after != want:
        failures.append("after the roll the variant's answers differ from "
                        "the new weights served cold")
    rewarmed = {r.replica_id: r.engine.warmup_runs for r in sched.fleet()}
    if any(rewarmed[k] <= v for k, v in warmed.items()):
        failures.append(f"the roll's mark_alive did not warm every replica: "
                        f"warmup runs {warmed} before, {rewarmed} after")
    log(f"  roll of the rank-8 delta to version 1: {roll_s:.2f} s over "
        f"{moved} replicas ({roll_s / max(moved, 1):.2f} s each, warmup "
        f"included), 16 mixed requests in flight, {len(failed)} failed; "
        f"swap progress {swap}; answers {'changed' if after != before else 'unchanged'} "
        f"by the roll and equal the new weights served cold")
    return {"roll_s": round(roll_s, 3), "replicas": moved,
            "roll_s_per_replica": round(roll_s / max(moved, 1), 3),
            "in_flight": 16, "failed": len(failed), "swap_progress": swap,
            "warmup_runs": {"before": warmed, "after": rewarmed}}


def host_mode_step_timing(torch, device, ad, rng, iters=20):
    """A B = 8 decode step at contexts of 256 tokens: the fused greedy
    step (argmax on the card), the step with the [8, V] logits to the
    host (``decode_paged_logits``), and the engine's host-mode step: the
    logits kept on the card, one sampled draw of the 8 rows there, the
    rows to the host for their 8 logprob entries (top 5); host clock
    around synchronized calls, in turns."""
    from horovod_tpu_torch.serve import InferenceEngine
    from horovod_tpu_torch.serve import sampling as sm
    B, ctx = 8, 256
    prompts = [rng.randint(0, ad.vocab_size, (ctx,)).tolist()
               for _ in range(B)]
    MB = ad.max_blocks_per_seq
    need = -(-(ctx + 1) // ad.block_tokens)
    tables = [list(range(b * need, (b + 1) * need)) for b in range(B)]
    pool = ad.init_paged_cache(B * need, B)
    pool, _ = ad.prefill_chunk(pool, prompts, [0] * B, tables)
    tab = np.array([t + [B * need] * (MB - need) for t in tables])
    tokens = rng.randint(0, ad.vocab_size, (B,))
    positions = np.full((B,), ctx)
    packed = sm.pack_params(
        sm.base_keys_array([sm.seq_key(5)] * B, B), positions + 1,
        np.full((B,), 0.8, np.float32), np.full((B,), 40),
        np.full((B,), 0.95, np.float32))

    def fused():
        ad.decode_paged(pool, tokens, positions, tab)

    def host():
        ad.decode_paged_logits(pool, tokens, positions, tab)

    def host_rows():
        ops = torch.as_tensor(packed, device=ad.device)
        _, logits = ad.decode_paged_logits(pool, tokens, positions, tab,
                                           on_device=True)
        nxt = sm.sample_batched(logits, ops).cpu().numpy()
        rows = logits.cpu().numpy()
        for b in range(B):
            InferenceEngine._logprob_entry(rows[b], int(nxt[b]), 5)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / iters

    order = [("fused", fused), ("host", host), ("host_rows", host_rows)]
    runs = {name: [] for name, _ in order}
    for seq in (order, order[::-1]):
        for name, fn in seq:
            runs[name].append(round(ms(fn), 3))
    log(f"  B = 8 decode step at 256 tokens of context (ms, two turns): "
        f"fused greedy {runs['fused']}, logits to the host {runs['host']}, "
        f"host-mode (draws on the card, 8 logprob entries) "
        f"{runs['host_rows']}")
    return runs


def surface_phase(torch, device, rehearsal, seed):
    """Phase 13: the serving request surface on gpt2-small f32 at full
    width, random weights from ``seed``, served from a checkpoint by the
    CLI's factory, two replicas on the card without process sets.
    Returns the paged routes' launches of the phase's drives (counted
    from 0 after the checkpoint and warm/cold checks) and its numbers."""
    import shutil
    import tempfile
    from horovod_tpu_torch.serve import (ModelRegistry, ServeServer,
                                         TransformerAdapter, build_replicas)
    from horovod_tpu_torch.serve import paged_attention as pa
    cfg, model, prompts, max_new = serving_model(torch, device, rehearsal,
                                                 seed)
    if rehearsal:
        # Past 256 tokens, as GPT-2's: no token strings, no grammars.
        import dataclasses
        from horovod_tpu_torch.models.transformer import (Transformer,
                                                          init_gpt2_)
        cfg = dataclasses.replace(cfg, vocab_size=300)
        model = init_gpt2_(Transformer(cfg, device=device),
                           torch.Generator(device=device).manual_seed(seed))
    rng = np.random.RandomState(seed + 13)
    failures = []
    out = {"card": None if rehearsal else card_tag()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        factory, out["checkpoint"] = surface_checkpoint(
            torch, device, rehearsal, cfg, model, tmp)
        out["warmup"] = surface_warmup(torch, factory, prompts[3],
                                       failures)
        reset_launches(pa)
        sched = build_replicas(factory, num_replicas=2, max_batch=8,
                               prefill_chunk=64, warmup=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    base = model.state_dict()
    reg = ModelRegistry(
        sched, base_params=base,
        adapter_builder=lambda p: TransformerAdapter(cfg, p, device=device))
    server = ServeServer(sched, registry=reg)
    port = server.start(port=0, host="127.0.0.1")
    try:
        reg.adopt("default")
        out["warmup"]["replicas_ms"] = {
            r.replica_id: round(r.engine.last_warmup_ms, 3)
            for r in sched.fleet()}
        cold = [r.replica_id for r in sched.fleet()
                if r.engine.warmup_runs < 1 or r.engine.last_warmup_ms <= 0]
        if cold:
            failures.append(f"replicas {cold} started without a warmup")
        log(f"  warmup per replica (ms): {out['warmup']['replicas_ms']}")
        plain = TransformerAdapter(cfg, model, attn_impl="gather",
                                   device=device)
        kernel_ad = sched.fleet()[0].engine.adapter
        out["logprobs_max_abs_err"] = surface_logprobs(
            torch, port, plain, prompts[2], max_new, failures)
        out["score"] = surface_score(torch, port, kernel_ad, plain,
                                     cfg.max_len, rng, failures)
        out["stream"] = surface_stream(port, prompts[3], max_new, failures)
        out["schema"] = surface_schema(torch, device, rehearsal, port, seed,
                                       failures)
        out["roll"] = surface_roll(torch, device, port, sched, reg, base,
                                   cfg, prompts, max_new, rng, failures)
    finally:
        server.stop()
    launches = {"decode": pa.LAUNCHES["paged_attention_decode"],
                "prefill": pa.LAUNCHES["paged_attention_prefill"]}
    log(f"  launches of the phase's drives: decode route "
        f"{launches['decode']}, prefill route {launches['prefill']}")
    if not rehearsal and min(launches.values()) <= 0:
        failures.append("a paged route was never launched in phase 13")
    if not rehearsal:
        out["decode_step_ms"] = host_mode_step_timing(torch, device,
                                                      kernel_ad, rng)
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("request surface failed")
    out["launches"] = launches
    return launches, out



# -- phase 14: the serving fleet's front door and control plane -------------


def fleet_prompts(rng, cfg, rehearsal):
    """6 sessions of a multi-turn transcript: each session's prompt grows
    append-only over 3 turns from its own 2-block opening (so the
    router's 2-block affinity key stays put); 2 seeded sampled prompts."""
    opening, turn = (8, 4) if rehearsal else (32, 24)
    sessions = []
    for s in range(6):
        base = rng.randint(0, cfg.vocab_size, (opening + 3 * s,)).tolist()
        more = rng.randint(0, cfg.vocab_size, (3 * turn,)).tolist()
        sessions.append([base + more[:k * turn] for k in range(3)])
    sampled = [rng.randint(0, cfg.vocab_size, (opening + 5 * i,)).tolist()
               for i in range(2)]
    return sessions, sampled


def fleet_len(rng, cfg, max_new, lo, hi):
    """A prompt length in [lo, hi), cut to fit the model's context."""
    top = min(hi, cfg.max_len - max_new)
    return int(rng.randint(min(lo, top - 1), top))


def fleet_endpoint(factory, rid, metrics=None, **kw):
    """One serving endpoint of one replica (paged, prefix cache on, BT
    16, chunk 64, 8 slots, warmed at start) behind its own HTTP
    server."""
    from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                         ReplicaScheduler, ServeMetrics,
                                         ServeServer)
    kw.setdefault("max_batch", 8)
    eng = InferenceEngine(factory(), prefill_chunk=64, prefix_cache=True,
                          replica_id=rid, metrics=metrics or ServeMetrics(),
                          warmup=True, **kw)
    srv = ServeServer(ReplicaScheduler([Replica(rid, None, eng)]))
    return srv, srv.start(port=0, host="127.0.0.1")


def reference_answers(ref, bodies):
    """A single engine's answer to each /generate body."""
    from horovod_tpu_torch.serve import Request
    reqs = []
    for b in bodies:
        extra = {k: b[k] for k in ("temperature", "top_k", "top_p", "seed")
                 if k in b}
        reqs.append(Request(b["tokens"], max_new_tokens=b["max_new_tokens"],
                            **extra))
        ref.batcher.submit(reqs[-1])
    return [r.result(timeout=600) for r in reqs]


def route_post(port, body, headers=None):
    """POST /generate over http.client; (status, JSON body, headers)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/generate", json.dumps(body).encode(),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def fleet_front_door(torch, factory, ref, rng, cfg, rehearsal, max_new,
                     failures):
    """(a) Two endpoints behind the port's RouterServer: sessions and
    seeded requests answered as one engine answers them, a stream, the
    affinity hit rate, TTFT through the router against straight to an
    endpoint, and hedging under a 150 ms slow-route stall."""
    from horovod_tpu_torch import faultline as fl
    from horovod_tpu_torch.serve import Router, RouterConfig, RouterServer
    servers = [fleet_endpoint(factory, f"endpoint-{i}") for i in range(2)]
    eps = [f"127.0.0.1:{port}" for _, port in servers]
    router = Router(eps, config=RouterConfig(block_tokens=16))
    rsrv = RouterServer(router)
    rport = rsrv.start(port=0, host="127.0.0.1")
    out = {}
    try:
        sessions, sampled = fleet_prompts(rng, cfg, rehearsal)
        bodies = [{"tokens": turns[k], "max_new_tokens": max_new}
                  for k in range(3) for turns in sessions]
        bodies += [dict({"tokens": p, "max_new_tokens": max_new, "seed": i},
                        **SAMPLING) for i, p in enumerate(sampled)]
        want = reference_answers(ref, bodies)
        got, lost, served = [], 0, {}
        for b in bodies:
            status, body, _ = route_post(rport, b)
            if status != 200:
                lost += 1
                got.append(None)
                continue
            got.append(body["tokens"])
            served[body["replica"]] = served.get(body["replica"], 0) + 1
        stream_prompt = sessions[0][2]
        events, _, _ = sse_post(rport, {"tokens": stream_prompt,
                                        "max_new_tokens": max_new,
                                        "stream": True})
        streamed = [t for kind, d in events if kind == "token"
                    for t in d["tokens"]]
        if lost:
            failures.append(f"(a) {lost} of {len(bodies)} requests lost "
                            f"through the router")
        wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if wrong:
            failures.append(f"(a) answers {wrong} differ from one engine's")
        if streamed != want[12] or events[-1][0] != "done":
            failures.append("(a) the streamed request's tokens differ from "
                            "the buffered answer")
        snap = router.metrics.snapshot()
        out.update(requests=len(bodies) + 1, lost=lost,
                   served_by=served, affinity_hit_rate=snap["affinity"][
                       "hit_rate"], retries=snap["retries"],
                   ejections=snap["ejections"])
        # TTFT on the client's clock (the first SSE token), the same
        # sessions' prompts through the router and straight to the
        # endpoint that holds them, alternating.
        ttft = {"router": [], "direct": []}
        for turns in sessions:
            p = turns[2]
            target = router._ring.lookup(router.affinity_key(p))[0]
            dport = int(target.rsplit(":", 1)[1])
            for kind, port in (("router", rport), ("direct", dport)):
                _, first, _ = sse_post(port, {"tokens": p, "stream": True,
                                              "max_new_tokens": 2})
                ttft[kind].append(round(first * 1e3, 3))
        out["ttft_ms"] = ttft
        out["ttft_median_ms"] = {k: float(np.median(v))
                                 for k, v in ttft.items()}
        # Hedging: prompts whose affinity target is endpoint 0, every
        # forward to it stalled 150 ms; unhedged, then a 30 ms hedge.
        hedge_prompts = []
        s = 0
        while len(hedge_prompts) < 4 and s < 4096:
            p = rng.randint(0, cfg.vocab_size, (24,)).tolist()
            if router._ring.lookup(router.affinity_key(p))[0] == eps[0]:
                hedge_prompts.append(p)
            s += 1
        hedge = {}
        for mode, hedge_ms in (("unhedged", 0.0), ("hedged", 30.0)):
            hr = Router(eps, config=RouterConfig(block_tokens=16,
                                                 hedge_s=hedge_ms / 1e3))
            fl.install(fl.parse_plan(
                f"slow-route:{eps[0]}@0*100000~0.15/router.forward", seed=0))
            lats, answers = [], []
            try:
                for p in hedge_prompts:
                    t1 = time.perf_counter()
                    status, _, body = hr.handle(json.dumps(
                        {"tokens": p, "max_new_tokens": max_new}).encode(),
                        {}, None)
                    lats.append((time.perf_counter() - t1) * 1e3)
                    answers.append(json.loads(body)["tokens"]
                                   if status == 200 else status)
            finally:
                fl.uninstall()
            hs = hr.metrics.snapshot()
            hedge[mode] = {"p99_ms": round(max(lats), 3),
                           "median_ms": round(float(np.median(lats)), 3),
                           "hedges": hs["hedges"],
                           "hedges_won": hs["hedges_won"],
                           "answers": answers}
        if hedge["hedged"]["answers"] != hedge["unhedged"]["answers"] or \
                any(not isinstance(a, list)
                    for a in hedge["unhedged"]["answers"]):
            failures.append("(a) hedged answers differ from unhedged ones")
        for mode in hedge:
            hedge[mode].pop("answers")
        out["hedge"] = dict(hedge, stall_ms=150.0, hedge_ms=30.0,
                            requests=len(hedge_prompts))
    finally:
        rsrv.stop()
        for srv, _ in servers:
            srv.stop()
    log(f"  (a) {out['requests']} requests through the router, {out['lost']} "
        f"lost, served by {out['served_by']}; affinity hit rate "
        f"{out['affinity_hit_rate']}, retries {out['retries']}, ejections "
        f"{out['ejections']}; TTFT median (client, first SSE token) "
        f"through the router {out['ttft_median_ms']['router']:.2f} ms, "
        f"straight {out['ttft_median_ms']['direct']:.2f} ms; hedging "
        f"under a 150 ms stall: p99 unhedged "
        f"{out['hedge']['unhedged']['p99_ms']:.1f} ms, hedged "
        f"{out['hedge']['hedged']['p99_ms']:.1f} ms, hedges won "
        f"{out['hedge']['hedged']['hedges_won']} of "
        f"{out['hedge']['hedged']['hedges']}")
    return out


def fleet_storm(port, prompts, max_new):
    """16 concurrent greedy requests to ``port``; (tokens/s, answers)."""
    answers = [None] * len(prompts)

    def post(i):
        status, body, _ = route_post(port, {"tokens": prompts[i],
                                            "max_new_tokens": max_new})
        answers[i] = body["tokens"] if status == 200 else status

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.monotonic() - t0
    toks = sum(len(a) for a in answers if isinstance(a, list))
    return round(toks / dt, 2), answers


def fleet_tracing(torch, factory, ref, rng, cfg, rehearsal, max_new,
                  failures):
    """(b) Every request sampled (``HVD_TRACE_SAMPLE=1``'s tracer) with a
    shard directory: one request through the router merges into one
    connected tree from the router's root down to the endpoint's
    decode, ``/trace`` serves it, and a 16-request storm's tokens/s
    traced against untraced."""
    import shutil
    import tempfile
    from horovod_tpu_torch.obs import merge as mg
    from horovod_tpu_torch.obs import tracing as tr
    from horovod_tpu_torch.serve import Router, RouterConfig, RouterServer
    servers = [fleet_endpoint(factory, f"endpoint-{i}") for i in range(2)]
    eps = [f"127.0.0.1:{port}" for _, port in servers]
    rsrv = RouterServer(Router(eps, config=RouterConfig(block_tokens=16)))
    rport = rsrv.start(port=0, host="127.0.0.1")
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    out = {}
    try:
        storm = [rng.randint(0, cfg.vocab_size,
                             (fleet_len(rng, cfg, max_new, 16, 64),)).tolist()
                 for _ in range(16)]
        want = reference_answers(ref, [{"tokens": p, "max_new_tokens":
                                        max_new} for p in storm])
        rates = {}
        for kind in ("untraced", "traced"):
            if kind == "traced":
                tr.install(tr.Tracer(sample=1.0, shard_dir=shard_dir))
            try:
                rates[kind], answers = fleet_storm(rport, storm, max_new)
            finally:
                tr.uninstall()
            if answers != want:
                failures.append(f"(b) a {kind} storm's answers differ from "
                                f"one engine's")
        # The yardstick: the same storm straight to one endpoint (its
        # 8 slots take all 16 in two waves), no router hop.
        rates["one_endpoint_direct"], answers = fleet_storm(
            servers[0][1], storm, max_new)
        if answers != want:
            failures.append("(b) the direct storm's answers differ from "
                            "one engine's")
        # The JAX package's listen backlog of 5 (socketserver's
        # default) in front of the same fleet: fresh endpoints and a
        # router whose listeners queue 5 connections, one untraced storm.
        from horovod_tpu_torch.serve import server as serve_server
        cls = serve_server.DrainingThreadingHTTPServer
        cls.request_queue_size, kept = 5, cls.request_queue_size
        try:
            servers5 = [fleet_endpoint(factory, f"endpoint-{i}")
                        for i in range(2)]
            rsrv5 = RouterServer(Router(
                [f"127.0.0.1:{p}" for _, p in servers5],
                config=RouterConfig(block_tokens=16)))
            rport5 = rsrv5.start(port=0, host="127.0.0.1")
        finally:
            cls.request_queue_size = kept
        try:
            rates["backlog_5"], answers = fleet_storm(rport5, storm, max_new)
        finally:
            rsrv5.stop()
            for srv, _ in servers5:
                srv.stop()
        if answers != want:
            failures.append("(b) the backlog-5 storm's answers differ")
        out["storm_tokens_per_s"] = rates
        shutil.rmtree(shard_dir, ignore_errors=True)
        tracer = tr.install(tr.Tracer(sample=1.0, shard_dir=shard_dir))
        tid = "c0ffee00c0ffee00"
        prompt = storm[0]
        status, body, headers = route_post(rport, {"tokens": prompt,
                                                   "max_new_tokens": max_new},
                                           {"X-Trace-Id": tid})
        endpoint = body.get("replica")
        port = dict(zip([f"endpoint-{i}" for i in range(2)],
                        [p for _, p in servers]))[endpoint]
        deadline = time.monotonic() + 30
        while True:  # the decode span lands after the reply
            served = http_json(port, "/trace")
            mine = [t for t in served["traces"] if t["trace_id"] == tid]
            if (mine and "decode" in json.dumps(mine[0]["tree"])) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
        tr.uninstall()  # closes the shards
        shards = mg.load_shards(shard_dir)
        events = mg.spans_by_trace(shards).get(tid, [])
        tree = mg.build_tree([e for e in events if e["type"] == "span"])
        names = []

        def walk(n, depth):
            names.append((depth, n["name"], n["proc"]))
            for c in n["children"]:
                walk(c, depth + 1)
        for n in tree:
            walk(n, 0)
        need = {(0, "http-handle", "router"), (1, "route", "router"),
                (1, "http-handle", "server"), (2, "queue-wait", endpoint),
                (2, "prefill-chunk", endpoint), (2, "decode", endpoint)}
        if status != 200 or headers.get("X-Trace-Id") != tid:
            failures.append(f"(b) the traced request answered {status}")
        if len(tree) != 1 or not need <= set(names):
            failures.append(f"(b) the merged trace is not one connected "
                            f"tree from the router to the decode: {names}")
        if not mine:
            failures.append("(b) /trace does not serve the request's tree")
        cp = mg.critical_path(events)
        out.update(trace={"spans": len(names), "shards": len(shards),
                          "tree": sorted({(d, n) for d, n, _ in names}),
                          "critical_path_ms": cp["stages_ms"],
                          "total_ms": cp["total_ms"],
                          "dropped": tracer.spans_dropped})
    finally:
        tr.uninstall()
        rsrv.stop()
        for srv, _ in servers:
            srv.stop()
        shutil.rmtree(shard_dir, ignore_errors=True)
    log(f"  (b) one traced request: {len(names)} spans in one tree over "
        f"{out['trace']['shards']} shards, critical path "
        f"{out['trace']['critical_path_ms']} of {out['trace']['total_ms']} "
        f"ms; 16-request storm tokens/s through the router untraced "
        f"{rates['untraced']}, traced {rates['traced']}; straight to one "
        f"endpoint {rates['one_endpoint_direct']}; through the router with "
        f"the JAX package's listen backlog of 5 {rates['backlog_5']}")
    return out


def fleet_controller(torch, factory, ref, rng, cfg, rehearsal, max_new,
                     seed, failures):
    """(c) Two replicas, one a dead spare, under the JAX bench's
    autoscale-arm settings, a seeded diurnal sweep and a ctl.poll
    load-spike: a scale-up, the brownout ladder up and back to 0, every
    latency-tier answer one engine's."""
    from horovod_tpu_torch import faultline as fl
    from horovod_tpu_torch.serve import (ControllerConfig, FleetController,
                                         QueueFullError, Request,
                                         ServeMetrics, build_replicas)
    metrics = ServeMetrics()
    sched = build_replicas(factory, num_replicas=2, max_batch=2,
                           prefill_chunk=64, metrics=metrics, warmup=True)
    sched.start()
    sched.mark_dead("replica-1", reason="phase 14 (c): the spare")
    slo_ms = 15000.0
    ctl = FleetController(sched, config=ControllerConfig(
        poll_s=0.05, min_replicas=1, max_replicas=2, queue_high=2.0,
        queue_low=1.0, up_polls=2, down_polls=2, up_cooldown_s=0.0,
        down_cooldown_s=0.0, brownout_polls=1, brownout_clear_polls=2,
        brownout_max_new=max_new).validate(), metrics=metrics,
        load_injector=lambda n: sum(
            inject_throughput(sched, n, QueueFullError, Request)))
    shape = fl.diurnal_load(8, peak=8, base=1, seed=seed)
    prompts = [rng.randint(0, cfg.vocab_size,
                           (fleet_len(rng, cfg, max_new, 8, 48),)).tolist()
               for _ in range(sum(max(n, 1) for n in shape))]
    fl.install(fl.parse_plan("load-spike@6*1~8/ctl.poll", seed=seed))
    outs, levels, shed, t0 = [], [], 0, time.monotonic()
    spare = sched.fleet()[1]
    try:
        cursor = 0
        for n in shape:
            chunk = prompts[cursor:cursor + max(n, 1)]
            cursor += len(chunk)
            reqs = [Request(p, max_new_tokens=max_new) for p in chunk]
            for r in reqs:
                sched.submit(r)
            try:
                sched.submit(Request(prompts[0][:4], max_new_tokens=2,
                                     qos="throughput"))
            except QueueFullError:
                shed += 1
            while not all(r.done for r in reqs):
                ctl.poll()
                levels.append(ctl.stats()["brownout_level"])
                time.sleep(0.02)
            outs += [r.result(timeout=600) for r in reqs]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                ctl.stats()["brownout_level"]
                or not ctl.stats()["scale_events"]["scale_down"]):
            ctl.poll()
            levels.append(ctl.stats()["brownout_level"])
            time.sleep(0.02)
    finally:
        fl.uninstall()
        ctl.stop()
        sched.stop()
    phase_s = time.monotonic() - t0
    stats = ctl.stats()
    snap = metrics.snapshot()
    want = reference_answers(ref, [{"tokens": p, "max_new_tokens": max_new}
                                   for p in prompts])
    if stats["scale_events"]["scale_up"] < 1:
        failures.append("(c) no scale-up")
    if max(levels, default=0) < 1 or levels[-1:] != [0]:
        failures.append(f"(c) the ladder did not climb and come back to 0: "
                        f"max {max(levels, default=0)}, last {levels[-1:]}")
    if outs != want:
        failures.append("(c) latency-tier answers differ from one engine's")
    out = {"diurnal_shape": shape, "requests": len(prompts),
           "scale_events": stats["scale_events"],
           "brownout_seconds": stats["brownout_seconds"],
           "max_brownout_level": max(levels, default=0),
           "throughput_shed": shed,
           "latency_p99_ms": snap["request_latency"]["latency"]["p99_ms"],
           "slo_ms": slo_ms,
           "mark_alive_warmup_ms": round(spare.engine.last_warmup_ms, 3),
           "warmup_runs_of_the_spare": spare.engine.warmup_runs,
           "seconds": round(phase_s, 3)}
    log(f"  (c) controller: events {out['scale_events']}, max rung "
        f"{out['max_brownout_level']}, brownout {out['brownout_seconds']} s, "
        f"latency-tier p99 {out['latency_p99_ms']} ms (SLO {slo_ms:.0f}), "
        f"the spare's warmup at mark_alive {out['mark_alive_warmup_ms']} ms; "
        f"{phase_s:.1f} s")
    return out


def inject_throughput(sched, n, QueueFullError, Request):
    """The load-spike's synthetic throughput-tier requests; yields 1 for
    each one admitted (a brownout rung sheds them)."""
    for _ in range(n):
        try:
            sched.submit(Request([1, 2, 3, 4], max_new_tokens=2,
                                 qos="throughput"))
            yield 1
        except QueueFullError:
            yield 0


class _MaintenanceEvents:
    """A local stand-in for a cloud metadata server's maintenance-event
    endpoint (answers ``event``)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.event = "NONE"
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                body = outer.event.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def fleet_preemption(torch, factory, ref, rng, cfg, rehearsal, max_new,
                     failures):
    """(d) The port's KV server and a local maintenance endpoint: the
    sentinel marks host h1, ``watch_preemption`` marks replica-1 dead
    while requests are in flight (they fail over without loss), and
    clearing the marker brings replica-1 back alive and warm."""
    import types
    from horovod_tpu_torch.elastic.preemption import (PREEMPT_SCOPE,
                                                      PreemptionSentinel)
    from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                      KVStoreServer)
    from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                         ReplicaScheduler, Request,
                                         ServeMetrics)
    metrics = ServeMetrics()
    reps = [Replica(f"replica-{i}", types.SimpleNamespace(ranks=[i]),
                    InferenceEngine(factory(), max_batch=8,
                                    prefill_chunk=64, metrics=metrics,
                                    replica_id=f"replica-{i}", warmup=True))
            for i in range(2)]
    sched = ReplicaScheduler(reps, metrics=metrics).start()
    kv = KVStoreServer()
    client = KVStoreClient("127.0.0.1", kv.start(0))
    meta = _MaintenanceEvents()
    sentinel = PreemptionSentinel(client, hostname="h1", url=meta.url,
                                  poll_interval_s=0.05)
    out = {}
    try:
        sentinel.start()
        sched.watch_preemption(client, {"h0": [0], "h1": [1]}, poll_s=0.02)
        prompts = [rng.randint(0, cfg.vocab_size,
                               (fleet_len(rng, cfg, max_new, 8, 64),)).tolist()
                   for _ in range(16)]
        reqs = [Request(p, max_new_tokens=max_new) for p in prompts]
        for r in reqs:
            sched.submit(r)
        warm = reps[1].engine.warmup_runs
        t0 = time.monotonic()
        meta.event = "TERMINATE_ON_HOST_MAINTENANCE"
        while reps[1].state != "dead" and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        dead_s = time.monotonic() - t0
        marked = kv.scan_scope(PREEMPT_SCOPE)
        answers = [r.result(timeout=600) for r in reqs]
        requeues = sum(r.requeues for r in reqs)
        t1 = time.monotonic()
        meta.event = "NONE"
        while reps[1].engine.warmup_runs == warm and \
                time.monotonic() - t1 < 30:
            time.sleep(0.005)
        alive_s = time.monotonic() - t1
        after = reference_answers(reps[1].engine, [
            {"tokens": prompts[0], "max_new_tokens": max_new}])
        want = reference_answers(ref, [{"tokens": p, "max_new_tokens":
                                        max_new} for p in prompts])
        if reps[1].state != "healthy" or marked != {
                "h1": b"TERMINATE_ON_HOST_MAINTENANCE"}:
            failures.append(f"(d) replica-1 state {reps[1].state}, markers "
                            f"{marked}")
        if answers != want or after != want[:1]:
            failures.append("(d) answers across the failover (or from the "
                            "readmitted replica) differ from one engine's")
        if reps[1].engine.warmup_runs != warm + 1:
            failures.append("(d) the readmitted replica did not warm up")
        out = {"requests": len(reqs), "requeued": requeues,
               "notice_to_dead_s": round(dead_s, 3),
               "clear_to_warm_alive_s": round(alive_s, 3),
               "readmitted_warmup_ms": round(reps[1].engine.last_warmup_ms,
                                             3),
               "replica_events": metrics.snapshot()["replica_events"],
               "preempt_poll_errors": metrics.snapshot()[
                   "preempt_poll_errors"]}
    finally:
        sentinel.stop()
        sched.stop()
        kv.stop()
        meta.stop()
    log(f"  (d) preemption: notice to mark_dead {out.get('notice_to_dead_s')}"
        f" s, {out.get('requeued')} requests requeued of "
        f"{out.get('requests')}, none lost; the marker's clear to a warm "
        f"replica-1 {out.get('clear_to_warm_alive_s')} s (warmup "
        f"{out.get('readmitted_warmup_ms')} ms)")
    return out


def fleet_phase(torch, device, rehearsal, seed):
    """Phase 14: the serving fleet's front door and control plane on
    gpt2-small f32 at full width, random weights from ``seed``: (a) the
    router over two endpoints, (b) tracing, (c) the fleet controller,
    (d) preemption.  Returns the paged routes' launches of the phase
    (counted from 0 at its start) and its numbers."""
    from horovod_tpu_torch.serve import InferenceEngine, TransformerAdapter
    from horovod_tpu_torch.serve import paged_attention as pa
    cfg, model, _, max_new = serving_model(torch, device, rehearsal, seed)

    def factory():
        return TransformerAdapter(cfg, model, device=device)

    rng = np.random.RandomState(seed + 14)
    failures = []
    out = {"card": None if rehearsal else card_tag()}
    reset_launches(pa)
    t0 = time.monotonic()
    ref = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                          replica_id="reference").start()
    try:
        for part, fn in (("front_door", fleet_front_door),
                         ("tracing", fleet_tracing),
                         ("controller", fleet_controller),
                         ("preemption", fleet_preemption)):
            tp = time.monotonic()
            if fn is fleet_controller:
                out[part] = fn(torch, factory, ref, rng, cfg, rehearsal,
                               max_new, seed, failures)
            else:
                out[part] = fn(torch, factory, ref, rng, cfg, rehearsal,
                               max_new, failures)
            out[part]["part_seconds"] = round(time.monotonic() - tp, 3)
    finally:
        ref.stop()
    launches = {"decode": pa.LAUNCHES["paged_attention_decode"],
                "prefill": pa.LAUNCHES["paged_attention_prefill"]}
    out["seconds"] = round(time.monotonic() - t0, 3)
    log(f"  launches of the phase's drives: decode route "
        f"{launches['decode']}, prefill route {launches['prefill']}")
    if not rehearsal and min(launches.values()) <= 0:
        failures.append("a paged route was never launched in phase 14")
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("the serving fleet phase failed")
    out["launches"] = launches
    return launches, out


# -- phase 15: the tiered KV hierarchy and sequence-parallel prefill --------


def timed_request(eng, prompt, max_new):
    """One request through the engine: (tokens, TTFT ms, request)."""
    from horovod_tpu_torch.serve import Request
    r = Request(list(prompt), max_new_tokens=max_new)
    eng.batcher.submit(r)
    toks = r.result(timeout=600)
    return toks, (r.first_token_at - r.submitted_at) * 1e3, r


def storm_peak(eng, prompts, max_new):
    """The prompts submitted at once; (answers, the most distinct
    requests the engine held in flight at any poll)."""
    from horovod_tpu_torch.serve import Request
    peak = [0]
    done = threading.Event()

    def watch():
        while not done.is_set():
            with eng._lock:
                live = len({id(s.request) for s in eng._slots
                            if s is not None})
            peak[0] = max(peak[0], live)
            time.sleep(0.0005)

    w = threading.Thread(target=watch)
    w.start()
    try:
        reqs = [Request(list(p), max_new_tokens=max_new) for p in prompts]
        for r in reqs:
            eng.batcher.submit(r)
        out = [r.result(timeout=600) for r in reqs]
    finally:
        done.set()
        w.join()
    return out, peak[0]


def tier_host(torch, factory, ref, rng, cfg, rehearsal, max_new, engines,
              failures):
    """(a) The host tier: 6 sessions whose retained prompt blocks need
    more than the device pool holds, served twice (the second turn
    promotes the spilled blocks), one block held bit for bit across its
    spill and promote, then a 6-request storm on the tiered engine and an
    untiered one of the same pool bytes."""
    from horovod_tpu_torch.serve import (InferenceEngine, ServeMetrics,
                                         TierConfig, chain_hashes)
    bt = ref.blocks.block_tokens
    plen = 2 * bt + 5 if rehearsal else 10 * bt + 5
    life = -(-(plen + max_new) // bt)
    pool = 2 * life + 2
    sessions = [rng.randint(0, cfg.vocab_size, (plen,)).tolist()
                for _ in range(6)]
    fresh = [rng.randint(0, cfg.vocab_size, (plen,)).tolist()
             for _ in range(6)]
    want = reference_answers(ref, [{"tokens": p, "max_new_tokens": max_new}
                                   for p in sessions + fresh])
    tiered = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                             num_blocks=pool, replica_id="tier-host",
                             tiering=TierConfig(oversub=4.0, quantum=2),
                             metrics=ServeMetrics())
    untiered = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                               num_blocks=pool, replica_id="untiered",
                               metrics=ServeMetrics())
    engines += [tiered, untiered]
    out = {"sessions": 6, "prompt_tokens": plen, "pool_blocks": pool,
           "retained_blocks_needed": 6 * (plen // bt),
           "block_bytes": tiered.blocks.bytes_per_block}
    tiered.start()
    untiered.start()
    try:
        # Session 0's first block: copied out after its first turn, on
        # the host after the other sessions' first turns, and promoted
        # into a fresh device block by its second turn.  The engine is
        # idle at each copy (the loop waits for a request).
        h0 = chain_hashes(sessions[0], bt)[0]
        copies = {}
        for turn in (1, 2):
            for i, p in enumerate(sessions):
                got, _, _ = timed_request(tiered, p, max_new)
                if got != want[i]:
                    failures.append(f"(a) session {i} turn {turn}: tokens "
                                    f"differ from the reference")
                bid = tiered.blocks.registered_block(h0)
                if i == 0 and bid is not None:
                    copies[turn] = (bid, tiered.blocks.extract_block(bid))
            if turn == 1 and not tiered.blocks.host_contains(h0):
                failures.append("(a) session 0's first block never "
                                "spilled to the host tier")
        same = len(copies) == 2 and all(
            torch.equal(copies[1][1][k], copies[2][1][k])
            for k in copies[1][1])
        if not same:
            failures.append("(a) a spilled and promoted block is not "
                            "bit-equal to the block before its spill")
        out["spill_promote_bit_equal"] = same
        st = tiered.kv_stats()["tier"]
        out["sessions_tier"] = {k: st[k] for k in (
            "spills", "promotes", "spill_bytes", "promote_bytes",
            "host_blocks", "host_bytes")}
        t0 = time.monotonic()
        got_u, peak_u = storm_peak(untiered, fresh, max_new)
        t1 = time.monotonic()
        got_t, _ = storm_peak(tiered, fresh, max_new)
        t2 = time.monotonic()
        st = tiered.kv_stats()["tier"]
        if got_u != want[6:] or got_t != want[6:]:
            failures.append("(a) a storm's tokens differ from the "
                            "reference")
        if not st["inflight_peak"] > peak_u:
            failures.append(f"(a) in-flight peak {st['inflight_peak']} "
                            f"not above untiered {peak_u}")
        if not (st["spill_bytes"] > 0 and st["promote_bytes"] > 0):
            failures.append("(a) no spill or promote bytes")
        out["storm"] = {
            "inflight_peak_tiered": st["inflight_peak"],
            "inflight_peak_untiered": peak_u,
            "seconds_tiered": round(t2 - t1, 3),
            "seconds_untiered": round(t1 - t0, 3),
            "swapped_out_seqs": st["swapped_out_seqs"],
            "swapped_in_seqs": st["swapped_in_seqs"],
            "preempted_tiered":
                tiered.metrics.snapshot()["requests"]["preempted"],
            "preempted_untiered":
                untiered.metrics.snapshot()["requests"]["preempted"]}
        out["tier_totals"] = {k: st[k] for k in (
            "spills", "promotes", "spill_bytes", "promote_bytes")}
    finally:
        tiered.stop()
        untiered.stop()
    log(f"  (a) host tier: pool {pool} blocks of {out['block_bytes']} B, "
        f"{out['retained_blocks_needed']} retained blocks needed; "
        f"{json.dumps(out['sessions_tier'])}; storm in flight "
        f"{out['storm']['inflight_peak_tiered']} tiered against "
        f"{peak_u} untiered")
    return out


def tier_fleet(torch, factory, ref, rng, cfg, rehearsal, max_new, engines,
               failures):
    """(b) The fleet tier: endpoint A publishes a prompt's blocks to a KV
    server in this process; fresh endpoints migrate them at prompt
    lengths k·BT - 1, k·BT and k·BT + 1 and answer as local prefill; a
    drop-tier-block train recomputes; mark_dead unpublishes."""
    from horovod_tpu_torch import faultline as fl
    from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                      KVStoreServer)
    from horovod_tpu_torch.serve import (InferenceEngine, Replica,
                                         ReplicaScheduler, ServeMetrics,
                                         TierClient, TierConfig,
                                         TieredBlockManager, chain_hashes)
    bt = ref.blocks.block_tokens
    k = 2 if rehearsal else 17
    base = rng.randint(0, cfg.vocab_size, (k * bt + 1,)).tolist()
    server = KVStoreServer()
    port = server.start(0)

    def endpoint(rid):
        eng = InferenceEngine(
            factory(), max_batch=8, prefill_chunk=64, num_blocks=64,
            replica_id=rid, metrics=ServeMetrics(), tiering=TierConfig(),
            tier_client=TierClient(KVStoreClient("127.0.0.1", port),
                                   replica_id=rid))
        engines.append(eng)
        return eng.start()

    out = {"shared_blocks": k}
    ea = endpoint("tier-a")
    sched = ReplicaScheduler([Replica("tier-a", None, ea)])
    try:
        want_a, _, _ = timed_request(ref, base, max_new)
        got_a, _, _ = timed_request(ea, base, max_new)
        if got_a != want_a:
            failures.append("(b) the publisher's tokens differ")
        deadline = time.monotonic() + 30
        while ea.kv_stats()["tier"]["published"] < k \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        out["published"] = ea.kv_stats()["tier"]["published"]
        mig = {}
        for n in (k * bt - 1, k * bt, k * bt + 1):
            p = base[:n]
            want, ttft_local, _ = timed_request(ref, p, max_new)
            eb = endpoint(f"tier-b{n}")
            try:
                got, ttft_mig, _ = timed_request(eb, p, max_new)
                st = eb.kv_stats()["tier"]
            finally:
                eb.stop()
            expect = (n - 1) // bt * bt
            if got != want:
                failures.append(f"(b) migrated prompt of {n} tokens: "
                                f"tokens differ from local prefill")
            if st["migrated_tokens"] != expect:
                failures.append(f"(b) {n} tokens: migrated "
                                f"{st['migrated_tokens']}, want {expect}")
            mig[str(n)] = {"ttft_ms_migrated": round(ttft_mig, 3),
                           "ttft_ms_local_prefill": round(ttft_local, 3),
                           "migrated_tokens": st["migrated_tokens"],
                           "fetch_attempts": st["fetch_attempts"],
                           "tier_faults": st["faults"]}
            log(f"  (b) {n} tokens: TTFT migrated {ttft_mig:.2f} ms, "
                f"local prefill {ttft_local:.2f} ms, "
                f"{st['migrated_tokens']} tokens migrated")
        out["migration"] = mig
        ec = endpoint("tier-c")
        fl.install(fl.FaultPlan([fl.FaultSpec(
            "drop-tier-block", step=0, repeat=8 * k)]))
        try:
            got, ttft_drop, _ = timed_request(ec, base, max_new)
        finally:
            fl.uninstall()
            ec.stop()
        st = ec.kv_stats()["tier"]
        if got != want_a:
            failures.append("(b) the drop train changed the tokens")
        if st["migration_failures"] < 1 or st["migrated_tokens"] != 0:
            failures.append("(b) the drop train did not degrade to "
                            "recompute")
        out["drop_train"] = {"ttft_ms": round(ttft_drop, 3),
                             "migration_failures":
                                 st["migration_failures"],
                             "fetch_drops": st["fetch_drops"]}
        hashes = chain_hashes(base, bt, salt=ea._prefix_salt(None))[:k]

        def hits(rid):
            probe = TieredBlockManager(4, bt, TierConfig(), client=TierClient(
                KVStoreClient("127.0.0.1", port), replica_id=rid))
            return probe.remote_hits(hashes)

        before = hits("probe-0")
        sched.mark_dead("tier-a", reason="phase 15 (b)")
        after = hits("probe-1")
        if before != k or after != 0:
            failures.append(f"(b) mark_dead: directory hits {before} "
                            f"before, {after} after")
        out["mark_dead"] = {"hits_before": before, "hits_after": after}
    finally:
        fl.uninstall()
        ea.stop()
        server.stop()
    return out


def tier_seqpar(torch, factory, ref, rng, cfg, rehearsal, max_new, engines,
                failures):
    """(c) Sequence-parallel prefill at 4 ranks against single-rank
    prefill, at k·BT - 1, k·BT, k·BT + 1 and a long prompt, and the
    kill-rank drill."""
    from horovod_tpu_torch import faultline as fl
    from horovod_tpu_torch.serve import InferenceEngine, ServeMetrics
    bt = ref.blocks.block_tokens
    k, long_len = (3, 56) if rehearsal else (40, 1000)
    esp = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                          prefix_cache=False, sp_ranks=4,
                          sp_min_tokens=16 if rehearsal else 256,
                          replica_id="sp", metrics=ServeMetrics())
    engines.append(esp)
    world = esp.seqpar
    bpb = esp.blocks.bytes_per_block
    out = {"ranks": world.ranks, "block_bytes": bpb,
           "blocks_per_rank": world.blocks_per_rank,
           "side_pool_bytes_per_rank": world.blocks_per_rank * bpb,
           "side_pool_bytes": world.ranks * world.blocks_per_rank * bpb,
           "hop_bytes": world._hop_bytes(),
           "ring_bytes_per_prefill": world.ring_bytes_per_prefill()}
    log(f"  (c) a block {bpb} B over the layers; a rank's side pool "
        f"{world.blocks_per_rank} blocks = {out['side_pool_bytes_per_rank']}"
        f" B, {world.ranks} ranks {out['side_pool_bytes']} B; one hop "
        f"{out['hop_bytes']} B, a prefill's ring "
        f"{world.ranks * (world.ranks - 1)} x {out['hop_bytes']} = "
        f"{out['ring_bytes_per_prefill']} B")
    esp.start()
    prompts = {}
    try:
        for n in (k * bt - 1, k * bt, k * bt + 1, long_len):
            p = rng.randint(0, cfg.vocab_size, (n,)).tolist()
            prompts[n] = p
            want, ttft_single, _ = timed_request(ref, p, max_new)
            before = (world.jobs_total, world.handoff_bytes_total,
                      world.ring_hops_total)
            got, ttft_sp, _ = timed_request(esp, p, max_new)
            if got != want:
                failures.append(f"(c) SP prefill of {n} tokens: tokens "
                                f"differ from single-rank prefill")
            if world.jobs_total != before[0] + 1:
                failures.append(f"(c) {n} tokens did not prefill "
                                f"sequence-parallel")
            out[str(n)] = {
                "ttft_ms_sp": round(ttft_sp, 3),
                "ttft_ms_single_rank": round(ttft_single, 3),
                "emulated_wall_ms": round(world.walls[-1] * 1e3, 3),
                "handoff_bytes": world.handoff_bytes_total - before[1],
                "ring_hops": world.ring_hops_total - before[2]}
            log(f"  (c) {n} tokens: TTFT SP {ttft_sp:.2f} ms (emulated "
                f"wall {world.walls[-1] * 1e3:.2f} ms), single-rank "
                f"{ttft_single:.2f} ms; handoff "
                f"{out[str(n)]['handoff_bytes']} B, ring hops "
                f"{out[str(n)]['ring_hops']}")
        fl.install(fl.FaultPlan([fl.FaultSpec("kill-rank",
                                              point="sp.prefill", step=0)]))
        try:
            got, ttft_kill, r = timed_request(esp, prompts[long_len],
                                              max_new)
        finally:
            fl.uninstall()
        want, _, _ = timed_request(ref, prompts[long_len], max_new)
        leaks = [world.blocks_per_rank - m.available()
                 for m in world.managers]
        if got != want or r.requeues != 1 or world.aborts_total != 1 \
                or any(leaks):
            failures.append(f"(c) kill-rank drill: same tokens "
                            f"{got == want}, requeues {r.requeues}, aborts "
                            f"{world.aborts_total}, blocks held {leaks}")
        out["kill_rank"] = {"ttft_ms": round(ttft_kill, 3),
                            "requeues": r.requeues,
                            "aborts": world.aborts_total,
                            "blocks_held_per_rank": leaks}
        out["traced_ms"] = traced_breakdown(
            {"sp": esp, "single_rank": ref}, prompts[long_len], max_new)
        log(f"  (c) {long_len} tokens traced, span ms by name: "
            f"{json.dumps(out['traced_ms'])}")
        out["stats"] = esp.kv_stats()["sp"]
    finally:
        esp.stop()
    return out


def traced_breakdown(engines, prompt, max_new):
    """One traced request per engine: the milliseconds of its spans
    summed by name (an SP prefill's ``sp-extent-chunk`` compute against
    its ``sp-handoff`` copies, a single-rank prefill's chunks), and its
    TTFT."""
    from horovod_tpu_torch.obs import tracing as tr
    from horovod_tpu_torch.serve import Request
    tracer = tr.install(tr.Tracer(sample=1.0))
    out = {}
    try:
        for name, eng in engines.items():
            r = Request(list(prompt), max_new_tokens=max_new)
            r.trace = tracer.new_context()
            eng.batcher.submit(r)
            r.result(timeout=600)
            ms = {"ttft": (r.first_token_at - r.submitted_at) * 1e3}
            stack = [n for t in tracer.recent_traces()
                     if t["trace_id"] == r.trace.trace_id for n in t["tree"]]
            while stack:
                node = stack.pop()
                stack.extend(node["children"])
                ms[node["name"]] = ms.get(node["name"], 0.0) + (
                    node["t1_ns"] - node["t0_ns"]) / 1e6
            out[name] = {k: round(v, 3) for k, v in sorted(ms.items())}
    finally:
        tr.uninstall()
    return out


def tier_phase(torch, device, rehearsal, seed):
    """Phase 15: the tiered KV hierarchy and sequence-parallel prefill on
    gpt2-small f32 at full width and depth, random weights from ``seed``,
    in one process: (a) the host tier, (b) the fleet tier, (c) SP
    prefill.  Every engine of the phase is counted: each decode step must
    launch the decode route once per layer and each prefill step the
    prefill route once per layer.  Returns the paged routes' launches of
    the phase (from 0 at its start) and its numbers."""
    from horovod_tpu_torch.serve import (InferenceEngine, ServeMetrics,
                                         TransformerAdapter)
    from horovod_tpu_torch.serve import paged_attention as pa
    cfg, model, _, max_new = serving_model(torch, device, rehearsal, seed)

    def factory():
        return TransformerAdapter(cfg, model, device=device)

    rng = np.random.RandomState(seed + 15)
    failures = []
    out = {"card": None if rehearsal else card_tag()}
    reset_launches(pa)
    t0 = time.monotonic()
    ref = InferenceEngine(factory(), max_batch=8, prefill_chunk=64,
                          prefix_cache=False, replica_id="reference",
                          metrics=ServeMetrics())
    engines = [ref]
    ref.start()
    try:
        for part, fn in (("host_tier", tier_host),
                         ("fleet_tier", tier_fleet),
                         ("sp_prefill", tier_seqpar)):
            tp = time.monotonic()
            out[part] = fn(torch, factory, ref, rng, cfg, rehearsal,
                           max_new, engines, failures)
            out[part]["part_seconds"] = round(time.monotonic() - tp, 3)
    finally:
        ref.stop()
        for eng in engines:
            eng.stop()
    launches = {"decode": pa.LAUNCHES["paged_attention_decode"],
                "prefill": pa.LAUNCHES["paged_attention_prefill"]}
    steps = sum(e.steps for e in engines)
    chunks = sum(e.prefill_steps for e in engines)
    out["seconds"] = round(time.monotonic() - t0, 3)
    out["decode_steps"], out["prefill_steps"] = steps, chunks
    check_launches(pa, cfg, rehearsal, cfg.num_layers * steps,
                   cfg.num_layers * chunks, "phase 15", failures)
    for f in failures:
        log(f"  FAIL: {f}")
    if failures:
        raise SystemExit("the tiering and SP prefill phase failed")
    out["launches"] = launches
    return launches, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default); cpu rehearses at a tiny size")
    parser.add_argument("--seed", type=int, default=1234)
    args = parser.parse_args(argv)
    import torch
    rehearsal = args.device == "cpu"
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from horovod_tpu_torch.serve import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    t_start = time.monotonic()

    log("phase 1: build")
    if rehearsal:
        log("  rehearsal: no build on the CPU")
    else:
        from horovod_tpu_torch.csrc import build
        t0 = time.monotonic()
        path, build_log = build.build()
        log(f"  built {path} in {time.monotonic() - t0:.1f} s from "
            f"{', '.join(build.SOURCES)}")
        for line in build_log.splitlines():
            if ("ptxas info" in line and ("registers" in line
                                          or "bytes smem" in line
                                          or "Compiling" in line)) \
                    or "spill stores" in line:
                log("  " + line.strip())
        for source, spills in spill_report(build_log).items():
            log(f"  spills in {source}: " + (", ".join(
                f"{kernel} {n} B" for kernel, n in spills)
                if spills else "none"))

    log("phase 2: paged attention kernel against its plain version")
    rec = kernel_phase(torch, pa, device, rehearsal)

    log("phase 3: flash attention kernels against their plain versions")
    frec = flash_phase(torch, device, rehearsal)

    log("phase 4: serving path (HTTP server, GPT-2; sampling, forks, "
        "speculative decoding, slot mode)")
    decode_launches, prefill_launches = serving_phase(torch, device,
                                                      rehearsal, args.seed)

    log("phase 5: training path (BERT-large, DistributedOptimizer, NCCL)")
    flash_launches, f32_launches = training_phase(torch, device, rehearsal)

    log("phase 6: ResNet-50 training path (sync batch norm, "
        "DistributedOptimizer, NCCL)")
    resnet_phase(torch, device, rehearsal)

    log("phase 7: collectives over NCCL (allgather, alltoall, "
        "reducescatter, in-place, async, objects, sparse, process sets)")
    collectives = collectives_phase(torch, device, rehearsal)

    log("phase 8: Adasum and GPT-2-medium training (local_value_and_grad, "
        "adasum_delta_step, NCCL)")
    t8 = time.monotonic()
    adasum_launches, adasum_numbers = adasum_phase(torch, device, rehearsal)
    log(f"  phase 8 took {time.monotonic() - t8:.1f} s")

    log("phase 9: the negotiated eager engine (native core, timeline, "
        "join, hierarchical allreduce; NCCL world of one)")
    t9 = time.monotonic()
    eager_launches, eager_numbers = eager_phase(torch, device, rehearsal)
    log(f"  phase 9 took {time.monotonic() - t9:.1f} s")

    log("phase 10: sequence parallelism on one card (ring at n = 1, the "
        "ring's hops over 4 virtual shards, Ulysses' local flash)")
    t10 = time.monotonic()
    seqpar = seqpar_phase(torch, device, rehearsal)
    log(f"  phase 10 took {time.monotonic() - t10:.1f} s")

    log("phase 11: model parallelism in a world of one (MoE GPT-2 small, "
        "the dry-run MoE, pipeline and tensor-parallel steps)")
    t11 = time.monotonic()
    moe_launches, moe_numbers = model_parallel_phase(torch, device,
                                                     rehearsal)
    log(f"  phase 11 took {time.monotonic() - t11:.1f} s")

    log("phase 12: elastic kill-and-rejoin in a world of one (ResNet-50, "
        "TorchState, the port's launcher and driver)")
    t12 = time.monotonic()
    elastic = elastic_phase(torch, device, rehearsal)
    log(f"  phase 12 took {time.monotonic() - t12:.1f} s")

    log("phase 13: the serving request surface (checkpoint, warmup, "
        "logprobs, /score, streaming, grammars, a model roll)")
    t13 = time.monotonic()
    surface_launches, surface = surface_phase(torch, device, rehearsal,
                                              args.seed)
    log(f"  phase 13 took {time.monotonic() - t13:.1f} s")

    log("phase 14: the serving fleet (router over two endpoints, hedging, "
        "tracing, the fleet controller, preemption)")
    t14 = time.monotonic()
    fleet_launches, fleet = fleet_phase(torch, device, rehearsal, args.seed)
    log(f"  phase 14 took {time.monotonic() - t14:.1f} s")

    log("phase 15: the tiered KV hierarchy (host tier, fleet tier, "
        "migration, swap) and sequence-parallel prefill")
    t15 = time.monotonic()
    tier_launches, tiering = tier_phase(torch, device, rehearsal, args.seed)
    log(f"  phase 15 took {time.monotonic() - t15:.1f} s")

    log(f"total {time.monotonic() - t_start:.1f} s")
    if rehearsal:
        log("rehearsal ok (CPU, plain versions, no device numbers)")
        return 0
    print(card_tag())
    print(json.dumps({"collectives": collectives}))
    print(json.dumps({"adasum": dict(adasum_numbers, card=card_tag())}))
    print(json.dumps({"eager": dict(eager_numbers, card=card_tag())}))
    print(json.dumps({"moe": dict(moe_numbers, card=card_tag())}))
    print(json.dumps({"elastic": dict(elastic, card=card_tag())}))
    print(json.dumps({"serve_surface": surface}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"tiering": tiering}))
    kernels = []
    for name, source, launches, route, shape, what in (
            ("paged_attention", "paged_attention_decode_sm90.cu",
             decode_launches, "decode", "decode B=8 ctx=1024 f32",
             "decode B=8 H=12 Dh=64 BT=16 ctx=1024 f32 pool, cold L2"),
            ("paged_attention_prefill", "paged_attention_prefill_sm90.cu",
             prefill_launches, "prefill", "prefill C=64 f32",
             "prefill B=4 C=64 H=12 Dh=64 BT=16 f32 pool, causal, cold L2")):
        r = rec[shape]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + source,
            "replaces": "horovod_tpu/serve/paged_attention.py:156",
            # Phase 4's drives, phase 13's (host-mode decode rows,
            # /score, warmup, the roll), phase 14's (the fleet behind
            # the router, its controller and preemption) and phase 15's
            # (swapped-in, migrated and handed-off blocks), each counted
            # from 0.
            "launches": (launches + surface_launches[route]
                         + fleet_launches[route] + tier_launches[route]),
            "launches_by_phase": {"serving": launches,
                                  "request_surface":
                                      surface_launches[route],
                                  "fleet": fleet_launches[route],
                                  "tiering": tier_launches[route]},
            "max_abs_err": rec["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": what})
    replaces = {"flash_fwd": "horovod_tpu/parallel/flash.py:125",
                "flash_bwd_dq": "horovod_tpu/parallel/flash.py:158",
                "flash_bwd_dkv": "horovod_tpu/parallel/flash.py:195"}
    for name, where in replaces.items():
        r = frec["bert-large"][name]
        # The bench shape is bf16: each kernel runs its wgmma instance.
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + (
                "flash_attention_fwd_sm90.cu" if name == "flash_fwd"
                else "flash_attention_bwd_sm90.cu"),
            "replaces": where,
            # Launches from BERT-large's bf16 training path (phase 5).
            "launches": flash_launches[name + "_wgmma"],
            "max_abs_err": frec["max_abs_err"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "BERT-large bench [32, 128, 16, 64] bf16, no mask, "
                     "cold L2"})
    for name, where in replaces.items():
        r = frec["gpt2-medium"][name]
        # The same wgmma kernels on GPT-2-medium's path (phase 8): its
        # launches, and the error and times at its shape.
        kernels.append({
            "name": name + "_gpt2_medium", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + (
                "flash_attention_fwd_sm90.cu" if name == "flash_fwd"
                else "flash_attention_bwd_sm90.cu"),
            "replaces": where,
            "launches": adasum_launches[name + "_wgmma"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "GPT-2 medium [4, 128, 16, 64] bf16, causal, cold L2; "
                     "launches: phase 8's Adasum training"})
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = frec["gpt2-small f32"][name]
        # The f32 instance: launches from phase 5's f32 step, the only
        # path that runs it.
        kernels.append({
            "name": name + "_f32", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + (
                "flash_attention_fwd_tf32_sm90.cu" if name == "flash_fwd"
                else "flash_attention_bwd_tf32_sm90.cu"),
            "replaces": replaces[name],
            "launches": f32_launches[name + "_tf32x3"],
            "max_abs_err": frec["max_abs_err_f32"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "GPT-2 small [4, 1024, 12, 64] f32, causal, cold L2; "
                     "launches: the f32 step of phase 5"})
    for name, where in replaces.items():
        r = frec["gpt2-small"][name]
        # The same wgmma kernels on phase 9's GPT-2-small path, apart
        # from phase 5's counts: its launches, the error and times at
        # its shape.
        kernels.append({
            "name": name + "_gpt2_small", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + (
                "flash_attention_fwd_sm90.cu" if name == "flash_fwd"
                else "flash_attention_bwd_sm90.cu"),
            "replaces": where,
            "launches": eager_launches[name + "_wgmma"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "GPT-2 small [4, 1024, 12, 64] bf16, causal, cold L2; "
                     "launches: phase 9's 3 steps under the timeline"})
    from horovod_tpu_torch.parallel import flash as fl
    recs = seqpar["records"]

    def numbers(r):
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        # The ring's hops (phase 10): f32 partials from bf16 models, so
        # the 3xTF32 route.  Launches: (a)'s two steps, the main path,
        # all CAUSAL at n = 1; the numbers at (a)'s hop shape; beside
        # them each mode at the hop shapes of 2 and 4 cards, and (b)'s
        # launches over 4 virtual shards.
        r = recs["ring hop n=1"][name]
        kernels.append(dict(
            {"name": f"{name}_ring_hop", "route": "cuda",
             "source": "horovod_tpu_torch/csrc/" + (
                 "flash_attention_fwd_tf32_sm90.cu" if name == "flash_fwd"
                 else "flash_attention_bwd_tf32_sm90.cu"),
             "replaces": replaces[name],
             "launches": seqpar["ring_launches"][name + "_tf32x3"]},
            **numbers(r),
            launches_by_mode=seqpar["ring_by_mode"][name],
            virtual_shard_launches_by_mode=seqpar["virtual_launches"][name],
            hop_shapes={
                f"{cards} {list(seqpar['hop_shapes'][cards])} {m}":
                    numbers(recs[f"ring hop {cards} {m}"][name])
                for cards in ("2 cards", "4 cards") for m in fl.MODE_NAMES},
            shape="ring n = 1 hop [1, 8192, 12, 64] f32, causal, cold L2; "
                  "launches: phase 10 (a)'s 2 steps; hop_shapes: strict "
                  "against SDPA with a boolean mask, row 0 undefined there"))
        r = recs["ulysses n=1"][name]
        kernels.append(dict(
            {"name": name + "_ulysses", "route": "cuda",
             "source": "horovod_tpu_torch/csrc/" + (
                 "flash_attention_fwd_sm90.cu" if name == "flash_fwd"
                 else "flash_attention_bwd_sm90.cu"),
             "replaces": replaces[name],
             "launches": seqpar["ulysses_launches"][name + "_wgmma"]},
            **numbers(r),
            shard_shapes={
                f"{cards} {list(seqpar['ulysses_shapes'][cards])} causal":
                    numbers(recs[f"ulysses {cards}"][name])
                for cards in ("2 cards", "4 cards")},
            shape="Ulysses local [1, 8192, 12, 64] bf16, causal, cold L2; "
                  "launches: phase 10 (c)'s 2 steps in a world of one"))
    for name, where in replaces.items():
        r = frec["gpt2-small"][name]
        # The same wgmma kernels on phase 11 (a)'s MoE GPT-2 small, whose
        # attention has phase 5's GPT-2 shape: its launches, and the
        # error and times of phase 3's timing at that shape.
        kernels.append({
            "name": name + "_moe", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/" + (
                "flash_attention_fwd_sm90.cu" if name == "flash_fwd"
                else "flash_attention_bwd_sm90.cu"),
            "replaces": where,
            "launches": moe_launches[name + "_wgmma"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": "GPT-2 small [4, 1024, 12, 64] bf16, causal, cold L2 "
                     "(phase 3's timing); launches: phase 11 (a)'s 2 MoE "
                     "steps"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

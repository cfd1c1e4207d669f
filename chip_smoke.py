#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``horovod_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from the checkout's sources (nvcc, sm_90a) and
   print ptxas's register / shared-memory report;
2. hold every kernel against its plain PyTorch version on the card, at
   the serving path's shapes (gpt2-small: H=12, Dh=64, BT=16; decode
   B=8 with contexts up to 1024, prefill chunks of C=64) and at the
   tiny test shapes, for every mask mode and pool type (f32, bf16,
   int8, fp8) and with all-hole rows; time the kernel, its plain
   version and the library yardstick (SDPA over the gathered K/V) with
   CUDA events;
3. drive the main path: the port's HTTP server, in process, serving
   gpt2-small at full width and depth with random weights from a fixed
   seed, f32, ``attn_impl`` auto; check identical prompts give
   identical tokens, batched == single, /healthz reports the kernel and
   paged KV, the kernel launch counter covers every layer of every
   prefill chunk and decode step, and an ``attn_impl="gather"`` engine
   on the card gives the same tokens;
4. print the card's name and power limit, one JSON line describing every
   ported kernel, and as the last line ``{"ok": true, "device": ...}``.

It imports nothing of JAX.  Without a CUDA device it exits non-zero and
prints no result.  ``--device cpu`` rehearses the same phases at a tiny
size through the plain versions (no build, no device numbers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound: HBM bytes/s
# and f32 FMA-pipe flop/s (the kernel computes in f32 off the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
RTOL, ATOL = 2e-4, 2e-5   # the JAX package's paged-attention tolerance


def log(msg: str) -> None:
    print(msg, flush=True)


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
    for dh in (32, 128):
        specs.append((f"prefill Dh={dh}", dict(H=4, Dh=dh, BT=32), 2, 20,
                      [0, 50], "f32", (), (0, 1, 2), "f32"))
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
            got = run_case(pa, case, mask, use_kernel=True)
            if not rehearsal:
                torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
            for b in holes:
                ok = ok and float(got[b].abs().max()) == 0.0
            log(f"  {name} mask={mask}: max_abs_err {err:.3e} "
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
                 "prefill C=64 f32", "decode B=8 ctx=1024 bf16",
                 "decode B=8 ctx=1024 int8", "decode B=8 ctx=1024 fp8"):
        case, mask, iters = cases[name], 1, 50
        nbytes, flops = live_work(case, mask, main["H"], main["Dh"])
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) \
            * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / F32_FLOPS_PER_S else "operations")
        ms = time_ms(torch, lambda: run_case(pa, case, mask, True), iters,
                     flush)
        plain_ms = time_ms(torch, lambda: run_case(pa, case, mask, False),
                           iters // 5, flush)
        sq, sk, sv, smask = sdpa_inputs(torch, pa, case, mask)
        lib_ms = time_ms(torch, lambda: sdpa(sq, sk, sv, attn_mask=smask),
                         iters, flush)
        record[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": nbytes, "flops": flops}
        log(f"  timing {name} (cold L2): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa on gathered f32 K/V {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} "
            f"flop), roofline share {bound_ms / ms:.3f}")
    del flush
    return record


# ---------------------------------------------------------------------------
# Phase 3: the main path
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


def main_path(torch, device, rehearsal, seed):
    from horovod_tpu_torch.models import TransformerConfig, create_gpt2
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      init_gpt2_)
    from horovod_tpu_torch.serve import (InferenceEngine, ServeServer,
                                         TransformerAdapter, build_replicas)
    from horovod_tpu_torch.serve import paged_attention as pa

    if rehearsal:
        cfg = TransformerConfig(vocab_size=61, num_layers=2, num_heads=2,
                                d_model=32, d_ff=64, max_len=64)
        model = init_gpt2_(Transformer(cfg, device=device),
                           torch.Generator(device=device).manual_seed(seed))
        lens, long_len, max_new = (3, 8, 9, 16), 40, 6
    else:
        model = create_gpt2("small", device=device, seed=seed)
        cfg = model.cfg
        lens, long_len, max_new = (5, 16, 17, 32), 900, 16
    log(f"  model: {cfg.num_layers} layers x d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, max_len "
        f"{cfg.max_len}, f32, random weights from seed {seed}")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in lens + (long_len,)]
    sched = build_replicas(
        lambda: TransformerAdapter(cfg, model, device=device),
        num_replicas=1, max_batch=8, prefill_chunk=64)
    eng = sched.replicas[0].engine
    server = ServeServer(sched)
    port = server.start(port=0, host="127.0.0.1")
    try:
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        # The launch count covers exactly the main path's run.
        pa.LAUNCHES["paged_attention"] = 0
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
        launches = pa.LAUNCHES["paged_attention"]
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
    expected = cfg.num_layers * (steps + prefills)
    log(f"  decode steps {steps}, prefill chunks {prefills}, kernel "
        f"launches {launches} (num_layers x (steps + chunks) = {expected})")
    if not rehearsal and launches < expected:
        failures.append(f"kernel launched {launches} times, the path needed "
                        f">= {expected}")
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
    return launches


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
        log(f"  built {path} in {time.monotonic() - t0:.1f} s")
        for line in build_log.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "bytes smem" in line
                                         or "Compiling" in line):
                log("  " + line.strip())

    log("phase 2: kernel against its plain version")
    rec = kernel_phase(torch, pa, device, rehearsal)

    log("phase 3: main path (HTTP server, GPT-2)")
    launches = main_path(torch, device, rehearsal, args.seed)

    log(f"total {time.monotonic() - t_start:.1f} s")
    if rehearsal:
        log("rehearsal ok (CPU, plain versions, no device numbers)")
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    dec = rec["decode B=8 ctx=1024 f32"]
    print(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_attention.cu",
        "replaces": "horovod_tpu/serve/paged_attention.py:156",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode B=8 H=12 Dh=64 BT=16 ctx=1024 f32 pool, cold L2",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

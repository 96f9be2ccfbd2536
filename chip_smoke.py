"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device  - CUDA present; the card's name and power limit (nvidia-smi).
  2. build   - nvcc builds the kernels from src/repro_torch/kernels/csrc.
  3. kernel  - each hand-written kernel against its plain PyTorch version
               on the card, with its time, the plain version's time and the
               least time the card could take for the same work.
  4. small   - the reduced granite config in fp32: the engine on the card
               (kernel path) emits the same greedy tokens as on the CPU
               (plain path), for fp32 and int8 KV.
  5. serve   - the main path: full-width granite-3-2b in bf16 (random
               weights from a seed) served through CarbonAwareScheduler ->
               paged InferenceEngine -> CUDA paged attention, with launch
               counts read around the run; then again with int8 KV.
The last lines are the nvidia-smi line, one JSON object describing every
kernel, and {"ok": true, "device": {...}}.
"""
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
            torch.float32: 67e12}            # fp32 outside the tensor cores
TOL = {"bf16": 2e-2, "f32": 2e-5, "int8": 2e-2}
PROMPTS = [
    "Summarize today's carbon intensity forecast for the western grid.",
    "What is a generation directive?",
    "Explain paged attention to a new engineer.",
    "List three ways to make LLM inference greener.",
    "Why do brief answers cost less energy?",
    "Write a haiku about solar power at noon.",
    "How does a KV cache grow during decoding?",
    "Translate 'low-carbon electricity' into French.",
    "What limits decode speed on a GPU?",
    "Give one sentence on wind power variability.",
    "Define grams of CO2 per kilowatt-hour.",
    "Name a benefit of continuous batching.",
]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device milliseconds per call, by CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 3: kernel against its plain version
# ----------------------------------------------------------------------

def paged_case(gen, B, H, KVH, D, page, P, max_pages, lengths, kind):
    """Inputs of one paged-attention call; ``copies`` page stores rotate so
    repeated launches find the cache cold, as a decode step does (each
    layer reads its own store)."""
    from repro_torch.models.attention import quantize_kv
    dev = "cuda"
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    store_bytes = P * page * KVH * D * 2 * (1 if kind == "int8" else dt.itemsize)
    copies = min(16, max(2, math.ceil(128e6 / store_bytes)))
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dt)
    stores = []
    for _ in range(copies):
        k = torch.randn(P, page, KVH, D, generator=gen, device=dev)
        v = torch.randn(P, page, KVH, D, generator=gen, device=dev)
        if kind == "int8":
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            stores.append((kq, vq, ks, vs))
        else:
            stores.append((k.to(dt), v.to(dt), None, None))
    bt = torch.full((B, max_pages), -1, dtype=torch.int32)
    for b, L in enumerate(lengths):
        n = -(-L // page)
        bt[b, :n] = torch.randperm(P, generator=torch.Generator().manual_seed(b))[:n]
    ln = torch.tensor(lengths, dtype=torch.int32)
    return q, stores, bt.to(dev), ln.to(dev)


def paged_bound(q, lengths, KVH, D, page, kind):
    """Least time for the function on these inputs: the bytes it must move
    (q and out once, each live K/V element and scale once, the table
    entries and lengths it reads) over HBM bandwidth, against its flops."""
    toks = sum(lengths)
    kv_item = 1 if kind == "int8" else q.element_size()
    nbytes = (2 * q.numel() * q.element_size()
              + toks * KVH * D * 2 * kv_item
              + (toks * KVH * 2 * 4 if kind == "int8" else 0)
              + sum(-(-L // page) for L in lengths) * 4 + len(lengths) * 4)
    flops = 4 * q.shape[1] * D * toks
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        # the main path's geometry: 8 slots, granite heads, page 32, the
        # engine's store (256 pages + trash) and table width (max_len 1024)
        "main B=8": (8, 32, 8, 64, 32, 257, 32, [1, 31, 32, 33, 200, 512, 900, 1023]),
        "granite B=1": (1, 32, 8, 64, 32, 512, 64, [2000]),
        "granite B=8": (8, 32, 8, 64, 32, 512, 64, [1, 31, 32, 33, 257, 640, 1500, 2000]),
        "reduced B=8": (8, 4, 2, 16, 16, 96, 13, [1, 15, 16, 17, 40, 64, 100, 200]),
    }
    rows = {}
    for name, (B, H, KVH, D, page, P, max_pages, lengths) in shapes.items():
        for kind in ("bf16", "f32", "int8"):
            q, stores, bt, ln = paged_case(gen, B, H, KVH, D, page, P,
                                           max_pages, lengths, kind)
            err = 0.0
            for k, v, ks, vs in stores[:2]:
                got = paged_attention(q, k, v, bt, ln, ks, vs)
                want = ref.paged_attention_ref(q, k, v, bt, ln, ks, vs)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == q.dtype,
                      f"{name} {kind}: output {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"{name} {kind}: non-finite")
                err = max(err, (got.float() - want.float()).abs().max().item())
            check(err <= TOL[kind], f"{name} {kind}: max abs err {err} > {TOL[kind]}")
            cycle = itertools.cycle(stores)

            def run(fn):
                k, v, ks, vs = next(cycle)
                return fn(q, k, v, bt, ln, ks, vs)

            ms = cuda_ms(lambda: run(paged_attention))
            plain_ms = cuda_ms(lambda: run(ref.paged_attention_ref), iters=10)
            bound_ms, bound_by = paged_bound(q, lengths, KVH, D, page, kind)
            rows[(name, kind)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel paged_attention {name:12s} {kind:4s} lengths={lengths} "
                  f"err={err:.3e} (tol {TOL[kind]}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.5f} ({bound_by}) share={bound_ms / ms:.3f}")
    return rows


# ----------------------------------------------------------------------
# phases 4 and 5: the serving path
# ----------------------------------------------------------------------

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def small_phase():
    """Reduced granite, fp32: card (kernel) and CPU (plain) engines agree."""
    from repro_torch.configs import reduced
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    cpu_params = MD.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    tok = ByteTokenizer()
    for kv_int8 in (False, True):
        streams = []
        for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
            eng = InferenceEngine(cfg, params, n_slots=4, max_len=128,
                                  paged=True, page_size=16, decode_block=4,
                                  kv_int8=kv_int8, device=dev)
            for p in PROMPTS[:6]:
                eng.submit(tok.encode(p, bos=True), max_new_tokens=24)
            eng.run_to_completion()
            streams.append({f.rid: f.token_ids for f in eng.finished})
        check(len(streams[0]) == 6 and streams[0] == streams[1],
              f"reduced kv_int8={kv_int8}: card and CPU token streams differ")
        print(f"small reduced-granite fp32 kv_int8={kv_int8}: card == CPU greedy "
              f"tokens for {len(streams[0])} requests "
              f"({sum(map(len, streams[0].values()))} tokens)")


def profile_block(eng, label):
    """Where a decode step's time goes: one decode block of 8 live lanes
    timed bare, then once more under torch.profiler, whose kernel events
    give the device time (the rest of the block's wall time the device
    sits idle, waiting on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(eng.n_slots):
        eng.submit([1 + (7 * i + j) % 250 for j in range(100)], max_new_tokens=40)
    eng.step()                                 # prefill + first block

    def block_ms():
        torch.cuda.synchronize()
        steps0, t0 = eng.steps, time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / (eng.steps - steps0), eng.steps - steps0

    bare_ms, _ = block_ms()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, k = block_ms()
    check(int(eng.live.sum()) == eng.n_slots, "profiled block lost a lane")
    eng.run_to_completion()
    eng.finished = []
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / k
    paged_ms = sum(e.self_device_time_total for e in kern
                   if "paged_attention" in e.key) / 1e3 / k
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"profile {label}: decode block of {eng.n_slots} lanes x {k} steps: wall "
          f"{bare_ms:.2f} ms/step bare, {prof_ms:.2f} under the profiler; device "
          f"kernel time {dev_ms:.3f} ms/step (busy share {dev_ms / bare_ms:.3f} of the "
          f"bare wall); paged_attention {paged_ms:.3f} ms/step; top kernels: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3 / k:.3f} ms x{e.count / k:g}"
              for e in top))


def serve(cfg, params, kv_int8, kernel, plain_calls):
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
    eng = InferenceEngine(cfg, params, n_slots=8, max_len=1024, paged=True,
                          page_size=32, decode_block=8, kv_int8=kv_int8,
                          device="cuda")
    eng.submit(list(range(1, 40)), max_new_tokens=8)     # warm-up request
    eng.run_to_completion()
    eng.finished = []
    # uniform directive mix, as the serving launcher draws before the LP
    # has level profiles
    rng = np.random.default_rng(0)
    sched = CarbonAwareScheduler([eng], level_fn=lambda: int(rng.choice(3)))
    for p in PROMPTS:
        sched.submit(ServeRequest(0, p, max_new_tokens=64,
                                  max_new_by_level=(64, 48, 32)))
    steps0, tokens0 = eng.steps, eng.decode_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    plain_calls[0] = 0
    t0 = time.monotonic()
    sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain = kernel.launches, plain_calls[0]
    steps = eng.steps - steps0
    fin = sched.finished
    check(not sched.rejected, f"rejected: {sched.rejected}")
    check(len(fin) == len(PROMPTS), f"{len(fin)} of {len(PROMPTS)} finished")
    check(all(0 <= t < cfg.vocab_size for f in fin for t in f.token_ids),
          "token outside the vocabulary")
    check(all(f.gen_tokens >= 1 for f in fin), "a request generated nothing")
    levels = sorted({f.directive_level for f in fin})
    check(levels == [0, 1, 2], f"directive levels {levels}")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} x {steps} decode steps")
    check(plain == 0, f"plain paged attention called {plain} times on the card")
    decode_s = sum(f.decode_s for f in fin)
    dec_tokens = eng.decode_tokens - tokens0
    kv = eng.kv_stats()
    print(f"serve granite-3-2b bf16 kv_int8={kv_int8}: {len(fin)} requests, levels "
          f"{[f.directive_level for f in fin]}, gen tokens {[f.gen_tokens for f in fin]}; "
          f"decode steps {steps}, kernel launches {launches} (= {cfg.n_layers} x steps), "
          f"plain calls {plain}; decode tokens {dec_tokens} in {decode_s:.3f} s = "
          f"{dec_tokens / decode_s:.1f} tok/s; wall {wall:.3f} s "
          f"({sum(f.gen_tokens for f in fin) / wall:.1f} gen tok/s); peak pages "
          f"{kv['peak_pages_in_use']} of {kv['n_pages']} "
          f"({kv['peak_kv_bytes_in_use'] / 2**20:.1f} MiB KV); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_block(eng, f"granite-3-2b bf16 kv_int8={kv_int8}")
    return launches


def serve_phase():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import model as MD
    cfg = get_config("granite_3_2b")
    t0 = time.monotonic()
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    print(f"serve granite-3-2b: {MD.param_count(params) / 1e9:.3f} B params, "
          f"{MD.param_bytes(params) / 2**30:.2f} GiB weights in {cfg.dtype} "
          f"(init {time.monotonic() - t0:.1f} s)")
    # full-width forward: finite logits of the expected shape
    toks = torch.arange(1, 17, device="cuda")[None]
    logits = MD.forward(cfg, params, toks, mode="prefill")
    check(tuple(logits.shape) == (1, 16, cfg.vocab_size), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    # count calls of the plain version: the main path must never take it
    plain_calls = [0]
    plain_fn = ref.paged_attention_ref

    def counted(*a, **kw):
        plain_calls[0] += 1
        return plain_fn(*a, **kw)

    ref.paged_attention_ref = counted
    try:
        launches = serve(cfg, params, False, paged_attention, plain_calls)
        serve(cfg, params, True, paged_attention, plain_calls)
    finally:
        ref.paged_attention_ref = plain_fn
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    log = build.build()
    build.load()
    print(f"build: {time.monotonic() - t0:.1f} s -> {build.library_path().name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")
    rows = kernel_phase()
    small_phase()
    launches = serve_phase()
    main_row = rows[("main B=8", "bf16")]
    kernels = [dict(name="paged_attention", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:78",
                    launches=launches, max_abs_err=main_row["max_abs_err"],
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                    library_ms=None)]
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

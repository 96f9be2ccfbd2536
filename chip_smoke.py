"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device  - CUDA present; the card's name and power limit (nvidia-smi).
  2. build   - nvcc builds the kernels from src/repro_torch/kernels/csrc;
               ptxas's registers, shared memory and spills per kernel, and
               the count of tensor-core (HMMA) instructions in the SASS of
               the bf16 flash kernels (cuobjdump, where the toolkit has it);
               the flash instantiations at head_dim 128 on lines of their
               own.
  3. kernel  - each hand-written kernel (paged attention, fused RMSNorm,
               flash-attention prefill) against its plain PyTorch version
               on the card, with its time, the plain version's time, the
               least time the card could take for the same work, and the
               time of the one PyTorch call that computes the same
               function, where there is one (timed only, never on a path);
               for paged attention also the host's cost of issuing a call.
               Granite's shapes, and Llama 2's: flash at head_dim 128,
               RMSNorm at d 4096 and 5120 (and minicpm's 2304), paged
               attention at llama2-13b's 40 heads of 128. bf16 flash
               outputs are held to one bf16 ulp of the output scale (and
               2e-2) on under 1 % of the outputs (fp32 P·V). A poisoned
               slot through the paged kernel at llama2-13b's heads (its
               pages NaN in bf16, its scales NaN in int8; at one split and
               at several): that slot's outputs all non-finite, every other
               slot bit-equal to the clean call, the plain version
               non-finite in the same rows.
  4. sampler - jax's threefry key stream (``serving/prng.py``) and the
               sampler on the card against jax.random's known answers:
               threefry2x32(0, 0), split, fold_in, bits, uniform, and
               sample_logits_batched and sample_temperature_only with and
               without fold_ids; every word, bit and token equal.
  5. small   - the reduced llama2-13b (untied embeddings) and granite
               configs in fp32 (vocab 512): the engine on the card (kernel
               path) emits the same greedy tokens as on the CPU (plain
               path), whole-prompt and with chunked prefill (chunk 8), and
               chunked gives the same tokens as whole-prompt; for fp32 and
               int8 KV. Then the radix prefix cache: eight requests with
               Sprout's directive system prompts at their head (and a
               page-aligned prompt twice, the one copy-on-write), prefix
               cache on and off, fp32 and int8 KV: card and CPU give the
               same tokens and block tables, hits skip prefill, the ledger
               is clean at drain, and in fp32 prefix-on gives prefix-off's
               tokens. Then seeded sampled decoding (fp32): requests cycle
               greedy, temperature-only and top-k/top-p, whole-prompt
               (buckets under the 4 slots, rows folded by slot id), chunked
               (first tokens drawn in the mixed entry), with the prefix
               cache, and greedy and temperature-only alone (chunked, so
               decode and mixed _temp entries run); card and CPU give the
               same tokens, tables and entries. Then the dense layout (no
               ``paged``, the reference's default engine; 4 slots of 128
               rows): fp32 and int8 KV, whole-prompt and chunked (chunk 8),
               blocks in buckets under the 4 slots, and one sampled
               chunked drive; card and CPU give the same tokens and entry
               names, and the card's store holds the CPU's kpos on every
               slot row and K/V within 1e-5 where kpos is valid (int8:
               codes at most one apart, on under 1e-3 of them). Then lane
               poison and recovery (``small_faults``): eight requests
               through CarbonAwareScheduler with decode.nonfinite armed at
               two lanes, on dense (whole-prompt, chunked), paged (fp32,
               int8) and prefix-cache engines (one poisoned lane maps
               adopted pages); every request served, every fill lane-only,
               nothing non-finite left, the card quarantining exactly the
               poisoned lanes and giving the CPU's tokens (dense: the
               CPU's quarantines and store too). Then Sprout's chaos
               scenario (``serving/chaos.py``) on the card: every
               invariant, report and digest equal to the CPU's.
  6. static  - the port's static checks (``repro_torch.analysis``): its
               lint of this tree (no new finding, no stale baseline entry,
               the two budgeted copies), and its graph audit on the card
               (reduced granite engines of four variants, every entry a
               CUDA graph whose eager callable runs under an op watch on
               its dead inputs and its live staging: no float64, no host
               read, the store written in place, store writes in bounds;
               0 issues, the names equal to the committed inventory).
               Inside the serve phase, every entry of the llama2-13b
               engines goes through the same checks after its engine's
               measured drive (an entry two engines of one layout and KV
               dtype share, the same program at the same shapes, once),
               and the capture drives of the paged and the dense
               bf16 runs count the card's syncs under
               torch.cuda.set_sync_debug_mode("warn"): exactly one a
               decode block and one a prefill group, at the engine's two
               sanctioned copies, and so must the fault drives' syncs at
               the port's lines (their poisons and scrubs add none). The
               phase's seconds are printed on the last lines.
  7. serve   - the main path: full-width llama2-13b, the paper's model, in
               bf16 (random weights from a seed; each model's weights are
               freed before the next is drawn) served through
               CarbonAwareScheduler ->
               paged InferenceEngine -> its entry points, each a CUDA graph
               captured at first use and replayed after -> CUDA kernels
               (RMSNorm in every forward pass, flash attention in every
               whole-prompt prefill group, paged attention in every decode
               step on a paged engine), three times: bf16 KV, int8 KV, and
               bf16 KV with
               chunked prefill (chunk 48, so chunks straddle the 32-token
               pages); then twice more with sampled traffic (a third of the
               requests greedy, a third temperature 0.8, a third the
               reference bench's temperature 0.9 / top_k 50 / top_p 0.95),
               bf16 KV whole-prompt and chunked 48; then twice on a dense
               engine (the reference's default layout; 8 slots of 1024
               rows), bf16 KV whole-prompt and chunked 48, where paged
               attention must launch 0 times (dense decode attention is the
               reference's plain _sdpa), a bucketed block (3 lanes of 8)
               and, chunked, a mixed block run graph against eager, the
               share of streams equal to the paged run's printed (not
               gated: bf16 _sdpa rounds scores, the paged kernel does not),
               one middle layer's decode attention on the served store
               held to an fp32 computation of it (gated), and the dense
               attention of a step timed alone against its
               bound (every K/V byte of 8 rows of 1024 over 3.35 TB/s);
               then one bf16 run each of full-width llama2-7b,
               minicpm-2b and granite-3-2b (GQA groups of 4), each after a
               full-width forward pass (finite logits of the vocabulary's
               width). Each run drives its traffic once to build the entry
               table, then again with the table frozen (its names are
               snapshotted before and after, and must not change; both
               drives start from the engine's seed key and must give
               identical streams), so decode tokens/s comes from replayed
               dispatches only. No
               plain version may run in the building drive, where every
               wrapper call of a capture runs. Around the measured drive
               the launch counts are zeroed and read, and checked against
               the engine's forward passes. A replay advances them by the
               calls recorded at capture, so they are also held to what the
               card ran: every entry's graph is read back (its debug dump,
               one record a kernel node) and must hold as many nodes of
               each kernel as a replay counts, and the drive's replays,
               counted entry by entry, times those nodes must equal the
               counters. Each run prints its entry count, capture count
               and time and graph pool size. One block of each run and one
               prefill group (8 x 128) are profiled: host wall, device
               kernel time (torch.profiler), the kernels the replay ran
               (held to the counters and the forward passes; the
               profiler's kernel events may fall short of them, never
               above) and the span of the one replay (CUDA events), which
               may not exceed the wall. The sampled bf16 run profiles
               instead decode_bs8_k8_{greedy,temp,full} in turns (ms a step,
               wall and replay span, the sampler's share against greedy and
               its graph nodes a step) after a _full block runs graph
               against eager; the sampled chunked run runs a mixed _full
               block graph against eager; the prefill profile times the
               group's draw alone and the host key's split. Each model's
               peak device memory and
               wall seconds are printed. llama2-13b also serves the same
               traffic on a prefix-cache engine: a cold drive and a warm one
               build the entries, a second warm drive is measured with the
               table frozen (launches held as above), each drive's cached
               prefill tokens, adopted pages, copies and evictions printed,
               the ledger clean at drain, and the share of streams identical
               to the bf16 run's printed beside the chunked run's (bf16: a
               hit's suffix, like a chunk, is computed by the chunk pass,
               not by flash, so a near-tie may part). The paged bf16, paged
               int8 and dense bf16 runs of llama2-13b then drive the
               traffic once more with decode.nonfinite armed at lanes 0
               and 5 (``fault_drive``): the verdict quarantines exactly
               the poisoned lanes, every request is served, each poison
               and scrub writes only its lane (its pages or row read NaN,
               then 0, in every float leaf; everything else byte-equal),
               nothing non-finite is left, launches are held as above;
               poison and scrub times printed.
  8. graphs  - inside each run's profile, one block (a decode block; a mixed
               block in the chunked runs, greedy and sampled) is run
               twice from one state: the
               entry's eager callable, then, with the page store and the
               static inputs restored, the graph's replay. Tokens, validity
               and live mask must be identical and the page store equal
               byte for byte outside the write-only trash page; the host
               wall of each is printed. The prefix-cache run does this for
               the block that follows a copy-on-write.
  9. gateway - Sprout's control plane over llama2-13b's weights: SproutGateway
               with two regional pools (CA, TX; watchdog-wrapped June
               traces), one full-width engine each (8 slots, max_len 1024,
               EOS off, so budgets bound every request), the directive LP
               re-planned per pool every hour, the evaluator's q installed
               before each hour, and 4 hours of 12 workload requests with
               per-level budgets, routed green under a load cap of 8. Drive
               A builds the entry tables; drive B, a fresh gateway with the
               same seeds on the same engines, is measured with the tables
               frozen, and must finish the same tokens, levels and pools
               with the same hourly mixes and carbon (no decision reads
               wall time). Both: every request served, none rejected, each
               mix a distribution, each plan on its Eq. 3 floor, the carbon
               ledger balanced. B's launches are held to both engines'
               forward passes and to its replays' kernel nodes; no plain
               version runs in A or B. Prints each hour's intensity, mix,
               routes and carbon, each pool's decode tokens/s, and B's
               requests re-priced on the H100 (J per generated token,
               mgCO2 per request) for the served model (its parameter count
               and KV bytes a token) from the model's power times measured
               decode seconds and from the roofline, beside the reference's
               own accounting, which prices the same model (LLAMA2_13B).
 10. cli     - the port's serving entry point, `main` of
               repro_torch.launch.serve (what `python -m
               repro_torch.launch.serve --gateway --paged ...` runs), in this
               process: no --arch, so the default llama2-13b, drawn anew
               after the serve phase's weights are freed, with
               --prefix-cache; three hours of 12 requests over CA and TX at
               full width, one line an hour, 0 rejected, a solved plan in
               the last hour, prefill served from cached pages; then once
               more without --paged (and --prefix-cache): dense engines,
               as the CLI serves by default. Each run's launches are
               zeroed before and read after, and held to its engines'
               forward passes (paged attention 0 on dense engines) and to
               the kernel nodes its replays ran; no plain version may run.
               Then both with ``--chaos --migrate`` in place of
               ``--prefix-cache`` (the reference's default fault script:
               one fault of every class against CA): the chaos line
               printed, at least one fault recovered, nothing stranded.
The last lines are the nvidia-smi line, one JSON object describing every
kernel, and {"ok": true, "device": {...}}.
"""
import contextlib
import gc
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
            torch.float32: 67e12}            # fp32 outside the tensor cores
TOL = {"bf16": 2e-2, "f32": 2e-5, "int8": 2e-2}
SEED = 0                                     # every serve engine's PRNG seed
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


def bf16_ulp(x):
    """One bf16 ulp at magnitude x: 2^(e - 7) for x in [2^e, 2^(e + 1))."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8) if x > 0 else 0.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters=30, warmup=3, graph=True):
    """Mean device milliseconds per call, by CUDA events around ``iters``
    calls. With ``graph`` the calls are captured in one CUDA graph and
    replayed, so the host's cost of issuing each call (tens of
    microseconds through a Python wrapper) does not hide a short kernel's
    device time; without it they are issued eagerly, one by one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def issue_us(fn, calls=300, warmup=3):
    """Host microseconds to issue one call: ``time.perf_counter`` around
    ``calls`` calls with no sync between them, so the device runs behind
    and only the wrapper's Python and launch work is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def paged_issue_us(names=("serve B=8", "main B=8"), kinds=("bf16", "int8")):
    """{(row, kind): host microseconds a paged-attention call takes to
    issue} for the ``repro_torch`` package first on ``sys.path``; so the
    same measurement runs against another checkout's wrapper with that
    checkout's ``src`` put first."""
    from repro_torch.kernels.paged_attention import paged_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name in names:
        B, H, KVH, D, page, P, max_pages, lengths = PAGED_SHAPES[name]
        for kind in kinds:
            q, stores, bt, ln = paged_case(gen, B, H, KVH, D, page, P, max_pages,
                                           lengths, kind)
            k, v, ks, vs = stores[0]
            out[(name, kind)] = issue_us(lambda: paged_attention(q, k, v, bt, ln, ks, vs))
    return out


def demangle(names):
    """C++ kernel symbols as ``name<template arguments>``, by c++filt where
    it exists (else as they are)."""
    exe = shutil.which("c++filt")
    if exe is None or not names:
        return list(names)
    out = subprocess.run([exe], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != len(names):
        return list(names)
    return [ln.split("(anonymous namespace)::", 1)[-1].split("(")[0] for ln in lines]


def ptxas_report(log):
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its name, its
    registers, barriers and shared memory, its stack and spills."""
    fns, facts = [], []
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fns.append(m.group(1))
            facts.append([])
        elif fns and ("registers" in line or "spill" in line):
            facts[-1].append(line.split(":", 1)[-1].strip())
    return [f"{name}: {'; '.join(f)}" for name, f in zip(demangle(fns), facts)]


def sass_hmma_counts(lib):
    """{kernel: HMMA instructions in its SASS} of the built library, by
    cuobjdump, or None where the toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    exe = shutil.which("cuobjdump")
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        exe = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    if exe is None:
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 3: kernel against its plain version
# ----------------------------------------------------------------------

# (B, H, KVH, D, page, P, max_pages, lengths) of each paged-attention row
MAIN_LENGTHS = [1, 31, 32, 33, 200, 512, 900, 1023]
PAGED_SHAPES = {
    # the main path's geometry: 8 slots, granite heads, page 32, the
    # engine's store (256 pages + trash) and table width (max_len 1024)
    "main B=8": (8, 32, 8, 64, 32, 257, 32, MAIN_LENGTHS),
    "granite B=1": (1, 32, 8, 64, 32, 512, 64, [2000]),
    "granite B=8": (8, 32, 8, 64, 32, 512, 64, [1, 31, 32, 33, 257, 640, 1500, 2000]),
    "reduced B=8": (8, 4, 2, 16, 16, 96, 13, [1, 15, 16, 17, 40, 64, 100, 200]),
    # the small phase's engine (4 slots, max_len 128, page 16, its 32 pages
    # + trash): one split, so the split kernel writes the output itself
    "reduced engine B=4": (4, 4, 2, 16, 16, 33, 8, [1, 17, 100, 128]),
    "llama2 B=8": (8, 32, 32, 128, 32, 257, 32, MAIN_LENGTHS),
    # llama2-13b's serve engine: 40 heads, one a KV head, D 128
    "llama2-13b B=8": (8, 40, 40, 128, 32, 257, 32, MAIN_LENGTHS),
    "g12 B=8": (8, 48, 4, 128, 32, 257, 32, MAIN_LENGTHS),
    "page128 B=8": (8, 32, 8, 64, 128, 65, 8, MAIN_LENGTHS),
    # the serve phase's decode contexts: prompts of 20-70 tokens with
    # their directive, plus up to 64 generated
    "serve B=8": (8, 32, 8, 64, 32, 257, 32, [60, 74, 88, 102, 116, 130, 145, 160]),
}


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
        n = min(-(-L // page), max_pages)
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


def paged_phase():
    """Paged attention at the main path's geometry, one long slot, longer
    tables, the reduced heads (also at the small phase's own engine, whose
    one split has no combine), the serve's own contexts, and the widths the
    kernel covers beyond granite: D 128 with one query head per KV head
    (Llama 2, at llama2-7b's and llama2-13b's head counts) and with groups
    of 12, and 128-token pages."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import _n_sm, paged_attention, split_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (B, H, KVH, D, page, P, max_pages, lengths) in PAGED_SHAPES.items():
        pps, n_splits = split_plan(B, KVH, max_pages, page, _n_sm(0))
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
            eager_ms = cuda_ms(lambda: run(paged_attention), graph=False)
            plain_ms = cuda_ms(lambda: run(ref.paged_attention_ref), iters=10)
            k, v, ks, vs = stores[0]
            host_us = issue_us(lambda: paged_attention(q, k, v, bt, ln, ks, vs))
            bound_ms, bound_by = paged_bound(q, lengths, KVH, D, page, kind)
            rows[(name, kind)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel paged_attention {name:12s} {kind:4s} B={B} H={H} KVH={KVH} D={D} "
                  f"page={page} n_splits={n_splits} (pages_per_split {pps}) lengths={lengths} "
                  f"err={err:.3e} (tol {TOL[kind]}) ms={ms:.4f} eager_ms={eager_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} issue_us={host_us:.1f} "
                  f"bound_ms={bound_ms:.5f} ({bound_by}) share={bound_ms / ms:.3f}")
    return rows


# (B, max_pages, lengths, poisoned slots) of the poisoned-slot checks at
# llama2-13b's heads (H = KVH 40, D 128, page 32, 257 pages): one split (a
# 4-page table), two splits (the main geometry) and seven (two slots)
POISON_SHAPES = {
    "one split": (8, 4, [1, 31, 32, 33, 64, 100, 127, 128], (3, 7)),
    "main": (8, 32, MAIN_LENGTHS, (3, 6)),
    "B=2": (2, 32, [900, 77], (0, 1)),
}


def paged_poison_phase():
    """A poisoned slot through the paged kernel at llama2-13b's heads, bf16
    and int8 KV, at one split and at several: slot b's pages (bf16: K and
    V; int8: the scales, as the engine's fill leaves codes alone) are NaN,
    and the tables of the slots map disjoint pages. Every output element of
    slot b must be non-finite, every other slot's bit-equal to the clean
    call's. The plain version must be non-finite in slot b, and also in
    every slot whose table has an unmapped entry when slot b holds page 0
    (it reads such entries clamped to page 0, as the reference's does; the
    kernel reads only a slot's pages below its length). Returns the checks'
    n_splits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import _n_sm, paged_attention, split_plan
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(2)
    H = KVH = 40
    D, page, P = 128, 32, 257
    out = []
    for name, (B, max_pages, lengths, poisoned) in POISON_SHAPES.items():
        n_splits = split_plan(B, KVH, max_pages, page, _n_sm(0))[1]
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
        bt = torch.full((B, max_pages), -1, dtype=torch.int32)
        used = 0
        for b, L in enumerate(lengths):
            n = -(-L // page)
            bt[b, :n] = perm[used:used + n]
            used += n
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        bt = bt.cuda()
        for kind in ("bf16", "int8"):
            q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn(P, page, KVH, D, generator=gen, device="cuda")
            v = torch.randn(P, page, KVH, D, generator=gen, device="cuda")
            if kind == "int8":
                (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            else:
                k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
            clean = paged_attention(q, k, v, bt, ln, ks, vs)
            for b in poisoned:
                pages = bt[b][bt[b] >= 0].long()
                leaves = (ks, vs) if kind == "int8" else (k, v)
                saved = [x[pages].clone() for x in leaves]
                for x in leaves:
                    x.index_fill_(0, pages, float("nan"))
                got = paged_attention(q, k, v, bt, ln, ks, vs)
                want = ref.paged_attention_ref(q, k, v, bt, ln, ks, vs)
                torch.cuda.synchronize()
                for x, old in zip(leaves, saved):
                    x[pages] = old
                label = f"paged poison {name} {kind} slot {b} (n_splits {n_splits})"
                others = torch.arange(B, device="cuda") != b
                check(not bool(torch.isfinite(got[b]).any()),
                      f"{label}: {int(torch.isfinite(got[b]).sum())} finite outputs "
                      "in the poisoned slot")
                check(torch.equal(got[others].view(torch.int16),
                                  clean[others].view(torch.int16)),
                      f"{label}: another slot's output moved")
                # the plain version (the reference's XLA path) reads every
                # unmapped entry clamped to page 0 at masked positions,
                # where 0 x NaN is NaN: if the slot holds page 0, each slot
                # with an unmapped entry goes non-finite there too
                bad_p = ~others
                if bool((pages == 0).any()):
                    bad_p = bad_p | (bt < 0).any(-1)
                rows_p = ~torch.isfinite(want).all(-1).all(-1)
                check(torch.equal(rows_p, bad_p), f"{label}: non-finite rows "
                      f"{rows_p.tolist()} in the plain version, {bad_p.tolist()} expected")
                out.append((name, kind, b, n_splits, lengths[b], int(bad_p.sum())))
    print(f"kernel paged_attention poisoned slots at llama2-13b's heads (H = KVH 40, D 128): "
          f"{len(out)} checks (shape, KV, slot, n_splits, its length, slots non-finite in "
          f"the plain version) {out}: each poisoned slot's outputs all non-finite, every "
          f"other slot bit-equal to the clean call; the plain version non-finite in the "
          f"poisoned slot, and in every slot with an unmapped entry where the poisoned "
          f"slot holds page 0")
    return sorted({row[3] for row in out})


def rmsnorm_phase():
    """Fused RMSNorm: decode (N 8), chunk-pass (N 48) and prefill (N 2048)
    rows at granite's d 2048, a ragged N, the reduced d 64; decode and
    prefill rows at llama2-13b's d 5120 (f32 there takes two vectors a
    thread) and llama2-7b's d 4096, and a decode row at minicpm-2b's d
    2304; bf16 and f32 (some rows bf16 only); with and without the
    residual."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import fused_rmsnorm, launch_shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    both = (("bf16", torch.bfloat16), ("f32", torch.float32))
    for name, N, d, kinds in (("decode N=8", 8, 2048, both),
                              ("chunk N=48", 48, 2048, both[:1]),
                              ("prefill N=2048", 2048, 2048, both),
                              ("ragged N=1000", 1000, 2048, both),
                              ("reduced N=8", 8, 64, both),
                              ("llama2-13b decode N=8", 8, 5120, both),
                              ("llama2-13b prefill N=2048", 2048, 5120, both),
                              ("llama2-7b decode N=8", 8, 4096, both[:1]),
                              ("llama2-7b prefill N=2048", 2048, 4096, both[:1]),
                              ("minicpm decode N=8", 8, 2304, both[:1])):
        for kind, dt in kinds:
            # input sets rotate past the 50 MB L2, so a timed call reads them
            # from HBM as the bound assumes (the smallest shapes stay cached)
            copies = min(16, max(2, math.ceil(128e6 / (2 * N * d * dt.itemsize))))
            sets = [(torch.randn(N, d, generator=gen, device="cuda").to(dt),
                     torch.randn(N, d, generator=gen, device="cuda").to(dt))
                    for _ in range(copies)]
            x, res = sets[0]
            scale = torch.rand(d, generator=gen, device="cuda") + 0.5
            for with_res in (True, False):
                residual = res if with_res else None
                cycle = itertools.cycle(sets)

                def run(fn, with_res=with_res, cycle=cycle):
                    xx, rr = next(cycle)
                    return fn(xx, scale, rr if with_res else None)

                got = fused_rmsnorm(x, scale, residual)
                want = ref.fused_rmsnorm_ref(x, scale, residual)
                torch.cuda.synchronize()
                err = (got[0].float() - want[0].float()).abs().max().item()
                # bf16: one ulp of the output scale (the two sum in another
                # order, and rsqrtf rounds); f32: a few ulp of O(1) outputs
                tol = (bf16_ulp(want[0].float().abs().max().item())
                       if kind == "bf16" else TOL["f32"])
                check(got[0].shape == want[0].shape and got[0].dtype == dt,
                      f"rmsnorm {name} {kind}: output {got[0].dtype}")
                check(torch.equal(got[1], want[1]),
                      f"rmsnorm {name} {kind}: residual sum differs")
                check(err <= tol, f"rmsnorm {name} {kind}: max abs err {err} > {tol}")
                ms = cuda_ms(lambda: run(fused_rmsnorm))
                eager_ms = cuda_ms(lambda: run(fused_rmsnorm), graph=False)
                plain_ms = cuda_ms(lambda: run(ref.fused_rmsnorm_ref), iters=10)
                if residual is None:
                    w = scale.to(dt)
                    library_ms = cuda_ms(lambda: F.rms_norm(next(cycle)[0], (d,), w, 1e-6))
                else:
                    library_ms = None   # no single PyTorch call adds and norms
                n_io = 4 if with_res else 2          # x, y (and residual, r)
                nbytes = n_io * N * d * x.element_size() + d * 4
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                tag = "residual" if with_res else "plain"
                rows[(name, kind, tag)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="bytes", library_ms=library_ms)
                lib = "none" if library_ms is None else f"{library_ms:.4f}"
                blocks, threads = launch_shape(N, d, dt.itemsize)
                print(f"kernel fused_rmsnorm {name:25s} d={d} {kind:4s} {tag:8s} "
                      f"launch={blocks}x{threads} "
                      f"err={err:.3e} (tol {tol:.3e}) ms={ms:.4f} eager_ms={eager_ms:.4f} "
                      f"plain_ms={plain_ms:.4f} "
                      f"library_ms={lib} bound_ms={bound_ms:.5f} (bytes) "
                      f"share={bound_ms / ms:.3f}")
    return rows


def attention_pairs(Tq, Tk, causal, window):
    """Unmasked (query, key) pairs of one head: the work the data needs."""
    i = np.arange(Tq)[:, None]
    j = np.arange(Tk)[None, :]
    m = np.ones((Tq, Tk), bool)
    if causal:
        m &= j <= i
    if window > 0:
        m &= j > i - window
    return int(m.sum())


def flash_phase():
    """Flash-attention prefill at granite's prefill group (B 8, T 128) and a
    long prompt (B 1, T 1024) in bf16 and f32, a ragged T, a windowed and a
    non-causal case, and the reduced heads; at head_dim 128, llama2-13b's
    and llama2-7b's prefill groups, a long prompt, a ragged T and a window,
    in bf16 and f32. q/k/v are the (B, T, H, D)
    projections passed as (B, H, T, D) views, as ``gqa_full`` passes them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [
        # name, B, H, KVH, T, D, causal, window, kinds
        ("main B=8 T=128", 8, 32, 8, 128, 64, True, 0, ("bf16", "f32")),
        ("long B=1 T=1024", 1, 32, 8, 1024, 64, True, 0, ("bf16", "f32")),
        ("ragged B=2 T=200", 2, 32, 8, 200, 64, True, 0, ("bf16",)),
        ("window=64 T=200", 2, 32, 8, 200, 64, True, 64, ("bf16",)),
        ("noncausal T=200", 2, 32, 8, 200, 64, False, 0, ("bf16",)),
        ("reduced B=8 T=128", 8, 4, 2, 128, 16, True, 0, ("bf16", "f32")),
        ("llama2-13b B=8 T=128", 8, 40, 40, 128, 128, True, 0, ("bf16", "f32")),
        ("llama2-7b B=8 T=128", 8, 32, 32, 128, 128, True, 0, ("bf16", "f32")),
        ("llama2 long B=1 T=1024", 1, 40, 40, 1024, 128, True, 0, ("bf16", "f32")),
        ("llama2 ragged T=200", 2, 40, 40, 200, 128, True, 0, ("bf16", "f32")),
        ("llama2 window=64 T=200", 2, 40, 40, 200, 128, True, 64, ("bf16", "f32")),
    ]
    rows = {}
    for name, B, H, KVH, T, D, causal, window, kinds in shapes:
        for kind in kinds:
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            nbytes = (2 * B * H * T * D + 2 * B * KVH * T * D) * dt.itemsize
            # input sets rotate past the 50 MB L2, as in the paged rows
            sets = [tuple(torch.randn(B, T, n, D, generator=gen, device="cuda")
                          .to(dt).transpose(1, 2) for n in (H, KVH, KVH))
                    for _ in range(min(16, max(2, math.ceil(128e6 / nbytes))))]
            q, k, v = sets[0]
            cycle = itertools.cycle(sets)

            def run(fn, **kw):
                return fn(*next(cycle), **kw)

            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"flash {name} {kind}: output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()), f"flash {name} {kind}: non-finite")
            err = (got.float() - want.float()).abs().max().item()
            if kind == "bf16":
                # the criterion of test_bf16_prefill_attention_matches_blocked_
                # reference: P·V in fp32 (the kernel splits P into two bf16
                # terms) moves an output by at most one bf16 ulp of the output
                # scale, and few of them; P rounded to one bf16 term moves
                # 35-40 % of them (tests/test_torch_flash_numerics.py); never
                # above the absolute bound of the other bf16 checks
                tol = min(TOL["bf16"], bf16_ulp(want.float().abs().max().item()))
                differ = (got != want).float().mean().item()
                check(err <= tol and differ < 0.01,
                      f"flash {name} bf16: max abs err {err} (tol {tol}), share of "
                      f"outputs differing {differ} (limit 0.01)")
                crit = f"(tol {tol:.3e}) differ={differ:.4%} (limit 1%)"
            else:
                check(err <= TOL[kind], f"flash {name} {kind}: max abs err {err} > {TOL[kind]}")
                crit = f"(tol {TOL[kind]})"
            ms = cuda_ms(lambda: run(flash_attention, causal=causal, window=window))
            eager_ms = cuda_ms(lambda: run(flash_attention, causal=causal, window=window),
                               graph=False)
            plain_ms = cuda_ms(lambda: run(ref.flash_attention_ref, causal=causal,
                                           window=window), iters=10)
            if window > 0:
                i = torch.arange(T, device="cuda")
                mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
                library_ms = cuda_ms(lambda: run(F.scaled_dot_product_attention,
                                                 attn_mask=mask, enable_gqa=True))
            else:
                library_ms = cuda_ms(lambda: run(F.scaled_dot_product_attention,
                                                 is_causal=causal, enable_gqa=True))
            flops = 4 * D * B * H * attention_pairs(T, T, causal, window)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dt] * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            rows[(name, kind)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=library_ms)
            print(f"kernel flash_attention {name:22s} B={B} H={H} KVH={KVH} T={T} D={D} "
                  f"causal={causal} window={window} {kind:4s} err={err:.3e} "
                  f"{crit} ms={ms:.4f} eager_ms={eager_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.5f} ({bound_by}) "
                  f"share={bound_ms / ms:.3f}")
    return rows


# ----------------------------------------------------------------------
# phases 4 to 9: the sampler and the serving path
# ----------------------------------------------------------------------

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


# jax.random's known answers (jax 0.9.0's partitionable threefry2x32),
# computed with the reference on the CPU; tests/test_torch_prng.py and
# tests/test_torch_sampler.py recompute them from the reference
RANDOM123 = (0x6B200159, 0x99BA4EFE)      # threefry2x32(key 0, counter 0)
SPLIT_0_3 = [[1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]]
FOLD_42_7 = [2547012911, 1371500959]
BITS_0_4 = [4070199207, 4202968722, 1427181096, 2012915765]
UNIFORM_1_3 = [0.4386324882507324, 0.5337529182434082, 0.44591832160949707]
# sample_logits_batched on default_rng(0).standard_normal((4, 512)), key
# PRNGKey(0), without fold_ids and with them
SAMPLER_PARAMS = ([0.9, 0.7, 0.0, 1.0], [50, 0, 5, 8], [0.95, 0.8, 1.0, 1.0])
SAMPLER_FOLD = [3, 1, 0, 2]
SAMPLER_TOKENS = ([403, 249, 27, 270], [270, 249, 27, 74])
# sample_temperature_only on the same logits, key and temperatures (top_k
# 0, top_p 1): without and with SAMPLER_FOLD
TEMP_ONLY_TOKENS = ([403, 211, 27, 503], [53, 211, 27, 466])


def sampler_phase():
    """The key stream and the sampler on the card, against jax's known
    answers: every word, bit and token equal (the draws run where the
    entries run them, on device tensors)."""
    from repro_torch.serving import prng
    from repro_torch.serving.sampler import (sample_logits_batched,
                                             sample_temperature_only)
    dev = "cuda"
    z = torch.zeros((), dtype=torch.int64, device=dev)
    got = {
        "threefry2x32(0, 0)": (tuple(int(x) for x in prng.threefry_2x32(z, z, z, z)),
                               RANDOM123),
        "split(PRNGKey(0), 3)": (prng.split(prng.PRNGKey(0, dev), 3).tolist(), SPLIT_0_3),
        "fold_in(PRNGKey(42), 7)": (prng.fold_in(prng.PRNGKey(42, dev), 7).tolist(),
                                    FOLD_42_7),
        "bits(PRNGKey(0), (4,))": (prng.bits(prng.PRNGKey(0, dev), (4,)).tolist(), BITS_0_4),
        "uniform(PRNGKey(1), (3,))": (prng.uniform(prng.PRNGKey(1, dev), (3,)).tolist(),
                                      UNIFORM_1_3),
    }
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 512))
                              .astype(np.float32)).to(dev)
    t, k, p = (torch.tensor(x, device=dev) for x in SAMPLER_PARAMS)
    no_k, no_p = torch.zeros_like(k), torch.ones_like(p)
    folds = (None, torch.tensor(SAMPLER_FOLD, device=dev))
    for fold, want, want_temp in zip(folds, SAMPLER_TOKENS, TEMP_ONLY_TOKENS):
        tokens = sample_logits_batched(logits, prng.PRNGKey(0, dev), t, k, p, fold_ids=fold)
        got[f"sample_logits_batched fold_ids={fold is not None}"] = (tokens.tolist(), want)
        tokens = sample_temperature_only(logits, prng.PRNGKey(0, dev), t, no_k, no_p,
                                         fold_ids=fold)
        got[f"sample_temperature_only fold_ids={fold is not None}"] = (tokens.tolist(),
                                                                       want_temp)
    wrong = {name: pair for name, pair in got.items() if pair[0] != pair[1]}
    check(not wrong, f"sampler phase: (card, jax) differ: {wrong}")
    print(f"sampler: threefry key stream and sampler on the card equal jax.random's known "
          f"answers ({len(got)} checks: {', '.join(got)})")


def small_phase(arch):
    """A reduced config (vocab 512), fp32: card (kernel) and CPU (plain)
    engines agree, whole-prompt and chunked, and chunked agrees with
    whole-prompt."""
    from repro_torch.configs import reduced
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    cfg = reduced(arch).replace(vocab_size=512)
    cpu_params = MD.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    tok = ByteTokenizer()
    for kv_int8 in (False, True):
        streams = {}
        for chunk in (0, 8):
            for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
                eng = InferenceEngine(cfg, params, n_slots=4, max_len=128,
                                      paged=True, page_size=16, decode_block=4,
                                      kv_int8=kv_int8, prefill_chunk=chunk,
                                      device=dev)
                # budgets differ, so slots free while other lanes decode
                # and the chunked engine admits the late requests in chunks
                for i, p in enumerate(PROMPTS[:6]):
                    eng.submit(tok.encode(p, bos=True), max_new_tokens=12 + 4 * i)
                eng.run_to_completion()
                check(chunk == 0 or eng.chunk_steps > 0,
                      f"reduced {arch} kv_int8={kv_int8} {dev}: no chunk ran")
                streams[(chunk, dev)] = {f.rid: f.token_ids for f in eng.finished}
        whole = streams[(0, "cuda")]
        check(len(whole) == 6, f"reduced {arch} kv_int8={kv_int8}: {len(whole)} of 6 finished")
        for chunk in (0, 8):
            check(streams[(chunk, "cpu")] == streams[(chunk, "cuda")],
                  f"reduced {arch} kv_int8={kv_int8} chunk={chunk}: card and CPU token "
                  "streams differ")
        # (rid, first differing token, length) of chunked against whole-prompt
        diff = [(rid, next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                           min(len(got), len(want))), len(want))
                for rid, want in whole.items()
                if (got := streams[(8, "cuda")].get(rid, [])) != want]
        # fp32: chunked prefill computes what whole-prompt prefill computes.
        # int8 KV: a chunk attends over the quantized K/V of the prompt read
        # back from its pages, where whole-prompt prefill attends over the
        # unquantized K/V, as in the reference (its gqa_chunk_append against
        # gqa_full; the CPU tests hold the port's logit gap between the two
        # to the reference's), so a greedy token near a tie may differ;
        # card == CPU above is the check that holds the kernels there
        check(kv_int8 or not diff, f"reduced {arch} fp32: chunked differs from whole-prompt "
              f"as (rid, first differing token, length): {diff}")
        print(f"small reduced {cfg.name} fp32 (tied embeddings {cfg.tie_embeddings}) "
              f"kv_int8={kv_int8}: card == CPU greedy tokens, "
              f"whole-prompt and chunked (chunk 8), for {len(whole)} requests "
              f"({sum(map(len, whole.values()))} tokens); chunked against whole-prompt: "
              + (f"differs as (rid, first differing token, length) {diff}" if diff
                 else "identical"))
    small_prefix(cfg, cpu_params, gpu_params)
    small_sampled(cfg, cpu_params, gpu_params)
    small_dense(cfg, cpu_params, gpu_params)
    t0 = time.monotonic()
    small_faults(cfg, cpu_params, gpu_params)
    print(f"small faults reduced {cfg.name}: {time.monotonic() - t0:.1f} s")


# ----------------------------------------------------------------------
# fault injection and recovery: the fill's checks and the poison drives
# ----------------------------------------------------------------------

def lane_rows(eng, slot):
    """The store rows a fill of ``slot`` must write: its row (dense) or the
    pages its table maps (with the prefix cache only those it owns alone),
    and the store's row count (the sink row or the trash page included)."""
    if not eng.paged:
        return [slot], eng.n_slots + 1
    al = eng.pages
    keep = al.block_table[slot] >= 0
    if eng.prefix_cache:
        keep &= al.exclusive_pages(slot)
    return sorted(int(p) for p in al.block_table[slot][keep]), al.n_pages + 1


def checked_fills(eng, record):
    """Wrap the engine's ``_fill_lane`` (poison and scrub): time each fill
    alone, then check it wrote ``value`` into every float leaf of exactly
    the lane's row or pages and left every other byte of the store (the
    sink row or the trash page, ``kpos``, int8 codes) as it was, layer by
    layer. Appends (slot, value, rows, ms, adopted pages mapped) to
    ``record``."""
    fill = eng._fill_lane
    dev = eng.device

    def checked(slot, value):
        rows, n_rows = lane_rows(eng, slot)
        adopted = 0
        if eng.paged:
            al = eng.pages
            adopted = sum(int(al._owner[p]) != slot
                          for p in al.block_table[slot][: int(al._slot_pages[slot])])
        before = [{n: x.clone() for n, x in seg.items()} for seg in eng.cache]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fill(slot, value)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fill(slot, value)
            ms = (time.perf_counter() - t0) * 1e3
        hit = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        hit[rows] = True
        for seg, old in zip(eng.cache, before):
            for name, x in seg.items():
                for layer in range(x.shape[0]):
                    moved = (x[layer].view(torch.uint8) != old[name][layer].view(torch.uint8))
                    moved = moved.flatten(1).any(1)
                    check(not bool((moved & ~hit).any()),
                          f"fill of slot {slot} with {value} wrote {name} rows "
                          f"{(moved & ~hit).nonzero().flatten().tolist()} of layer {layer}")
                    if x.is_floating_point() and rows:
                        got = x[layer][hit]
                        ok = got.isnan().all() if value != value else (got == value).all()
                        check(bool(ok), f"fill of slot {slot} with {value}: {name} of "
                              f"layer {layer} not filled in rows {rows}")
        del before
        record.append((slot, value, rows, ms, adopted))

    eng._fill_lane = checked


def store_finite(eng):
    """Nothing non-finite in the store's slot rows or pages; the sink row
    and the trash page, where dead rows of a poisoned lane write, are left
    out."""
    n = eng.pages.n_pages if eng.paged else eng.n_slots
    return all(bool(torch.isfinite(x[:, :n]).all()) for seg in eng.cache
               for x in seg.values() if x.is_floating_point())


def poison_drive(eng, requests, occurrences, level_fn=None):
    """Serve ``requests`` (ServeRequests) through ``CarbonAwareScheduler``
    on ``eng`` with ``decode.nonfinite`` armed at ``occurrences`` (lanes
    consulted, in order), every fill checked (``checked_fills``). Returns
    the scheduler, the poisoned rids, the quarantined rids (in order) and
    the fills."""
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import CarbonAwareScheduler
    fills = []
    checked_fills(eng, fills)
    inj = FaultInjector(FaultPlan([FaultSpec("decode.nonfinite", "*",
                                             occurrences=occurrences)]))
    sched = CarbonAwareScheduler([eng], level_fn=level_fn, fault_injector=inj)
    for req in requests:
        sched.submit(req)
    try:
        sched.run()
    finally:
        del eng._fill_lane
    poisoned = [int(e.target) for e in inj.events if e.point == "decode.nonfinite"]
    caught = [st.rid for reason, st in sched.fault_events if reason == "decode.nonfinite"]
    return sched, poisoned, caught, fills


def ledger(eng):
    """A page store's allocator state, for card == CPU."""
    al = eng.pages
    return (al.block_table.tolist(), al.refcount.tolist(), sorted(al._free),
            sorted(al._index.values()), eng._committed, al.pinned)


def small_faults(cfg, cpu_params, gpu_params):
    """Lane poison and recovery on the reduced config (fp32 unless int8),
    card against CPU: eight requests (directive levels 2, 1, 2, 0, ... so
    the system prompts share pages) through ``CarbonAwareScheduler`` with
    ``decode.nonfinite`` at occurrences (0, 3), on a dense engine
    (whole-prompt and chunked 8), a paged engine (fp32 and int8) and a
    paged engine with the prefix cache (chunked 4, so hits stream their
    suffix while lanes decode), which must poison a lane that maps adopted
    pages: there the second poison is the 25th lane consulted (occurrence
    24, a hit admitted after the first wave; the first four consults are
    the first wave's owners of the shared pages). On both devices: every request served, none rejected, every
    poisoned lane caught, every fill lane-only (shared pages byte-equal
    across the quarantine), nothing non-finite left at drain, the page
    ledger clean. The card quarantines exactly the poisoned lanes (the
    kernel reads only a lane's own pages; no poison here fills page 0
    while a chunk pass runs, which would take the chunk lane down too:
    ``small_chunk_collateral`` drives that). A dense engine's CPU run does
    too, and card and CPU give the same tokens, quarantines and store. A
    paged engine's CPU run may quarantine more: the plain attention, like
    the reference's XLA path, reads unmapped table entries clamped to page
    0 at masked positions, where 0 x NaN is NaN, so poisoning the holder of
    page 0 takes down every lane of that block; the retried requests then
    regenerate, so the tokens must still equal the card's, and where both
    quarantined the same lanes the page ledgers must too."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.scheduler import ServeRequest
    drives = {"dense": {}, "dense chunked": {"prefill_chunk": 8},
              "paged": {"paged": True, "page_size": 16},
              "paged int8": {"paged": True, "page_size": 16, "kv_int8": True},
              "paged prefix cache": {"paged": True, "page_size": 16, "prefix_cache": True,
                                     "prefill_chunk": 4}}
    for drive, kw in drives.items():
        occurrences = (0, 24) if kw.get("prefix_cache") else (0, 3)
        runs = {}
        for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
            eng = InferenceEngine(cfg, params, n_slots=4, max_len=160, decode_block=4,
                                  seed=SEED, device=dev, **kw)
            levels = itertools.cycle((2, 1, 2, 0))
            reqs = [ServeRequest(0, p, max_new_tokens=12 + 4 * (i % 4))
                    for i, p in enumerate(PROMPTS[:8])]
            sched, poisoned, caught, fills = poison_drive(eng, reqs, occurrences,
                                                          lambda: next(levels))
            runs[dev] = dict(
                tokens={f.rid: f.token_ids for f in sched.finished}, poisoned=poisoned,
                caught=caught, rejected=list(sched.rejected), fills=fills, eng=eng,
                finite=store_finite(eng),
                ledger=ledger(eng) if eng.paged else None,
                retries={f.rid: f.retries for f in sched.finished})
        card, cpu = runs["cuda"], runs["cpu"]
        label = f"small faults reduced {cfg.name} {drive}"
        for dev, r in runs.items():
            check(len(r["tokens"]) == 8 and not r["rejected"],
                  f"{label} {dev}: {len(r['tokens'])} of 8 served, rejected {r['rejected']}")
            check(len(r["poisoned"]) == 2 and set(r["poisoned"]) <= set(r["caught"]),
                  f"{label} {dev}: poisoned {r['poisoned']}, quarantined {r['caught']}")
            check(r["finite"], f"{label} {dev}: non-finite values left in the store")
            check(sum(v != v for _, v, *_ in r["fills"]) == 2
                  and sum(v == 0.0 for _, v, *_ in r["fills"]) == len(r["caught"]),
                  f"{label} {dev}: fills {[(sl, v) for sl, v, *_ in r['fills']]}")
            if r["ledger"] is not None:
                check(r["ledger"][4:] == (0, 0), f"{label} {dev}: ledger at drain "
                      f"(committed, pinned) {r['ledger'][4:]}")
        check(card["caught"] == card["poisoned"],
              f"{label}: the card quarantined {card['caught']}, poisoned {card['poisoned']}")
        check(card["tokens"] == cpu["tokens"], f"{label}: card and CPU tokens differ: "
              f"{first_differences(card['tokens'], cpu['tokens'])}")
        same = card["caught"] == cpu["caught"]
        if not kw.get("paged"):
            kpos_rows, err, flips = store_difference(card["eng"].cache, cpu["eng"].cache)
            check(same and kpos_rows == 0 and err <= 1e-5,
                  f"{label}: card quarantined {card['caught']}, CPU {cpu['caught']}; "
                  f"store: {kpos_rows} kpos rows, max difference {err:.3e}")
        elif same:
            check(card["ledger"] == cpu["ledger"], f"{label}: page ledgers differ")
        if "prefix" in drive:
            check(any(f[4] > 0 for f in card["fills"] if f[1] != f[1]),
                  f"{label}: no poisoned lane mapped adopted pages: {card['fills']}")
        fill_ms = {dev: [round(f[3], 3) for f in r["fills"]] for dev, r in runs.items()}
        print(f"{label}: 8 served on both, none rejected; poisoned {card['poisoned']}, "
              f"quarantined on the card {card['caught']} (= the poisoned), on the CPU "
              f"{cpu['caught']}; card == CPU tokens; retries card "
              f"{sorted(card['retries'].values())} CPU {sorted(cpu['retries'].values())}; "
              f"every fill lane-only, (slot, value, rows, adopted pages) "
              f"{[(f[0], f[1], f[2], f[4]) for f in card['fills']]}; fill ms {fill_ms}; "
              + ("store == CPU's" if not kw.get("paged") else
                 "page ledger == CPU's" if same else
                 "the CPU's plain attention quarantined more (page 0 read through an "
                 "unmapped entry)"))
    small_chunk_collateral(cfg, cpu_params, gpu_params)
    if cfg.name.startswith("granite"):
        small_chaos()


def small_chunk_collateral(cfg, cpu_params, gpu_params):
    """The chunk pass's collateral quarantine, card against CPU: a paged
    engine (fp32, chunked 8) serves three requests, a fourth streams its
    prompt in chunks, and while that prompt is partly written the live lane
    that holds page 0 is poisoned. The chunk pass gathers the lane's pages
    through the block table with unmapped entries clamped to page 0 and
    masked by position, as the reference's does; a weight of 0 times NaN is
    NaN, so the chunk lane's logits go non-finite too. Gates: the card
    quarantines exactly the holder of page 0 and the chunk lane (the
    kernels' decode lanes stay clean), the CPU at least those two, every
    fill lane-only; the quarantined requests, resubmitted, finish and every
    request's tokens equal the CPU's; nothing non-finite left at drain; the
    page ledger clean."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    label = f"small chunk collateral reduced {cfg.name} paged fp32 chunked 8"
    runs = {}
    for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
        eng = InferenceEngine(cfg, params, n_slots=4, max_len=160, decode_block=4,
                              seed=SEED, device=dev, paged=True, page_size=16,
                              prefill_chunk=8)
        fills = []
        checked_fills(eng, fills)
        for i, p in enumerate(PROMPTS[:3]):
            eng.submit(tok.encode(p, bos=True), max_new_tokens=24 + 4 * i)
        eng.step()
        eng.submit(tok.encode(PROMPTS[2] + " " + PROMPTS[3], bos=True), max_new_tokens=12)
        holder = None
        for _ in range(40):
            t = eng._task
            if t is not None and 0 < t.next < t.plen:
                holder = next((i for i in range(eng.n_slots) if i != t.slot and eng.live[i]
                               and 0 in eng.pages.block_table[i]), None)
                if holder is not None:
                    break
            eng.step()
        check(holder is not None, f"{label} {dev}: no lane held page 0 while a prompt streamed")
        poisoned = (eng.slots[holder].rid, eng.slots[eng._task.slot].rid)
        eng.poison_lane(holder)
        eng.step()
        caught = sorted(st.rid for st in eng.faulted)
        for st in eng.faulted:
            eng.submit(st.prompt_ids, max_new_tokens=st.max_new_tokens, rid=st.rid)
        eng.faulted = []
        eng.run_to_completion()
        del eng._fill_lane
        runs[dev] = dict(poisoned=poisoned, caught=caught, fills=fills,
                         tokens={f.rid: f.token_ids for f in eng.finished},
                         finite=store_finite(eng), ledger=ledger(eng))
    card, cpu = runs["cuda"], runs["cpu"]
    check(card["poisoned"] == cpu["poisoned"],
          f"{label}: (holder, chunk lane) card {card['poisoned']}, CPU {cpu['poisoned']}")
    check(card["caught"] == sorted(card["poisoned"]),
          f"{label}: the card quarantined {card['caught']}, holder and chunk lane "
          f"{card['poisoned']}")
    check(set(card["poisoned"]) <= set(cpu["caught"]),
          f"{label}: the CPU quarantined {cpu['caught']}")
    for dev, r in runs.items():
        check(len(r["tokens"]) == 4 and r["finite"] and r["ledger"][4:] == (0, 0),
              f"{label} {dev}: {len(r['tokens'])} of 4 served, store finite {r['finite']}, "
              f"ledger at drain {r['ledger'][4:]}")
    check(card["tokens"] == cpu["tokens"], f"{label}: card and CPU tokens differ: "
          f"{first_differences(card['tokens'], cpu['tokens'])}")
    print(f"{label}: poisoned the holder of page 0 (rid {card['poisoned'][0]}) while rid "
          f"{card['poisoned'][1]} streamed its prompt; quarantined on the card "
          f"{card['caught']} (the chunk lane too), on the CPU {cpu['caught']}; "
          f"4 served, card == CPU tokens; fills (slot, value, pages) "
          f"{[(f[0], f[1], f[2]) for f in card['fills']]}")


def small_chaos():
    """Sprout's paired chaos scenario (``repro_torch.serving.chaos``:
    reduced granite, dense engines, every fault class, two lanes poisoned)
    on the card and on the CPU, on the port's seed-0 weights drawn on the
    CPU: every ``check_pair`` invariant holds on the card, and the card's
    report and digest equal the CPU's."""
    from repro_torch.serving import chaos as C
    cfg, cpu_params = C.build_model("cpu")
    gpu_params = to_device(cpu_params, "cuda")
    t0 = time.monotonic()
    card = C.run_chaos(cfg, gpu_params)
    t1 = time.monotonic()
    cpu = C.run_chaos(cfg, cpu_params)
    t2 = time.monotonic()
    failed = [k for k, ok in card["checks"].items() if not ok]
    check(len(card["checks"]) == 12 and not failed, f"chaos on the card: failed {failed}")
    diff = [k for side in ("control", "chaos") for k in card[side]
            if card[side][k] != cpu[side][k]]
    check(card == cpu, f"chaos: the card's report differs from the CPU's in {diff}")
    ch = card["chaos"]
    print(f"small chaos ({cfg.name}, dense engines): every check_pair invariant on the "
          f"card; report == CPU's, digest {card['digest']}; served {ch['served']}, "
          f"faults {ch['faults']}, shed {ch['shed']}, plan holds {ch['plan_holds']}, "
          f"injected {[e[0] + '@' + e[1] for e in ch['injected']]}; card {t1 - t0:.1f} s, "
          f"CPU {t2 - t1:.1f} s")


def store_difference(card, cpu):
    """How the card's dense store departs from the CPU's, slot rows only
    (the sink row takes pad writes in no set order): ``kpos`` rows that
    differ, the largest K/V or scale difference where ``kpos`` is valid
    (float leaves), and the int8 codes that differ there (at most one
    apart, or the count is of codes further apart, negated)."""
    kpos_rows, err, flips = 0, 0.0, 0
    for seg_g, seg_c in zip(card, cpu):
        kg, kc = seg_g["kpos"][:, :-1].cpu(), seg_c["kpos"][:, :-1]
        kpos_rows += int((kg != kc).any(dim=-1).sum())
        valid = kc > -(1 << 29)
        for name, x in seg_g.items():
            if name == "kpos":
                continue
            g, c = x[:, :-1].cpu()[valid], seg_c[name][:, :-1][valid]
            if not g.numel():
                continue
            if x.dtype == torch.int8:
                d = (g.int() - c.int()).abs()
                flips += int((d > 0).sum()) if int(d.max()) <= 1 else -int((d > 1).sum())
            else:
                err = max(err, float((g - c).abs().max()))
    return kpos_rows, err, flips


def small_dense(cfg, cpu_params, gpu_params):
    """The dense layout (no ``paged``, the reference's default engine) on
    the reduced config, 4 slots of 128 rows: fp32 and int8 KV, whole-prompt
    and chunked (chunk 8), budgets that free slots while others decode, so
    blocks run in buckets under the 4 slots; then one sampled drive (rows
    cycle greedy, temperature-only and top-k/top-p, chunked). Card and CPU
    give the same tokens and entry names; the card's store holds the CPU's
    ``kpos`` on every slot row and K/V within 1e-5 where ``kpos`` is valid
    (int8: codes at most one apart, on under 1e-3 of them)."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    modes = list(sampling_modes().values())
    drives = [(kv_int8, chunk, False) for kv_int8 in (False, True) for chunk in (0, 8)]
    for kv_int8, chunk, sampled in drives + [(False, 8, True)]:
        runs = {}
        for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
            eng = InferenceEngine(cfg, params, n_slots=4, max_len=128, decode_block=4,
                                  kv_int8=kv_int8, prefill_chunk=chunk, seed=SEED,
                                  device=dev)
            check(not eng.paged, "a default engine is not dense")
            for i, p in enumerate(PROMPTS[:6]):
                eng.submit(tok.encode(p, bos=True), max_new_tokens=12 + 4 * i,
                           sampling=modes[i % 3] if sampled else None)
            eng.run_to_completion()
            runs[dev] = ({f.rid: f.token_ids for f in eng.finished}, sorted(eng.entry_points),
                         eng.chunk_steps, eng.cache)
        label = (f"small dense reduced {cfg.name} fp32 kv_int8={kv_int8} chunk={chunk}"
                 + (" sampled" if sampled else ""))
        streams, entries, chunks, store = runs["cuda"]
        check(runs["cpu"][:3] == (streams, entries, chunks),
              f"{label}: card and CPU differ in tokens, entries or chunk count")
        check(len(streams) == 6 and (chunk == 0 or chunks > 0),
              f"{label}: {len(streams)} of 6 finished, {chunks} chunks")
        blocks = [n for n in entries if n.startswith(("decode_", "mixed_"))]
        check(any(int(n.split("_")[1][2:]) < 4 for n in blocks),
              f"{label}: no block ran in a bucket under the 4 slots: {blocks}")
        kpos_rows, err, flips = store_difference(store, runs["cpu"][3])
        n_codes = sum(x[:, :-1].numel() for seg in store for name, x in seg.items()
                      if x.dtype == torch.int8)
        check(kpos_rows == 0 and err <= 1e-5 and 0 <= flips < 1e-3 * max(n_codes, 1),
              f"{label}: the card's store departs from the CPU's: {kpos_rows} kpos rows, "
              f"max K/V difference {err:.3e}, int8 codes {flips}")
        print(f"{label}: card == CPU tokens and entries for {len(streams)} requests "
              f"({sum(map(len, streams.values()))} tokens), {chunks} chunks; store: kpos "
              f"equal, max K/V difference {err:.3e} on valid rows"
              + (f", {flips} int8 codes one apart" if kv_int8 else "")
              + f"; block entries {blocks}")


def small_sampled(cfg, cpu_params, gpu_params):
    """Seeded sampled decoding on the reduced config (fp32): requests cycle
    greedy, temperature-only and top-k/top-p (``sampling_modes``), on the
    card and the CPU, whole-prompt (budgets differ, so later blocks run in
    buckets smaller than the 4 slots, whose rows fold by slot id), chunked
    (chunk 8: late requests admitted as chunk tasks, their first tokens
    drawn in the mixed entry) and with the prefix cache on directive-prompt
    traffic (hits stream their suffix through the chunk lane); then greedy
    and temperature-only requests alone, chunked, so that bucketed
    ``decode_*_temp`` and ``mixed_*_temp`` entries run (where a top-k/top-p
    row shares the bucket, the ``_full`` entry runs). Card and CPU must
    give the same tokens, block tables and entry names."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    modes = sampling_modes()
    cycle = list(modes.values())
    plain = [(tok.encode(p, bos=True), 12 + 4 * i) for i, p in enumerate(PROMPTS[:6])]
    drives = {"whole-prompt": (plain, {}, cycle),
              "chunked": (plain, {"prefill_chunk": 8}, cycle),
              "prefix cache": (directive_traffic(tok), {"prefix_cache": True}, cycle),
              "temperature-only": (plain, {"prefill_chunk": 8},
                                   [modes["greedy"], modes["temp"]])}
    label = f"small sampled reduced {cfg.name} fp32"
    for drive, (traffic, kw, mix) in drives.items():
        runs = {}
        for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
            eng = InferenceEngine(cfg, params, n_slots=4, max_len=160, paged=True,
                                  page_size=16, decode_block=4, seed=SEED, device=dev, **kw)
            tables = record_tables(eng)
            for i, (ids, n) in enumerate(traffic):
                eng.submit(ids, max_new_tokens=n, sampling=mix[i % len(mix)])
            eng.run_to_completion()
            runs[dev] = ({f.rid: f.token_ids for f in eng.finished}, tables,
                         sorted(eng.entry_points), eng.prefill_tokens_cached, eng.chunk_steps)
        streams, _, entries, cached, chunks = runs["cuda"]
        check(runs["cuda"] == runs["cpu"], f"{label} {drive}: card and CPU differ in tokens, "
              f"block tables, entries or counters")
        check(len(streams) == len(traffic), f"{label} {drive}: {len(streams)} finished")
        blocks = [n for n in entries if n.startswith(("decode_", "mixed_"))]
        bucketed = [n for n in blocks if n.startswith(("decode_bs1_", "decode_bs2_"))
                    and not n.endswith("_greedy")]
        sampled_mixed = [n for n in blocks if n.startswith("mixed_")
                         and not n.endswith("_greedy")]
        temp = [n for n in blocks if n.endswith("_temp")]
        want = {"whole-prompt": bool(bucketed), "chunked": bool(sampled_mixed),
                "prefix cache": cached > 0 and bool(sampled_mixed),
                "temperature-only": (any(n.startswith("decode_bs1_") for n in temp)
                                     and any(n.startswith("mixed_") for n in temp)
                                     and not any(n.endswith("_full") for n in blocks))}[drive]
        check(want, f"{label} {drive}: entries {blocks}, {cached} prompt tokens cached")
        print(f"{label} {drive}: card == CPU tokens, block tables and entries for "
              f"{len(streams)} requests ({sum(map(len, streams.values()))} tokens); "
              f"{chunks} chunks, {cached} prompt tokens cached; block entries {blocks}")


def record_tables(eng):
    """{rid: the request's block-table row at its finish}, filled as the
    engine finishes requests."""
    seen = {}
    finish = eng._finish

    def wrapped(slot):
        seen[eng.slots[slot].rid] = eng.pages.block_table[slot].tolist()
        finish(slot)

    eng._finish = wrapped
    return seen


def directive_traffic(tok, n=8):
    """Sprout's traffic for the prefix cache: ``n`` prompts rendered at
    directive levels 2, 1, 2, 0, ... (the scheduler's rendering, so every
    L2 and every L1 request starts with the same full pages), plus one
    96-token, page-aligned prompt submitted second and again last, whose
    repeat is a full hit and recomputes its last token: the one
    copy-on-write. Returns [(ids, max_new_tokens)]."""
    from repro_torch.core import DirectiveSet
    directives = DirectiveSet()
    reqs = [(tok.encode(directives.apply(p, (2, 1, 2, 0)[i % 4]), bos=True), 8 + 4 * (i % 4))
            for i, p in enumerate(PROMPTS[:n])]
    aligned = (tok.encode(directives.apply(PROMPTS[-1], 2), bos=True) * 2)[:96]
    return reqs[:1] + [(aligned, 12)] + reqs[1:] + [(aligned, 12)]


def small_prefix(cfg, cpu_params, gpu_params):
    """The radix prefix cache on the reduced config: ``directive_traffic``
    with the cache on and off, fp32 and int8 KV, on the card and the CPU.
    Card and CPU give the same tokens and block tables; the cache skips
    prefill, makes its one copy and drains clean; in fp32 prefix-on gives
    prefix-off's tokens (at int8 a hit's suffix attends over quantized
    K/V where whole-prompt prefill does not, as with chunked prefill)."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.tokenizer import ByteTokenizer
    traffic = directive_traffic(ByteTokenizer())
    for kv_int8 in (False, True):
        runs = {}
        for prefix in (False, True):
            for params, dev in ((gpu_params, "cuda"), (cpu_params, "cpu")):
                eng = InferenceEngine(cfg, params, n_slots=4, max_len=160, paged=True,
                                      page_size=16, decode_block=4, kv_int8=kv_int8,
                                      prefix_cache=prefix, device=dev)
                tables = record_tables(eng)
                for ids, n in traffic:
                    eng.submit(ids, max_new_tokens=n)
                eng.run_to_completion()
                runs[(prefix, dev)] = (
                    {f.rid: f.token_ids for f in eng.finished}, tables,
                    {f.rid: f.cached_tokens for f in eng.finished},
                    (eng.prefill_tokens_cached, eng.prefill_tokens_computed,
                     eng.pages.pages_adopted, eng.pages.cow_copies),
                    (eng._committed, eng.pages.pinned))
        label = f"small prefix cache reduced {cfg.name} kv_int8={kv_int8}"
        for prefix in (False, True):
            check(runs[(prefix, "cuda")] == runs[(prefix, "cpu")],
                  f"{label} prefix_cache={prefix}: card and CPU differ in tokens, block "
                  "tables or cache counters")
        streams, _, cached, (n_cached, n_computed, adopted, cows), ledger = runs[(True, "cuda")]
        off = runs[(False, "cuda")]
        check(len(streams) == len(traffic), f"{label}: {len(streams)} finished")
        check(n_cached > 0 and adopted > 0 and cows == 1,
              f"{label}: cached {n_cached} tokens, adopted {adopted} pages, {cows} copies")
        check(n_cached + n_computed == off[3][1],
              f"{label}: {n_cached} cached + {n_computed} computed prompt tokens != "
              f"{off[3][1]} without the cache")
        check(ledger == (0, 0), f"{label}: (committed, pinned) {ledger} at drain")
        same = streams == off[0]
        check(kv_int8 or same, f"{label}: fp32 prefix-on tokens differ from prefix-off")
        print(f"{label}: card == CPU tokens, block tables and counters, cache on and off, "
              f"for {len(streams)} requests; cached tokens per request "
              f"{list(cached.values())}; prefill {n_cached} tokens cached, {n_computed} "
              f"computed ({off[3][1]} without the cache); {adopted} pages adopted, "
              f"{cows} copy-on-write; prefix-on against prefix-off: "
              + ("identical" if same else "differs (int8 KV)"))


@contextlib.contextmanager
def hooked_runs(eng, wrap, label="a hooked window"):
    """Within the block, each entry's ``run`` is ``wrap(entry, run)`` (an
    instance attribute over the method); the table is frozen inside."""
    from repro_torch.analysis import frozen_entry_points
    for entry in eng.entry_points.values():
        entry.run = wrap(entry, entry.run)
    try:
        with frozen_entry_points(eng, label):
            yield
    finally:
        for entry in eng.entry_points.values():
            entry.__dict__.pop("run", None)


def timed_runs(eng, events):
    """Record CUDA events around every replay into ``events`` as (entry
    name, start, end): the device span of the graphs themselves (kernels
    and the gaps between them), whether or not torch.profiler sees the
    kernels inside a replay."""
    def wrap(entry, run):
        def timed():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            events.append((entry.name, start, end))
            return out
        return timed
    return hooked_runs(eng, wrap)


def replay_span(events, wall_ms, label):
    """The device span (ms) of the one replay timed in a window whose host
    wall (between two syncs) was ``wall_ms``. Exactly one entry must have
    run, and its span cannot exceed the wall that holds it."""
    check(len(events) == 1, f"{label}: {len(events)} replays timed in one window: "
          f"{[name for name, _, _ in events]}")
    _, start, end = events[0]
    span = start.elapsed_time(end)
    check(span <= wall_ms, f"{label}: replay span {span:.3f} ms > host wall {wall_ms:.3f} ms")
    return span


# each wrapper's kernel by its name on the card (a graph's kernel nodes,
# torch.profiler's kernel events); a paged call launches one split kernel,
# and its combine kernel only where it splits
CARD_KERNELS = {"paged_attention": "paged_attention_split_kernel",
                "flash_attention": "flash_attention_bf16_kernel",
                "fused_rmsnorm": "rmsnorm_kernel"}
GRAPH_DUMPS = Path(__file__).resolve().parent / "build" / "graphs"


class KeptGraph(torch.cuda.CUDAGraph):
    """A CUDA graph that keeps its node list once instantiated, so that its
    kernel nodes can be read back (``graph_kernel_nodes``)."""

    def __new__(cls, keep_graph=False):
        return super().__new__(cls, True)

    def __init__(self, keep_graph=False):
        super().__init__(True)
        self.enable_debug_mode()


@contextlib.contextmanager
def kept_graphs():
    """Entries captured inside the block keep their graphs' node lists."""
    plain = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = KeptGraph
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = plain


def graph_kernel_nodes(entry):
    """Each wrapper's kernel nodes in the entry's captured graph, read from
    the graph itself: its debug dump holds one record a kernel node, with
    the kernel's name. Read once and kept on the entry (the dump releases
    the node list; the instantiated graph replays on)."""
    if "kernel_nodes" not in entry.__dict__:
        GRAPH_DUMPS.mkdir(parents=True, exist_ok=True)
        path = GRAPH_DUMPS / f"{entry.name}.dot"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            entry.graph.debug_dump(str(path))
        text = path.read_text()
        path.unlink()
        names = re.findall(r"\{KERNEL\s*\|\s*\{ID \| \d+ \(topoId: \d+\) \| (\S+?)\\<", text)
        check(names and len(names) == text.count("{KERNEL"),
              f"{entry.name}: {text.count('{KERNEL')} kernel nodes in the graph's dump, "
              f"{len(names)} read")
        entry.kernel_nodes = {name: sum(kern in n for n in names)
                              for name, kern in CARD_KERNELS.items()}
        entry.kernel_nodes["all"] = len(names)
    return entry.kernel_nodes


def check_graph_nodes(eng, label):
    """Every entry's graph holds, of each wrapper's kernel, as many nodes as
    the wrapper calls its replay adds to the counter (``per_run``, recorded
    at capture)."""
    from repro_torch.serving.graphs import COUNTED
    by_fn = dict(zip(COUNTED, range(len(COUNTED))))
    for entry in eng.entry_points.values():
        nodes = graph_kernel_nodes(entry)
        per_run = {name: entry.per_run[by_fn[fn]] for name, fn in wrappers().items()}
        check(all(nodes[name] == n for name, n in per_run.items()),
              f"{label}: {entry.name}'s graph has kernel nodes {nodes}; a replay "
              f"counts {per_run}")


@contextlib.contextmanager
def counted_replays(eng, replays, label="a counted window"):
    """Count each entry's replays inside the block into ``replays``
    ({entry: replays}); the table is frozen inside."""
    def wrap(entry, run):
        def counted():
            replays[entry] = replays.get(entry, 0) + 1
            return run()
        return counted
    with hooked_runs(eng, wrap, label):
        yield


def graph_launches(replays):
    """Each wrapper's kernel executions on the card over the counted
    replays: a replay runs every node of its graph once."""
    return {name: sum(n * graph_kernel_nodes(entry)[name] for entry, n in replays.items())
            for name in CARD_KERNELS}


def wrappers():
    """The three kernel wrappers by name; each counts its calls in
    ``launches``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rmsnorm import fused_rmsnorm
    return {"paged_attention": paged_attention, "flash_attention": flash_attention,
            "fused_rmsnorm": fused_rmsnorm}


def card_launches(prof):
    """How many times each wrapper's kernel shows in a profiled window's
    kernel events, by name. These may fall short of what ran: CUPTI can
    drop a record (one RMSNorm of 8,262 in one serve drive), so they are
    held to the graphs' count from above only."""
    from torch.autograd import DeviceType
    counts = dict.fromkeys(CARD_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, kern in CARD_KERNELS.items():
                if re.search(rf"\b{kern}\b", e.key):
                    counts[name] += e.count
    return counts


def expected_launches(L, groups, steps, passes, paged=True):
    """Each wrapper's calls in ``groups`` whole-prompt prefill groups,
    ``steps`` decode steps and ``passes`` chunk passes of an L-layer model:
    paged attention once a layer a decode step on a paged engine (never on
    a dense one, whose decode attention is plain PyTorch), flash attention
    once a layer a group, RMSNorm twice a layer and once more (the final
    norm) every forward pass."""
    return {"paged_attention": L * steps if paged else 0, "flash_attention": L * groups,
            "fused_rmsnorm": (2 * L + 1) * (groups + steps + passes)}


def graph_against_eager(eng, label):
    """Run the engine's next block twice from one state: the entry's eager
    callable, then (KV store and static inputs restored) the graph's
    replay. Tokens, validity and live mask must be identical and the KV
    store equal byte for byte outside the trash page (a page store) or the
    sink row (a dense store); prints what differs, and the host wall of
    each run (with a sync). Returns the entry's name."""
    from repro_torch.serving.graphs import COUNTED
    seen = []

    def wrap(entry, run):
        def compare():
            leaves = [(f"seg{i}.{key}", x) for i, seg in enumerate(eng.cache)
                      for key, x in seg.items()]
            pages0 = [x.clone() for _, x in leaves]
            inputs0 = entry.buf.clone()
            counts = [w.launches for w in COUNTED]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out_e = entry.eager().clone()
            torch.cuda.synchronize()
            eager_ms = (time.monotonic() - t0) * 1e3
            pages_e = [x.clone() for _, x in leaves]
            for w, n in zip(COUNTED, counts):          # a comparison, not the path
                w.launches = n
            for (_, x), x0 in zip(leaves, pages0):
                x.copy_(x0)
            entry.buf.copy_(inputs0)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out_g = run()
            torch.cuda.synchronize()
            graph_ms = (time.monotonic() - t0) * 1e3
            k = (out_g.shape[0] - 2) // 2
            parts = {"toks": slice(0, k), "valid": slice(k, 2 * k), "live_final": slice(2 * k, 2 * k + 1),
                     "ok": slice(2 * k + 1, None)}
            out_diff = [part for part, sl in parts.items()
                        if not torch.equal(out_e[sl], out_g[sl])]
            # every page but the trash page (the last), which no table maps,
            # or every slot row but the dense store's sink row (the last):
            # rows aimed there (dead lanes, pad rows, length-0 chunk passes)
            # collide on its slots, and which of them lands is not ordered.
            # Layer by layer: a whole leaf's byte mask, summed, would take
            # eight bytes a byte of the store (27 GB for llama2-13b's K)
            page_diff, trash = [], 0
            for (name, x), xe in zip(leaves, pages_e):
                nbytes, err = 0, 0.0
                for layer, layer_e in zip(x, xe):
                    differ = layer.view(torch.uint8) != layer_e.view(torch.uint8)
                    trash += int(differ[-1].sum())
                    n = int(differ[:-1].sum())
                    if n:
                        nbytes += n
                        err = max(err, (layer[:-1].float() - layer_e[:-1].float())
                                  .abs().max().item())
                if nbytes:
                    page_diff.append(f"{name}: {nbytes} bytes differ, max abs {err:.3e}")
            seen.append((entry.name, k, out_diff, page_diff, trash, eager_ms, graph_ms))
            return out_g
        return compare

    with hooked_runs(eng, wrap):
        eng.step()
    check(len(seen) == 1, f"{label}: graph against eager ran {len(seen)} entries")
    name, k, out_diff, page_diff, trash, eager_ms, graph_ms = seen[0]
    store, sink = ("page store", "trash page") if eng.paged else ("dense store", "sink row")
    print(f"graphs {label}: {name} run eagerly and replayed from one state: outputs "
          f"{'identical' if not out_diff else 'differ in ' + str(out_diff)}; {store} "
          f"{'equal byte for byte' if not page_diff else 'differs: ' + '; '.join(page_diff)} "
          f"outside the {sink} ({trash} bytes of the {sink} differ); "
          f"host wall with sync {eager_ms / k:.2f} ms/step eager, {graph_ms / k:.2f} ms/step "
          f"replayed ({k} steps)")
    check(not out_diff and not page_diff,
          f"{label}: {name} replay differs from its eager run: {out_diff} {page_diff}")
    return name


def device_report(prof, steps):
    """(kernel ms, kernel ms by name part, top-kernel summary) per step, from
    torch.profiler's kernel events."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps

    def by_name(part):
        return sum(e.self_device_time_total for e in kern if part in e.key) / 1e3 / steps

    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    names = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms "
                      f"x{e.count / steps:g}" for e in top)
    return kern_ms, by_name, names


def profile_block(eng, label):
    """Where a decode step's time goes, through the engine's entries: the
    scenario runs once to build its entries, then again with the table
    frozen. Its first block runs graph against eager; one block is timed
    bare, with CUDA events around its replay (the graph's device time);
    one more under torch.profiler (kernel events). On a chunked engine the
    blocks are mixed: 5, 6, then 7 lanes decode while a late 100-token
    prompt streams in chunks."""
    from repro_torch.analysis import frozen_entry_points
    from torch.profiler import ProfilerActivity, profile
    mixed = eng.chunked_admission
    n_first = eng.n_slots - (3 if mixed else 0)
    prompts = [[1 + (7 * i + j) % 250 for j in range(100)] for i in range(eng.n_slots)]

    def block_ms(late):
        if mixed:       # arrives while lanes decode: admitted as a chunk task
            eng.submit(next(late), max_new_tokens=40)
        torch.cuda.synchronize()
        steps0, chunks0, passes0 = eng.steps, eng.chunk_steps, eng.chunk_passes
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        k = eng.steps - steps0
        check(not mixed or eng.chunk_steps > chunks0, "profiled block streamed no chunk")
        return (time.monotonic() - t0) * 1e3 / k, k, eng.chunk_passes - passes0

    def scenario(measure):
        for p in prompts[:n_first]:
            eng.submit(p, max_new_tokens=40)
        eng.step()                                 # prefill + first block
        late = iter(prompts[n_first:])
        if not measure:
            for _ in range(3):
                block_ms(late)
            eng.run_to_completion()
            eng.finished = []
            return None
        if mixed:
            eng.submit(next(late), max_new_tokens=40)
        graph_against_eager(eng, label)
        events = []
        with timed_runs(eng, events):
            bare_ms, k_bare, _ = block_ms(late)
        replay_ms = replay_span(events, bare_ms * k_bare, f"{label} block") / k_bare
        counts0 = [kern.launches for kern in wrappers().values()]
        replays = {}
        with counted_replays(eng, replays), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms, k, passes = block_ms(late)
        torch.cuda.synchronize()
        counted = {name: kern.launches - n for (name, kern), n
                   in zip(wrappers().items(), counts0)}
        ran = graph_launches(replays)
        card = card_launches(prof)
        want = expected_launches(eng.cfg.n_layers, 0, k, passes, eng.paged)
        check(ran == counted == want and all(card[n] <= ran[n] for n in ran),
              f"{label}: profiled block of {k} steps and {passes} chunk passes ran "
              f"kernels {ran} by its graph, {card} in the profiler's events; counted "
              f"{counted}, expected {want}")
        check(mixed or int(eng.live.sum()) == eng.n_slots, "profiled block lost a lane")
        eng.run_to_completion()
        eng.finished = []
        return bare_ms, replay_ms, prof_ms, k, prof, (ran, card)

    scenario(measure=False)
    with frozen_entry_points(eng, f"{label} profile, after its warm-up"):
        bare_ms, replay_ms, prof_ms, k, prof, (ran, card) = scenario(measure=True)
    kern_ms, by_name, top = device_report(prof, k)
    what = (f"mixed block of {n_first + 1} decoding lanes + one 100-token prompt in "
            f"{eng.prefill_chunk}-token chunks" if mixed
            else f"decode block of {eng.n_slots} lanes")
    attn = (f"paged_attention {by_name('paged_attention'):.3f} ms/step" if eng.paged
            else "dense attention: plain PyTorch, timed alone below")
    print(f"profile {label}: {what} x {k} steps, replayed: wall "
          f"{bare_ms:.2f} ms/step bare, {prof_ms:.2f} under the profiler; device "
          f"kernel time {kern_ms:.3f} ms/step (torch.profiler; busy share "
          f"{kern_ms / bare_ms:.3f} of the bare wall); replay device time "
          f"{replay_ms:.3f} ms/step (CUDA events; busy share {replay_ms / bare_ms:.3f}); "
          f"{attn}, rmsnorm {by_name('rmsnorm'):.3f} ms/step; kernels run by the replayed graph "
          f"{ran} (= counted = expected; in the profiler's events {card}); top kernels: "
          f"{top}")


def profile_prefill(cfg, params, B=8, T=128):
    """One whole-prompt prefill group at the main path's shape (8 prompts of
    128 tokens, written into pages) through an engine's entry
    ``prefill_bs8_p128``: built once, then timed bare (host wall of the
    dispatch, with its first-token copy; CUDA events around the replay),
    then under torch.profiler. Also the group's draw alone
    (``sample_logits_batched`` over (8, vocab) logits of greedy rows, as
    the entry runs it, replayed from a graph) and the host key's split
    (``host_split_ms``), the sampler's share of the group."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params, n_slots=B, max_len=1024, paged=True,
                          page_size=32, decode_block=8, device="cuda")
    prompts = [[1 + (5 * i + j) % 250 for j in range(T)] for i in range(B)]

    def group():
        for p in prompts:              # a budget of 1: the group's first token
            eng.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        groups0, t0 = eng.prefill_groups, time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        check(eng.prefill_groups == groups0 + 1 and len(eng.finished) == B,
              "prefill profile: not one group of finished requests")
        eng.finished = []
        return wall

    group()
    check(f"prefill_bs{B}_p{T}" in eng.entry_points, f"no prefill_bs{B}_p{T} entry")
    events = []
    with timed_runs(eng, events):
        bare_ms = group()
    replay_ms = replay_span(events, bare_ms, "prefill profile")
    counts0 = [kern.launches for kern in wrappers().values()]
    replays = {}
    with counted_replays(eng, replays), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        group()
    torch.cuda.synchronize()
    counted = {name: kern.launches - n for (name, kern), n
               in zip(wrappers().items(), counts0)}
    ran = graph_launches(replays)
    card = card_launches(prof)
    want = expected_launches(cfg.n_layers, 1, 0, 0)
    check(ran == counted == want and all(card[n] <= ran[n] for n in ran),
          f"prefill profile: the group ran kernels {ran} by its graph, {card} in the "
          f"profiler's events; counted {counted}, expected {want}")
    kern_ms, by_name, top = device_report(prof, 1)
    draw_ms = group_draw_ms(eng, B)
    split_ms = host_split_ms()
    print(f"profile prefill group B={B} T={T}, replayed: wall {bare_ms:.2f} ms bare "
          f"(of which the draw alone {draw_ms:.4f} ms device, the host key's split "
          f"{split_ms:.4f} ms host: {(draw_ms + split_ms) / bare_ms:.3f} of the wall); "
          f"device kernel time {kern_ms:.3f} ms (torch.profiler; busy share "
          f"{kern_ms / bare_ms:.3f} of the bare wall); replay device time {replay_ms:.3f} "
          f"ms (CUDA events; busy share {replay_ms / bare_ms:.3f}); flash_attention "
          f"{by_name('flash_attention'):.3f} ms, rmsnorm {by_name('rmsnorm'):.3f} ms; "
          f"kernels run by the replayed graph {ran} (= counted = expected; in the "
          f"profiler's events {card}); top kernels: {top}; entries {len(eng.entry_points)}, captures "
          f"{eng.graphs.captures} in {eng.graphs.capture_ms:.0f} ms, graph pool "
          f"{eng.graphs.pool_bytes / 2**20:.1f} MiB")


def group_draw_ms(eng, B):
    """Device ms of a prefill group's draw alone, as its entry runs it:
    ``sample_logits_batched`` over (B, vocab) logits of the model's dtype,
    every row greedy (temperature 0, top_k 0, top_p 1), 30 calls replayed
    from one CUDA graph (``cuda_ms``)."""
    from repro_torch.serving import prng
    from repro_torch.serving.sampler import sample_logits_batched
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(B, eng.cfg.vocab_size, generator=gen, device="cuda").to(
        eng.params["embed"]["tok"].dtype)
    key = prng.split(prng.PRNGKey(SEED, "cuda"))[1]
    temp, topp = torch.zeros(B, device="cuda"), torch.ones(B, device="cuda")
    topk = torch.zeros(B, dtype=torch.int64, device="cuda")
    return cuda_ms(lambda: sample_logits_batched(logits, key, temp, topk, topp))


def host_split_ms(calls=500):
    """Host ms of one split of the engine's host key (a CPU tensor, split
    once a prefill group and once a block before the dispatch, while the
    card waits), mean of ``calls`` splits."""
    from repro_torch.serving import prng
    key = prng.PRNGKey(SEED)
    for _ in range(10):
        key, _ = prng.split(key)
    t0 = time.perf_counter()
    for _ in range(calls):
        key, _ = prng.split(key)
    return (time.perf_counter() - t0) * 1e3 / calls


def sampling_modes():
    """The sampled runs' three kinds of request, one a third of the
    traffic: greedy, temperature 0.8, and the reference benchmark's
    ``serve.engine_decode_sampled`` (temperature 0.9, top_k 50, top_p
    0.95)."""
    from repro_torch.serving.sampler import SamplingParams
    return {"greedy": SamplingParams(), "temp": SamplingParams(temperature=0.8),
            "full": SamplingParams(temperature=0.9, top_k=50, top_p=0.95)}


def sampler_alone_ms(eng):
    """One decode step's sampler alone, each mode: the step's key split and
    the draw over (n_slots, vocab) logits of the model's dtype (8 lanes of
    the mode's parameters, folded by slot id). {mode: (device ms a step, 30
    steps replayed from one CUDA graph (``cuda_ms``); kernel ms a step,
    torch.profiler's sum over 3 eager steps; its top kernels)}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import prng
    B, V = eng.n_slots, eng.cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(B, V, generator=gen, device="cuda").to(eng.params["embed"]["tok"].dtype)
    key = prng.PRNGKey(SEED, "cuda")
    rows = torch.arange(B, device="cuda")
    out = {}
    for mode, sp in sampling_modes().items():
        fn = eng._SAMPLE_FNS[mode]
        params = (torch.full((B,), sp.temperature, device="cuda"),
                  torch.full((B,), sp.top_k, device="cuda"),
                  torch.full((B,), sp.top_p, device="cuda"))

        def step():
            keys = prng.split(key, 2)
            return fn(logits, keys[1], *params, fold_ids=rows)
        graph_ms = cuda_ms(step)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        kern_ms, _, top = device_report(prof, 3)
        out[mode] = (graph_ms, kern_ms, top)
    return out


def profile_modes(eng, label):
    """The sampler's cost on the card: a decode block of ``n_slots`` lanes x
    8 steps in each mode (every lane greedy, every lane temperature 0.8,
    every lane top-k/top-p), through ``decode_bs8_k8_{greedy,temp,full}``.
    Each mode's scenario runs once to build its entries; then a ``_full``
    block runs graph against eager; then the three modes are timed in
    three turns (greedy, temp, full, full, temp, greedy, greedy, temp,
    full): host wall per step and the replay's device span (CUDA events).
    Prints each mode's ms a step, its difference from greedy and share of
    the step, its kernel nodes a step beyond the greedy graph's, and the
    sampler's device time alone (``sampler_alone_ms``). Then one block of
    each mode under torch.profiler: kernel time a step, cuBLAS's share.
    """
    from repro_torch.analysis import frozen_entry_points
    from torch.profiler import ProfilerActivity, profile
    modes = sampling_modes()
    prompts = [[1 + (7 * i + j) % 250 for j in range(100)] for i in range(eng.n_slots)]
    k = eng.decode_block

    def scenario(mode, measure=None):
        for p in prompts:
            eng.submit(p, max_new_tokens=40, sampling=modes[mode])
        eng.step()                                 # prefill + first block
        if measure is not None:
            measure()
        eng.run_to_completion()
        eng.finished = []

    def timed(mode, spans):
        events = []
        torch.cuda.synchronize()
        steps0, t0 = eng.steps, time.monotonic()
        with timed_runs(eng, events):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        check(eng.steps - steps0 == k and int(eng.live.sum()) == eng.n_slots,
              f"{label} {mode}: the timed block ran {eng.steps - steps0} steps, "
              f"{int(eng.live.sum())} lanes live after it")
        name = f"decode_bs{eng.n_slots}_k{k}_{mode}"
        check([n for n, _, _ in events] == [name], f"{label}: timed {events}, not {name}")
        spans.setdefault(mode, []).append(
            (wall / k, replay_span(events, wall, f"{label} {mode}") / k))

    def profiled(mode):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
        torch.cuda.synchronize()
        kern_ms, by_name, _ = device_report(prof, k)
        kernels[mode] = (kern_ms, by_name("nvjet"))

    for mode in modes:
        scenario(mode)
    spans, kernels = {}, {}
    with frozen_entry_points(eng, f"{label}: the sampler profile after its warm-up"):
        scenario("full", lambda: graph_against_eager(eng, f"{label} top-k/top-p"))
        for mode in ("greedy", "temp", "full", "full", "temp", "greedy", "greedy", "temp",
                     "full"):
            scenario(mode, lambda: timed(mode, spans))
        for mode in modes:
            scenario(mode, lambda: profiled(mode))
    nodes = {mode: graph_kernel_nodes(eng.entry_points[f"decode_bs{eng.n_slots}_k{k}_{mode}"])
             ["all"] for mode in modes}
    alone = sampler_alone_ms(eng)
    mean = {mode: tuple(sum(x) / len(x) for x in zip(*runs)) for mode, runs in spans.items()}
    g_wall, g_span = mean["greedy"]
    print(f"profile {label} sampler: decode block of {eng.n_slots} lanes x {k} steps, "
          "replayed, ms a step (host wall with sync; replay device span, CUDA events), "
          "mean of three turns: " + "; ".join(
              f"decode_bs{eng.n_slots}_k{k}_{mode} wall {w:.3f} (runs "
              f"{', '.join(f'{x[0]:.3f}' for x in spans[mode])}), span {sp:.3f} "
              f"(runs {', '.join(f'{x[1]:.3f}' for x in spans[mode])}), "
              f"{sp - g_span:+.3f} ms against greedy (share of the span "
              f"{(sp - g_span) / sp:.3f}), graph kernel nodes {nodes[mode]} "
              f"({(nodes[mode] - nodes['greedy']) / k:g} a step beyond greedy's); "
              f"torch.profiler, one block: kernel time {kernels[mode][0]:.3f} ms a step, "
              f"of which cuBLAS (nvjet) {kernels[mode][1]:.3f}, the rest "
              f"{kernels[mode][0] - kernels[mode][1]:.3f}; the sampler alone "
              f"(split + draw, 8 x {eng.cfg.vocab_size}) {alone[mode][0]:.4f} ms a step "
              f"replayed from a graph, {alone[mode][1]:.4f} ms of kernels, top: "
              f"{alone[mode][2]}"
              for mode, (w, sp) in mean.items())
          + f" ({nvidia_smi()})")


def mixed_full_against_eager(eng, label):
    """A mixed block of top-k/top-p lanes (the chunk lane's first token drawn
    with the step's third key) run graph against eager: 5 lanes decode
    while a late 100-token top-k/top-p prompt streams in chunks. The
    scenario runs once to build its entries, then again to compare."""
    full = sampling_modes()["full"]
    n_first = eng.n_slots - 3
    prompts = [[1 + (7 * i + j) % 250 for j in range(100)] for i in range(n_first + 1)]

    def scenario(compare):
        for p in prompts[:n_first]:
            eng.submit(p, max_new_tokens=40, sampling=full)
        eng.step()                                 # prefill + first block
        eng.submit(prompts[n_first], max_new_tokens=40, sampling=full)
        name = graph_against_eager(eng, f"{label} top-k/top-p") if compare else None
        eng.run_to_completion()
        eng.finished = []
        return name

    scenario(False)
    name = scenario(True)
    check(name.startswith("mixed_") and name.endswith("_full"),
          f"{label}: the compared block ran {name}, not a mixed _full entry")


# ----------------------------------------------------------------------
# static checks: the port's lint and graph audit, and the card's sync count
# ----------------------------------------------------------------------

# seconds of the static checks (the lint and the reduced audit; the
# full-width audits inside the serve runs), summed on the last lines
STATIC_SECONDS = []
# the full-width entries audited so far, as (name, layout, KV dtype): the
# serve engines share their shapes and weights, so an entry of that key is
# the same program at the same shapes on every engine
AUDITED = set()
SYNC_WARNING = "called a synchronizing CUDA operation"
# the engine's two sanctioned device-to-host copies, by their source lines
SANCTIONED = {"block": "block = out.cpu().numpy()", "group": "firsts = out.tolist()"}


def static_phase():
    """(i) ``run_lint`` of this tree: no new finding, no stale baseline
    entry, the two budgeted copies; (ii) ``run_audit(device="cuda")``:
    reduced granite engines of the four variants on the card, each entry a
    CUDA graph, its eager callable audited on its dead inputs and its live
    staging (no float64, no host read, the store written in place, store
    writes in bounds): no issue, and the names equal to the committed
    inventory, which the CPU wrote."""
    from repro_torch.analysis import run_lint
    from repro_torch.analysis.graph_audit import run_audit
    t0 = time.monotonic()
    lint = run_lint(Path(__file__).resolve().parent)
    check(lint.rc == 0, f"static lint:\n{lint.render()}")
    allowed = sorted(f"{f.scope} ({f.snippet})" for f in lint.allowed)
    check(len(allowed) == 2, f"static lint: allowed {allowed}")
    t1 = time.monotonic()
    report = run_audit(device="cuda")
    check(report.rc == 0, f"static audit:\n{report.render()}")
    t2 = time.monotonic()
    STATIC_SECONDS.append(t2 - t0)
    print(f"static lint: {lint.render().splitlines()[-1]}; allowed {allowed}; "
          f"{t1 - t0:.1f} s")
    print(f"static audit, reduced granite on the card (entries captured, their eager "
          f"callables audited on dead and live inputs): "
          f"{report.render().splitlines()[-1]}; "
          f"{ {v: len(n) for v, n in report.audited.items()} } entries; names == the "
          f"committed inventory; {t2 - t1:.1f} s")


def audit_served(eng, label):
    """Checks f64, host_read, in_place and bounds of the graph audit on
    every entry a full-width engine built, each run eagerly on its dead
    inputs and its live staging (its last dispatch's), the store restored
    after: 0 issues. An entry whose (name, layout, KV dtype) an earlier
    serve engine's audit ran (``AUDITED``) is counted there: the same
    program at the same shapes over the same weights."""
    from repro_torch.analysis.graph_audit import audit_entry
    t0 = time.monotonic()
    names, issues = [], []
    for name in sorted(eng.entry_points):
        key = (name, eng.paged, eng.cfg.kv_cache_dtype or eng.cfg.dtype)
        if key not in AUDITED:
            AUDITED.add(key)
            names.append(name)
            issues += audit_entry(eng, eng.entry_points[name], label)
    check(not issues, f"static audit {label}:\n" + "\n".join(i.render() for i in issues))
    dt = time.monotonic() - t0
    STATIC_SECONDS.append(dt)
    print(f"static audit {label}: {len(names)} entries audited, 0 issues (the other "
          f"{len(eng.entry_points) - len(names)} on an earlier engine); {dt:.1f} s")


@contextlib.contextmanager
def counted_syncs(eng, label, port_only=False):
    """Count the card's syncs in the body, under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning shown: the
    dynamic counterpart of SPL001, at full width. They must be exactly the
    engine's sanctioned copies, one a decode block and one a prefill group
    (the ``decode_syncs`` and ``prefill_groups`` deltas), at their two
    source lines; the stack of any other sync is printed and fails the run.
    ``port_only``: only the syncs at the port's lines count (a fault drive,
    whose own checks, here, sync); its poisons and scrubs must add none."""
    from repro_torch.serving import engine as engine_module
    path = Path(engine_module.__file__).resolve()
    lines = path.read_text().splitlines()
    sites = {i + 1: kind for kind, text in SANCTIONED.items()
             for i, line in enumerate(lines) if line.strip() == text}
    check(sorted(sites.values()) == sorted(SANCTIONED), f"sync {label}: sites {sites}")
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            seen.append((filename, lineno, "".join(traceback.format_stack()[:-1])))

    blocks0, groups0 = eng.decode_syncs, eng.prefill_groups
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    blocks, groups = eng.decode_syncs - blocks0, eng.prefill_groups - groups0
    if port_only:
        seen = [x for x in seen if Path(x[0]).resolve().is_relative_to(path.parents[1])]
    at = dict.fromkeys(SANCTIONED, 0)
    extra = []
    for filename, lineno, stack in seen:
        kind = sites.get(lineno) if Path(filename).resolve() == path else None
        if kind is None:
            extra.append((filename, lineno, stack))
        else:
            at[kind] += 1
    for filename, lineno, stack in extra:
        print(f"sync {label}: a sync outside the sanctioned copies at "
              f"{filename}:{lineno}, stack:\n{stack}")
    check(not extra and at == {"block": blocks, "group": groups},
          f"sync {label}: {len(seen)} syncs ({at} at the sanctioned copies, "
          f"{len(extra)} elsewhere) for {blocks} decode blocks and {groups} prefill groups")
    where = " at the port's lines" if port_only else ""
    print(f"sync {label}: {len(seen)} syncs counted under set_sync_debug_mode(\"warn\")"
          f"{where} = {blocks} decode blocks + {groups} prefill groups ({at}; none "
          f"elsewhere)")


def scheduler_drive(eng, sampled=False, injector=None):
    """One drive of the main path's traffic: the 12 prompts through
    ``CarbonAwareScheduler`` on ``eng``, which renders each drawn directive
    level as the system prompt and caps the budget (64/48/32). The mix is
    uniform, as the serving launcher draws before the LP has level
    profiles, from one seed, so every drive sees the same levels, budgets
    and shapes. ``sampled``: request i carries the i % 3-th of
    ``sampling_modes``. ``injector``: the scheduler's fault injector.
    Returns the scheduler and the drive's wall seconds."""
    from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
    modes = list(sampling_modes().values())
    rng = np.random.default_rng(0)
    sched = CarbonAwareScheduler([eng], level_fn=lambda: int(rng.choice(3)),
                                 fault_injector=injector)
    for i, p in enumerate(PROMPTS):
        sched.submit(ServeRequest(0, p, max_new_tokens=64, max_new_by_level=(64, 48, 32),
                                  sampling=modes[i % 3] if sampled else modes[0]))
    t0 = time.monotonic()
    sched.run()
    torch.cuda.synchronize()
    return sched, time.monotonic() - t0


def check_measured_drive(eng, sched, label, launches, replays, plain, fwd):
    """The checks every measured serve drive passes: each request finished,
    none rejected, every token in the vocabulary, all three levels drawn;
    launches equal the forward passes ``fwd`` (prefill groups, decode
    steps, chunk passes) imply and the kernel nodes the replays ran; no
    plain version ran."""
    cfg, fin = eng.cfg, sched.finished
    check(not sched.rejected, f"{label}: rejected: {sched.rejected}")
    check(len(fin) == len(PROMPTS), f"{label}: {len(fin)} of {len(PROMPTS)} finished")
    check(all(0 <= t < cfg.vocab_size for f in fin for t in f.token_ids),
          f"{label}: token outside the vocabulary")
    check(all(f.gen_tokens >= 1 for f in fin), f"{label}: a request generated nothing")
    levels = sorted({f.directive_level for f in fin})
    check(levels == [0, 1, 2], f"{label}: directive levels {levels}")
    want = expected_launches(cfg.n_layers, *fwd, eng.paged)
    check(launches == want, f"{label}: launches {launches} != expected {want} from "
          f"{fwd[0]} prefill groups, {fwd[1]} decode steps, {fwd[2]} chunk passes")
    # what the card ran: each replay runs every kernel node of its graph
    ran = graph_launches(replays)
    check(ran == launches, f"{label}: the drive's {sum(replays.values())} replays ran "
          f"kernels {ran} by their graphs; counted {launches}")
    check(sum(plain.values()) == 0, f"{label}: plain versions called on the card: {plain}")


def in_order(sched):
    """The token streams of a drive's requests, in the order submitted."""
    return [f.token_ids for f in sorted(sched.finished, key=lambda f: f.rid)]


def serve(cfg, params, kv_int8, prefill_chunk, kernels, plain_calls, sampled=False,
          paged=True, faults=False, static=False):
    """One main-path run: 12 requests through the scheduler, driven once to
    build the entry table (every wrapper call of a capture runs here, and
    no plain version may) and again, with the table frozen, to measure.
    Returns the launches of each kernel in the measured drive, checked
    against the engine's forward passes and against the kernel nodes that
    the drive's replays ran, and the drive's token streams by rid.
    ``sampled``: a third of the requests greedy, a third temperature-only,
    a third top-k/top-p (``sampling_modes``); each drive starts from the
    engine's seed key, so the two drives must give identical streams; the
    profile is ``profile_modes``'s, and a chunked run's a mixed ``_full``
    block graph against eager (``mixed_full_against_eager``). ``paged``
    False: the dense layout (the reference's default engine), whose decode
    attention is plain PyTorch, so paged attention must launch 0 times; a
    whole-prompt run also runs a bucketed block (3 lanes of 8) graph
    against eager (``bucketed_against_eager``), and both time the dense
    attention against its bound (``dense_attention``). ``faults``: then
    one drive more with lanes poisoned (``fault_drive``). ``static``: every
    entry goes through the graph audit's checks (``audit_served``), and a
    whole-prompt bf16 run counts the syncs of its capture drive
    (``counted_syncs``)."""
    from repro_torch.serving import prng
    from repro_torch.serving.engine import InferenceEngine
    layout = dict(paged=True, page_size=32) if paged else {}
    eng = InferenceEngine(cfg, params, n_slots=8, max_len=1024, decode_block=8,
                          kv_int8=kv_int8, prefill_chunk=prefill_chunk, seed=SEED,
                          device="cuda", **layout)
    label = (f"{cfg.name} bf16{'' if paged else ' dense'} kv_int8={kv_int8}"
             + (f" prefill_chunk={prefill_chunk}" if prefill_chunk else "")
             + (" sampled" if sampled else ""))
    plain_calls.clear()
    sync_count = static and not (kv_int8 or prefill_chunk or sampled)
    with counted_syncs(eng, label) if sync_count else contextlib.nullcontext():
        sched0, warm_wall = scheduler_drive(eng, sampled)
    # the building drive is where Python runs through the wrappers (warm-up
    # and capture of every entry); a replay runs none
    check(not plain_calls, f"{label}: plain versions called while the entries were "
          f"built: {plain_calls}")
    names = set(eng.entry_points)
    check_graph_nodes(eng, label)
    captures, capture_ms = eng.graphs.captures, eng.graphs.capture_ms
    groups0, steps0, chunks0 = eng.prefill_groups, eng.steps, eng.chunk_steps
    passes0, tokens0 = eng.chunk_passes, eng.decode_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    plain_calls.clear()
    replays = {}
    eng.key = prng.PRNGKey(SEED)       # the same seed, run again
    with counted_replays(eng, replays, f"{label} measured drive"):
        sched, wall = scheduler_drive(eng, sampled)
    launches = {name: kern.launches for name, kern in kernels.items()}
    plain = dict(plain_calls)
    check(eng.graphs.captures == captures,
          f"{label}: {eng.graphs.captures - captures} captures in the measured drive")
    check(in_order(sched) == in_order(sched0),
          f"{label}: the same seed gave other streams in the measured drive than in "
          f"the building drive: (request, first differing token) "
          f"{first_differences(dict(enumerate(in_order(sched))), dict(enumerate(in_order(sched0))))}")
    groups = eng.prefill_groups - groups0
    steps = eng.steps - steps0
    chunks = eng.chunk_steps - chunks0
    passes = eng.chunk_passes - passes0
    fin = sched.finished
    check(not prefill_chunk or chunks > 0, f"{label}: no prompt chunk ran")
    check_measured_drive(eng, sched, label, launches, replays, plain,
                         (groups, steps, passes))
    # every dispatch of the frozen drive replayed a built entry, so each
    # reported its decode time (a dispatch that captures reports 0.0)
    decode_s = sum(f.decode_s for f in fin)
    dec_tokens = eng.decode_tokens - tokens0
    kv = eng.kv_stats()
    kv_line = (f"peak pages {kv['peak_pages_in_use']} of {kv['n_pages']} "
               f"({kv['peak_kv_bytes_in_use'] / 2**20:.1f} MiB KV)" if paged else
               f"dense store {kv['kv_bytes_capacity'] / 1e9:.3f} GB (8 slots x 1024 rows, "
               f"kpos included, the sink row not)")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {label}: {len(fin)} requests, levels "
          f"{[f.directive_level for f in fin]}, gen tokens {[f.gen_tokens for f in fin]}; "
          f"forward passes: {groups} prefill groups, {steps} decode steps, {chunks} "
          f"chunks in {passes} chunk passes; launches {launches} (= expected = the "
          f"kernel nodes run by the drive's {sum(replays.values())} replays), plain calls "
          f"{plain or 0} (building drive 0); decode tokens {dec_tokens} in {decode_s:.3f} s = "
          f"{dec_tokens / decode_s:.1f} tok/s (replayed dispatches only); wall {wall:.3f} s "
          f"({sum(f.gen_tokens for f in fin) / wall:.1f} gen tok/s; the building drive "
          f"{warm_wall:.3f} s); {kv_line}; peak device memory "
          f"{peak_gib:.2f} GiB" + ("; the same seed twice: identical streams" if sampled
                                   else ""))
    print(f"entries {label}: {len(names)} entries {sorted(names)}; {captures} captures in "
          f"{capture_ms:.0f} ms; graph pool {eng.graphs.pool_bytes / 2**20:.1f} MiB")
    if not paged and not prefill_chunk:
        bucketed_against_eager(eng, label)
    if not sampled:
        profile_block(eng, label)
    elif prefill_chunk:
        mixed_full_against_eager(eng, label)
    else:
        profile_modes(eng, label)
    check_graph_nodes(eng, label)
    print(f"entries {label} after the profile: {len(eng.entry_points)} entries, "
          f"{eng.graphs.captures} captures in {eng.graphs.capture_ms:.0f} ms, graph pool "
          f"{eng.graphs.pool_bytes / 2**20:.1f} MiB")
    if not paged:
        dense_decode_check(eng, label)
        dense_attention(eng, label)
    if static:
        audit_served(eng, label)
    streams = {f.rid: f.token_ids for f in fin}
    if faults:
        t0 = time.monotonic()
        for name, n in fault_drive(eng, label, streams, kernels, plain_calls).items():
            launches[name] += n
        print(f"faults {label}: {time.monotonic() - t0:.1f} s")
    return launches, streams


def fault_drive(eng, label, clean, kernels, plain_calls):
    """The main path's traffic once more on the served engine, with
    ``decode.nonfinite`` armed at occurrences (0, 5): the lanes consulted
    first and sixth are filled with NaN. Gates: the in-block verdict
    quarantines exactly the poisoned lanes; every request is served, none
    rejected; each fill writes only its lane (right after each quarantine
    the lane's pages or row read 0 in every float leaf, every other page or
    row byte-equal; ``checked_fills``); nothing non-finite left at drain;
    launches held to the forward passes and to the kernel nodes the
    replays ran (entries built here included), no plain call. Prints the
    share of untouched streams equal to ``clean`` (the measured drive's),
    the retried ones against theirs, and the poison and scrub times.
    Returns the drive's launches."""
    from repro_torch.serving import prng
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
    inj = FaultInjector(FaultPlan([FaultSpec("decode.nonfinite", "*", occurrences=(0, 5))]))
    fills = []
    checked_fills(eng, fills)
    for kern in kernels.values():
        kern.launches = 0
    plain_calls.clear()
    groups0, steps0, passes0 = eng.prefill_groups, eng.steps, eng.chunk_passes
    syncs0, entries0 = eng.decode_syncs, len(eng.entry_points)
    replays = {}
    eng.key = prng.PRNGKey(SEED)
    tag = f"faults {label}"
    try:
        with counted_entry_runs(replays), counted_syncs(eng, tag, port_only=True):
            sched, wall = scheduler_drive(eng, injector=inj)
    finally:
        del eng._fill_lane
    launches = {name: kern.launches for name, kern in kernels.items()}
    plain = dict(plain_calls)
    poisoned = [int(e.target) for e in inj.events if e.point == "decode.nonfinite"]
    caught = [st.rid for reason, st in sched.fault_events if reason == "decode.nonfinite"]
    check(len(poisoned) == 2 and caught == poisoned,
          f"{tag}: poisoned {poisoned}, quarantined {caught}")
    check(not sched.rejected and len(sched.finished) == len(PROMPTS),
          f"{tag}: {len(sched.finished)} served, rejected {sched.rejected}")
    check([v != v for _, v, *_ in fills].count(True) == len(poisoned)
          and [v == 0.0 for _, v, *_ in fills].count(True) == len(caught),
          f"{tag}: fills {[(sl, v) for sl, v, *_ in fills]}")
    check(store_finite(eng), f"{tag}: non-finite values left in the store at drain")
    check(not eng.paged or (eng._committed, eng.pages.pages_in_use()) == (0, 0),
          f"{tag}: pages held at drain")
    groups, steps = eng.prefill_groups - groups0, eng.steps - steps0
    passes = eng.chunk_passes - passes0
    want = expected_launches(eng.cfg.n_layers, groups, steps, passes, eng.paged)
    check(launches == want, f"{tag}: launches {launches} != expected {want}")
    check_graph_nodes(eng, tag)
    ran = graph_launches(replays)
    check(ran == launches, f"{tag}: its replays ran kernels {ran}; counted {launches}")
    check(sum(plain.values()) == 0, f"{tag}: plain versions called: {plain}")
    fin = {f.rid: f for f in sched.finished}
    retried = sorted(rid for rid, f in fin.items() if f.retries)
    untouched = [rid for rid in fin if rid not in poisoned]
    equal = sum(fin[rid].token_ids == clean.get(rid) for rid in untouched)
    poison_ms = [round(f[3], 3) for f in fills if f[1] != f[1]]
    scrub_ms = [round(f[3], 3) for f in fills if f[1] == 0.0]
    # the verdict's own work a step, as a block's graph runs it: isfinite
    # and all over the lanes' logits, folded into the carried verdict; and
    # the greedy full-bucket block's kernel nodes a step
    logits = torch.randn(eng.n_slots, eng.cfg.vocab_size, device="cuda").to(
        eng.params["embed"]["tok"].dtype)
    ok = torch.ones(eng.n_slots, dtype=torch.bool, device="cuda")
    live = ok.clone()
    verdict_ms = cuda_ms(lambda: ok & (torch.isfinite(logits).all(-1) | ~live))
    greedy = eng.entry_points.get(f"decode_bs{eng.n_slots}_k{eng.decode_block}_greedy")
    nodes = (graph_kernel_nodes(greedy)["all"] / eng.decode_block if greedy is not None
             else "not built")
    print(f"{tag}: 12 served, none rejected; poisoned rids {poisoned} = quarantined "
          f"{caught}; retried {retried} ({[fin[r].retries for r in retried]} retries); "
          f"{equal} of {len(untouched)} untouched streams equal to the measured drive's; "
          f"poisoned requests' tokens equal to their clean ones: "
          f"{[fin[r].token_ids == clean.get(r) for r in poisoned]}; fills lane-only, "
          f"(slot, value, rows) {[(f[0], f[1], len(f[2])) for f in fills]}; poison ms "
          f"{poison_ms}, scrub ms {scrub_ms}; {eng.decode_syncs - syncs0} syncs for "
          f"{groups} prefill groups and {steps} decode steps; entries built here "
          f"{len(eng.entry_points) - entries0}; launches {launches} (= expected = the "
          f"replays' kernel nodes), plain calls {plain or 0}; wall {wall:.3f} s; the "
          f"verdict alone {verdict_ms:.4f} ms a step over ({eng.n_slots}, "
          f"{eng.cfg.vocab_size}) logits; the greedy block's graph {nodes} kernel nodes "
          f"a step")
    return launches


def dispatch_log(eng):
    """Log each dispatch of ``eng`` into the returned list: (entry name,
    {rid: (slot, tokens the request held before it)}) over a prefill
    group's rows, or a block's live lanes and its chunk lane (instance
    attributes over ``_prefill_group`` and ``_fused_for``)."""
    log = []
    fused_for, prefill_group = eng._fused_for, eng._prefill_group

    def fused(k, mode, bs, chunk_c):
        entry, warm = fused_for(k, mode, bs, chunk_c)
        task = eng._task
        log.append((entry.name, {st.rid: (i, len(st.generated))
                                 for i, st in enumerate(eng.slots) if st is not None
                                 and (eng.live[i] or (task is not None and task.slot == i))}))
        return entry, warm

    def group(plen, grp):
        npad = 1 << max(len(grp) - 1, 0).bit_length()
        log.append((f"prefill_bs{npad}_p{plen}", {st.rid: (slot, 0) for slot, st, _ in grp}))
        return prefill_group(plen, grp)

    eng._fused_for, eng._prefill_group = fused, group
    return log


def emitted_by(log, rid, t):
    """Where token ``t`` of ``rid``'s last attempt came from in ``log``: its
    entry, the step of the block that emitted it, and the dispatch's
    requests as (slot, rid)."""
    i = max(j for j, (name, lanes) in enumerate(log)
            if name.startswith("prefill_") and rid in lanes)
    step = 0
    if t > 0:
        i = max(j for j in range(i + 1, len(log))
                if rid in log[j][1] and log[j][1][rid][1] <= t)
        step = t - log[i][1][rid][1]
    name, lanes = log[i]
    return name, step, sorted((slot, r) for r, (slot, _) in lanes.items())


# (arch, dtype) of the fault drives ``fault_divergence`` runs: the paper's
# model in bf16, where the parting was seen, then llama2-7b in bf16 and in
# fp32 (its fp32 weights, 27 GB, fit the card beside a store)
DIVERGENCE_RUNS = (("llama2_13b", "bfloat16"), ("llama2_7b", "bfloat16"),
                   ("llama2_7b", "float32"))


def fault_divergence():
    """Whether the full-width fault drives' streams part from the clean
    drive's by bf16 arithmetic under another batch composition. For each
    (arch, dtype) of ``DIVERGENCE_RUNS`` and both layouts: the main path's
    traffic driven clean (building the entries), then again from the same
    seed with ``decode.nonfinite`` armed at occurrences (0, 5), as
    ``fault_drive`` arms it. Prints how many untouched and retried streams
    equal their clean ones, and for each stream that parts its first
    parting token: the request, the token's index, and in each drive the
    entry (bucket, block length) and step that emitted it and the requests
    beside it. Not part of ``main``; run it alone on a card:

        python3 -c "import chip_smoke; chip_smoke.fault_divergence()"
    """
    check(torch.cuda.is_available(), "fault_divergence needs the card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.serving import prng
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.load()
    smi = nvidia_smi()
    for arch, dtype in DIVERGENCE_RUNS:
        t0 = time.monotonic()
        cfg, params = build_model(arch, dtype)
        for paged in (True, False):
            layout = dict(paged=True, page_size=32) if paged else {}
            eng = InferenceEngine(cfg, params, n_slots=8, max_len=1024, decode_block=8,
                                  seed=SEED, device="cuda", **layout)
            log = dispatch_log(eng)
            sched, _ = scheduler_drive(eng)
            clean = {f.rid: f.token_ids for f in sched.finished}
            n_clean = len(log)
            inj = FaultInjector(FaultPlan([FaultSpec("decode.nonfinite", "*",
                                                     occurrences=(0, 5))]))
            eng.key = prng.PRNGKey(SEED)
            sched, _ = scheduler_drive(eng, injector=inj)
            clean_log, fault_log = log[:n_clean], log[n_clean:]
            poisoned = sorted(int(e.target) for e in inj.events
                              if e.point == "decode.nonfinite")
            fin = {f.rid: f.token_ids for f in sched.finished}
            check(len(fin) == len(PROMPTS) and not sched.rejected,
                  f"divergence {arch}: {len(fin)} served, rejected {sched.rejected}")
            untouched = [rid for rid in fin if rid not in poisoned]
            tag = f"divergence {cfg.name} {dtype} {'paged' if paged else 'dense'}"
            print(f"{tag}: poisoned {poisoned}; untouched streams equal to the clean "
                  f"drive's: {sum(fin[r] == clean[r] for r in untouched)} of "
                  f"{len(untouched)}; retried streams equal: "
                  f"{[fin[r] == clean[r] for r in poisoned]}; dispatches clean "
                  f"{len(clean_log)}, fault {len(fault_log)} ({smi})")
            for rid, t in first_differences(fin, clean):
                c_name, c_step, c_with = emitted_by(clean_log, rid, t)
                f_name, f_step, f_with = emitted_by(fault_log, rid, t)
                print(f"{tag}: rid {rid} parts at token {t} of {len(clean[rid])} "
                      f"(clean {clean[rid][t] if t < len(clean[rid]) else None}, fault "
                      f"{fin[rid][t] if t < len(fin[rid]) else None}); clean: {c_name} "
                      f"step {c_step} with (slot, rid) {c_with}; fault: {f_name} step "
                      f"{f_step} with {f_with}")
            del eng, sched, log, clean_log, fault_log
            free_device_memory()
        del params
        free_device_memory()
        print(f"{tag.rsplit(' ', 1)[0]}: {time.monotonic() - t0:.1f} s")


def bucketed_against_eager(eng, label):
    """A dense decode block in a bucket smaller than the slots (3 lanes of
    8 in a bucket of 4, one pad row aimed at the sink row) run graph
    against eager: the scenario runs once to build its entries, then again
    to compare (``graph_against_eager``; the sink row is the store's last
    row, which the comparison leaves out as it leaves out the trash page)."""
    prompts = [[1 + (7 * i + j) % 250 for j in range(100)] for i in range(3)]

    def scenario(compare):
        for p in prompts:
            eng.submit(p, max_new_tokens=40)
        eng.step()                                 # prefill + first block
        name = graph_against_eager(eng, f"{label} bucketed") if compare else None
        eng.run_to_completion()
        eng.finished = []
        return name

    scenario(False)
    name = scenario(True)
    check(name.startswith("decode_bs4_"), f"{label}: the compared block ran {name}, "
          "not a bucket of 4")


def dense_decode_check(eng, label):
    """The dense decode attention on the engine's own store, gated: one
    middle layer's ``attention.attend_rows`` after the drives (the K/V the
    serve runs wrote, rows of many lengths) against an fp32 computation of
    the same attention that shares no code with it: each row's valid keys
    picked by its ``kpos`` in a Python loop, fp32 matmuls, and the
    reference's roundings (scores and P to bf16). Read three ways: the
    whole batch in place (the engine's full bucket), the whole batch
    through a gather, and a bucket naming slots 6, 1 and 3 with a pad lane
    on the sink row (the engine's smaller buckets). Even rows query at
    their last written position, odd rows halfway, so the causal mask cuts
    written rows. Held to 2**-6 of max(1, max |reference|), two bf16 ulps
    of the output: a wrong row or mask moves outputs by O(|v|)."""
    from repro_torch.models import attention as A
    from repro_torch.models.common import torch_dtype
    cfg, n = eng.cfg, eng.n_slots
    li = cfg.n_layers // 2
    layer = {key: x[li] for key, x in eng.cache[0].items()}
    kv_h, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    last = layer["kpos"][:n].max(dim=1).values
    idx = torch.arange(n, device="cuda")
    pos = torch.where(idx % 2 == 0, last, last // 2)
    written = [b for b in range(n) if int(last[b]) >= 0]
    check(len(written) == n, f"{label}: the drives left slot rows unwritten "
          f"({n - len(written)} of {n})")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(n, 1, cfg.n_heads, d, generator=gen,
                    device="cuda").to(torch_dtype(cfg))

    def reference(b, r):
        kp = layer["kpos"][r]
        sel = (kp >= 0) & (kp <= pos[b])
        k, v = layer["k"][r][sel].float(), layer["v"][r][sel].float()
        if "k_scale" in layer:
            k = k * layer["k_scale"][r][sel][..., None]
            v = v * layer["v_scale"][r][sel][..., None]
        s = torch.einsum("kgd,nkd->kgn", q[b, 0].float().view(kv_h, g, d), k)
        p = torch.softmax(s.to(torch.bfloat16).float() / math.sqrt(d), dim=-1)
        return torch.einsum("kgn,nkd->kgd", p.to(torch.bfloat16).float(), v)

    want = torch.stack([reference(b, b) for b in range(n)])
    bucket = [6, 1, 3]
    pad = torch.tensor(bucket + [0], device="cuda")
    reads = {
        "in place": A.attend_rows(layer, q, pos, idx, in_place=True)[:, 0],
        "gathered": A.attend_rows(layer, q, pos, idx)[:, 0],
        "bucket [6, 1, 3, sink]": A.attend_rows(
            layer, q[pad], pos[pad], torch.tensor(bucket + [n], device="cuda"))[:3, 0],
    }
    tol = 2.0 ** -6 * max(1.0, want.abs().max().item())
    errs = {}
    for how, got in reads.items():
        ref = want[bucket] if how.startswith("bucket") else want
        errs[how] = (got.float() - ref).abs().max().item()
        check(errs[how] <= tol, f"dense decode {label} {how}: max abs err "
              f"{errs[how]:.3e} against the fp32 computation, tolerance {tol:.3e}")
    print(f"dense decode check {label}: layer {li} of the served store, {n} rows "
          f"(queries at the last and the middle position), max abs err "
          + ", ".join(f"{how} {e:.3e}" for how, e in errs.items())
          + f" against fp32 with the reference's bf16 roundings, tolerance {tol:.3e}: ok")


def dense_attention(eng, label):
    """The dense decode attention of one step alone (``attention.
    _cache_write`` and ``attend_rows`` of one layer: the new token's K/V
    written, then 8 queries over their slots' whole rows of 1024), timed
    by CUDA-graph replay on the engine's layer-0 store (its K/V from the
    drives) and multiplied by the layer count, against its bound: every K
    and V byte of the 8 rows of 1024 tokens read once a layer, over the
    card's memory rate (kpos, 4 bytes a row against K/V's 20,480, is left
    out). The plain PyTorch reads the rows and rounds the scores as the
    reference does; it is no kernel of the port's own."""
    from repro_torch.models import attention as A
    from repro_torch.models.common import torch_dtype
    cfg, B = eng.cfg, eng.n_slots
    layer = {key: x[0] for key, x in eng.cache[0].items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch_dtype(cfg)
    q = torch.randn(B, 1, cfg.n_heads, cfg.head_dim, generator=gen, device="cuda").to(dt)
    k_new = torch.randn(B, 1, cfg.n_kv_heads, cfg.head_dim, generator=gen,
                        device="cuda").to(dt)
    v_new = torch.randn_like(k_new)
    pos = torch.arange(B, device="cuda") * 100 + 200
    rows = torch.arange(B, device="cuda")

    def step():
        A._cache_write(layer, k_new, v_new, pos, rows)
        return A.attend_rows(layer, q, pos, rows, in_place=True)

    ms = cuda_ms(step) * cfg.n_layers
    kv_bytes = sum(layer[key][:B].numel() * layer[key].element_size()
                   for key in ("k", "v")) * cfg.n_layers
    bound = kv_bytes / HBM_BYTES_PER_S * 1e3
    print(f"dense attention {label}: {ms:.3f} ms a decode step ({cfg.n_layers} layers x "
          f"{ms / cfg.n_layers * 1e3:.1f} us, CUDA-graph replay) against its bound "
          f"{bound:.3f} ms ({kv_bytes / 1e9:.3f} GB of K/V over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; share {bound / ms:.3f})")
    return ms, bound


def dense_against_paged(cfg, chunk, dense, paged):
    """The share of the dense run's streams equal to the paged bf16 run's on
    the same traffic, printed, not gated: in bf16 the dense decode's
    ``_sdpa`` rounds scores and P to bf16 (the reference's arithmetic),
    where the paged kernel keeps them in fp32, so a near-tie may part."""
    same = sum(dense[rid] == paged[rid] for rid in paged)
    print(f"serve {cfg.name} bf16 dense against paged"
          + (f" prefill_chunk={chunk}" if chunk else "") + f": {same} of {len(paged)} "
          f"streams identical; (request, first differing token) "
          f"{first_differences(dense, paged)}")


def cache_counters(eng):
    """The prefix cache's counters, cumulative over the engine's life."""
    return {"prefill_tokens_cached": eng.prefill_tokens_cached,
            "pages_adopted": eng.pages.pages_adopted,
            "cow_copies": eng.pages.cow_copies,
            "cache_evictions": eng.pages.cache_evictions}


def first_differences(got, want):
    """[(rid, first differing token)] of the streams in ``got`` that differ
    from ``want``'s."""
    return [(rid, next((i for i, (a, b) in enumerate(zip(g, want[rid])) if a != b),
                       min(len(g), len(want[rid]))))
            for rid, g in got.items() if g != want[rid]]


def serve_prefix(cfg, params, kernels, plain_calls, off_streams, chunked_streams):
    """The main path's traffic on a prefix-cache engine (bf16 KV). The
    engine keeps its index across drives (released prompt pages stay
    cached), so a warm drive hits where a cold one prefilled, and runs
    mixed entries a cold drive may not build: a cold drive and a warm one
    build the table, a second warm drive is measured with it frozen, its
    launches held as in ``serve``. Each drive's cache counters are printed
    and its ledger must be clean at drain; the measured drive must hit.
    The share of streams identical to the prefix-off bf16 run
    (``off_streams``) is printed, not gated: a hit computes its suffix in
    the chunk pass over K/V that flash's prefill wrote, so a bf16 near-tie
    may part; beside it the same share for the chunked run
    (``chunked_streams``), which splits the same arithmetic. Then the block after a copy-on-write runs graph against
    eager. Returns the measured drive's launches."""
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params, n_slots=8, max_len=1024, paged=True,
                          page_size=32, decode_block=8, prefix_cache=True,
                          device="cuda")
    label = f"{cfg.name} bf16 prefix_cache"

    def cached_drive(name):
        before = cache_counters(eng)
        sched, wall = scheduler_drive(eng)
        delta = {k: v - before[k] for k, v in cache_counters(eng).items()}
        check(eng._committed == 0 and eng.pages.pinned == 0,
              f"{label} drive {name}: committed {eng._committed}, pinned "
              f"{eng.pages.pinned} at drain")
        print(f"serve {label} drive {name}: {delta}; {eng.pages.cached_pages()} pages "
              f"cached at drain; wall {wall:.3f} s")
        return sched, wall, delta

    plain_calls.clear()
    cached_drive("A (cold, builds)")
    cached_drive("B (warm, builds)")
    check(not plain_calls, f"{label}: plain versions called while the entries were "
          f"built: {plain_calls}")
    names = set(eng.entry_points)
    check_graph_nodes(eng, label)
    captures = eng.graphs.captures
    fwd0 = (eng.prefill_groups, eng.steps, eng.chunk_passes, eng.decode_tokens)
    for kern in kernels.values():
        kern.launches = 0
    plain_calls.clear()
    replays = {}
    with counted_replays(eng, replays, f"{label} drive C"):
        sched, wall, delta = cached_drive("C (warm, measured)")
    launches = {name: kern.launches for name, kern in kernels.items()}
    plain = dict(plain_calls)
    check(eng.graphs.captures == captures,
          f"{label}: {eng.graphs.captures - captures} captures in the measured drive")
    groups, steps, passes, tokens0 = (b - a for a, b in zip(fwd0, (
        eng.prefill_groups, eng.steps, eng.chunk_passes, eng.decode_tokens)))
    check_measured_drive(eng, sched, label, launches, replays, plain,
                         (groups, steps, passes))
    fin = sched.finished
    hits = sum(f.cached_tokens > 0 for f in fin)
    check(hits > 0 and delta["prefill_tokens_cached"] > 0,
          f"{label}: the measured drive hit {hits} times ({delta})")
    prompt_tokens = sum(f.prompt_tokens for f in fin)
    parted = first_differences({f.rid: f.token_ids for f in fin}, off_streams)
    parted_chunked = first_differences(chunked_streams, off_streams)
    decode_s = sum(f.decode_s for f in fin)
    print(f"serve {label}: {len(fin)} requests, levels {[f.directive_level for f in fin]}, "
          f"cached tokens {[f.cached_tokens for f in fin]}: {hits} hits, prefill "
          f"{delta['prefill_tokens_cached']} of {prompt_tokens} prompt tokens skipped; "
          f"forward passes: {groups} prefill groups, {steps} decode steps, {passes} chunk "
          f"passes; launches {launches} (= expected = the kernel nodes run by the drive's "
          f"{sum(replays.values())} replays), plain calls {plain or 0}; decode tokens "
          f"{tokens0} in {decode_s:.3f} s = {tokens0 / decode_s:.1f} tok/s (replayed "
          f"dispatches only); wall {wall:.3f} s; streams identical to the prefix-off bf16 "
          f"run: {len(fin) - len(parted)} of {len(fin)}, the others part at (rid, token) "
          f"{parted} (not gated; the chunked run against the same: "
          f"{len(chunked_streams) - len(parted_chunked)} of {len(chunked_streams)}, "
          f"parting at {parted_chunked}); entries {len(names)}, {captures} "
          f"captures in {eng.graphs.capture_ms:.0f} ms ({nvidia_smi()})")
    cow_against_eager(eng, label)
    audit_served(eng, label)
    return launches


def cow_against_eager(eng, label):
    """A 64-token prompt (two full pages) served cold, then again: the
    repeat adopts both pages and recomputes its last token into the second,
    which first takes the one copy-on-write. Done twice, with two prompts:
    the first builds the entries, and the second's hit block runs graph
    against eager (``graph_against_eager``), from the state the copy left."""
    for i, measure in enumerate((False, True)):
        ids = [1 + (7 * i + 3 * j) % 250 for j in range(64)]
        eng.submit(ids, max_new_tokens=8)
        eng.run_to_completion()
        eng.submit(ids, max_new_tokens=8)
        cows = eng.pages.cow_copies
        if measure:
            graph_against_eager(eng, f"{label} after a copy-on-write")
        else:
            eng.step()
        check(eng.pages.cow_copies == cows + 1,
              f"{label}: the page-aligned repeat made {eng.pages.cow_copies - cows} copies")
        eng.run_to_completion()
        check(eng.finished[-1].cached_tokens == 63 and eng._committed == 0
              and eng.pages.pinned == 0,
              f"{label}: page-aligned repeat cached {eng.finished[-1].cached_tokens} "
              f"tokens; committed {eng._committed}, pinned {eng.pages.pinned}")
        eng.finished = []


GATEWAY_HOURS = 4
GATEWAY_REQUESTS = 12          # a simulated hour's requests


def gateway_drive(engines):
    """One closed-loop drive of Sprout's control plane, as the serving
    launcher's ``run_gateway`` drives it: two regional pools (CA, TX), each
    a watchdog-wrapped June trace and a scheduler over one of ``engines``;
    the directive LP (``SproutPolicy``) re-planned per pool every hour; the
    evaluator's q installed before each hour; 12 workload requests an hour
    with per-level budgets (``serve_request_from``), routed green under a
    load cap of 8 and served to idle; Eq. 1 carbon on the reference's
    accounting (A100, the LLAMA2_13B profile, modeled time). Returns the
    gateway, {rid: (pool, level, tokens)}, the hour summaries and the wall
    seconds of the hours."""
    from repro_torch.core import (A100_40GB, LLAMA2_13B, CarbonIntensityProvider,
                                  EnergyModel, QualityEvaluator, Workload)
    from repro_torch.core.carbon import WatchdogProvider
    from repro_torch.core.policies import SproutPolicy
    from repro_torch.serving import (CarbonAwareScheduler, SproutGateway,
                                     serve_request_from)
    provs = [WatchdogProvider(CarbonIntensityProvider(r, "jun")) for r in ("CA", "TX")]
    policy = SproutPolicy(k0_min=min(p.k_min for p in provs),
                          k0_max=max(p.k_max for p in provs), xi=0.1,
                          k1=A100_40GB.embodied_gco2 / A100_40GB.lifetime_s)
    gw = SproutGateway([(p, CarbonAwareScheduler([e])) for p, e in zip(provs, engines)],
                       policy=policy, energy=EnergyModel(A100_40GB),
                       model_profile=LLAMA2_13B, load_cap=8)
    finished = {}
    gw.on_finish = lambda key, fin: finished.__setitem__(
        fin.rid, (key, fin.directive_level, tuple(fin.token_ids)))
    workload, evaluator = Workload(seed=0), QualityEvaluator(sample_size=200)
    hours = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for hour in range(GATEWAY_HOURS):
        pool_sample = [workload.sample_request(hour + i * 0.01) for i in range(300)]
        gw.set_quality(evaluator.evaluate(pool_sample).q)
        reqs = [serve_request_from(workload.sample_request(hour + i * 0.01),
                                   token_scale=320.0 / 64, max_new=64)
                for i in range(GATEWAY_REQUESTS)]
        hours.append(gw.run_hour(float(hour), reqs))
    torch.cuda.synchronize()
    return gw, finished, hours, time.monotonic() - t0


def check_gateway_drive(gw, finished, hours, label):
    """Every request served and none rejected, in every hour; each installed
    mix a distribution; each plan on its Eq. 3 floor; the ledger balanced."""
    st = gw.stats
    for s in hours:
        h = int(s["t"])
        check(s["served"] == GATEWAY_REQUESTS and sum(s["routes"].values())
              == GATEWAY_REQUESTS, f"{label} hour {h}: served {s['served']}, "
              f"routes {s['routes']}")
        for key, x in s["x"].items():
            check(abs(float(np.sum(x)) - 1.0) < 1e-9 and bool(np.all(x >= 0)),
                  f"{label} hour {h} {key}: installed x {x}")
    check(st.rejected == 0, f"{label}: rejected {st.rejected_reasons}")
    check(st.requests == len(finished) == GATEWAY_HOURS * GATEWAY_REQUESTS,
          f"{label}: {st.requests} accounted, {len(finished)} finished")
    for p in st.plans:
        check(p.expected_quality >= p.q_lb - 1e-9,
              f"{label}: plan at t={p.t} {p.pool} ({p.solver}) quality "
              f"{p.expected_quality} under its floor {p.q_lb}")
    total = sum(st.carbon_by_pool.values()) + sum(st.wasted_by_pool.values())
    check(abs(st.carbon_g - total) <= 1e-12 * abs(st.carbon_g),
          f"{label}: ledger {st.carbon_g} != pools {total}")


def gateway_ledger(telemetry, profile, hw, trust_wall_time):
    """(J per generated token, mgCO2 per request) of the served requests,
    re-priced on ``hw`` with ``profile``: the model's power draw times the
    measured decode seconds (``trust_wall_time``), or the roofline model
    throughout. No power draw is sampled."""
    from repro_torch.core import PUE, EnergyModel, request_carbon
    em = EnergyModel(hw, trust_wall_time=trust_wall_time)
    joules = grams = 0.0
    for r in telemetry:
        kwh, secs = em.measure(profile, r.prompt_tokens, r.gen_tokens, r.decode_s)
        kwh *= PUE
        joules += kwh * 3.6e6
        grams += request_carbon(r.k0, kwh, secs, hw.embodied_gco2, hw.lifetime_s,
                                pue=1.0)
    return (joules / sum(r.gen_tokens for r in telemetry),
            1e3 * grams / len(telemetry))


def gateway_phase(cfg, params, kernels, plain_calls):
    """Sprout's control plane over two full-width engines (one a pool):
    drive A builds the engines' entry tables; drive B, a fresh gateway with
    the same seeds on the same engines, is measured with the tables frozen
    and must decide exactly what A decided, since no decision reads wall
    time (``trust_wall_time=False``, no deadlines, one engine a pool so
    the straggler detector is inert). Returns each kernel's launches in
    B, held to both engines' forward passes and to B's replayed nodes."""
    from repro_torch.core import H100_SXM_80GB, ModelProfile
    from repro_torch.models import model as MD
    from repro_torch.serving import InferenceEngine
    engines = [InferenceEngine(cfg, params, n_slots=8, max_len=1024, paged=True,
                               page_size=32, decode_block=8, eos_id=-1, device="cuda")
               for _ in range(2)]
    plain_calls.clear()
    gw_a, fin_a, hours_a, wall_a = gateway_drive(engines)
    check(not plain_calls, f"gateway A: plain versions called while the entries "
          f"were built: {plain_calls}")
    check_gateway_drive(gw_a, fin_a, hours_a, "gateway A")
    for i, eng in enumerate(engines):
        check_graph_nodes(eng, f"gateway engine {i}")
    tables = [sorted(eng.entry_points) for eng in engines]
    captures = [eng.graphs.captures for eng in engines]
    passes0 = [(eng.prefill_groups, eng.steps, eng.chunk_passes, eng.decode_tokens)
               for eng in engines]
    for kern in kernels.values():
        kern.launches = 0
    plain_calls.clear()
    replays = {}
    with counted_replays(engines[0], replays, "gateway B, CA"), \
            counted_replays(engines[1], replays, "gateway B, TX"):
        gw_b, fin_b, hours_b, wall_b = gateway_drive(engines)
    launches = {name: kern.launches for name, kern in kernels.items()}
    plain = dict(plain_calls)
    check_gateway_drive(gw_b, fin_b, hours_b, "gateway B")
    check([eng.graphs.captures for eng in engines] == captures,
          f"gateway B: captures {[eng.graphs.captures for eng in engines]}, A {captures}")
    # the card decides what it decided before: no decision read wall time
    check(fin_b == fin_a, "gateway B finished other tokens, levels or pools than A")
    for a, b in zip(hours_a, hours_b):
        check(a["routes"] == b["routes"] and a["carbon_g"] == b["carbon_g"]
              and all(np.array_equal(a["x"][k], b["x"][k]) for k in a["x"]),
              f"gateway hour {int(a['t'])}: A and B differ: routes {a['routes']} "
              f"{b['routes']}, x {a['x']} {b['x']}, carbon {a['carbon_g']} {b['carbon_g']}")
    check(gw_b.stats.carbon_g == gw_a.stats.carbon_g,
          f"gateway carbon: A {gw_a.stats.carbon_g} != B {gw_b.stats.carbon_g}")
    fwd = [(eng.prefill_groups - g, eng.steps - s, eng.chunk_passes - c)
           for eng, (g, s, c, _) in zip(engines, passes0)]
    want = {name: sum(expected_launches(cfg.n_layers, *f)[name] for f in fwd)
            for name in kernels}
    check(launches == want, f"gateway B: launches {launches} != expected {want} from "
          f"(prefill groups, decode steps, chunk passes) {fwd}")
    ran = graph_launches(replays)
    check(ran == launches, f"gateway B: its {sum(replays.values())} replays ran "
          f"kernels {ran} by their graphs; counted {launches}")
    check(sum(plain.values()) == 0, f"gateway B: plain versions called: {plain}")
    smi = nvidia_smi()
    for s in hours_b:
        pools = "; ".join(
            f"{k} {s['k0'][k]:.1f} gCO2/kWh x {np.round(s['x'][k], 4).tolist()} "
            f"routed {s['routes'][k]}" for k in s["k0"])
        print(f"gateway hour {int(s['t'])}: {pools}; served {s['served']}, carbon "
              f"{s['carbon_g']:.6f} g, level mix {np.round(s['level_mix'], 3).tolist()}")
    solvers = sorted({p.solver for p in gw_b.stats.plans})
    print(f"gateway: A and B identical ({len(fin_b)} requests: tokens, levels, pools, "
          f"hourly x and carbon); plans by {solvers}; B launches {launches} (= expected "
          f"= the kernel nodes of its {sum(replays.values())} replays), plain calls "
          f"{plain or 0} (A 0); entries {[len(t) for t in tables]}, captures "
          f"{[eng.graphs.captures for eng in engines]} in "
          f"{[round(eng.graphs.capture_ms) for eng in engines]} ms; A wall "
          f"{wall_a:.3f} s, B wall {wall_b:.3f} s ({smi})")
    for pool, (groups, steps, _), (_, _, _, tok0), eng in zip(gw_b.pools, fwd, passes0,
                                                              engines):
        dec_s = sum(r.decode_s for r in gw_b.stats.telemetry if r.pool == pool.key)
        dec_tokens = eng.decode_tokens - tok0
        print(f"gateway pool {pool.key}: {pool.routed} requests in {groups} prefill "
              f"groups; decode tokens {dec_tokens} in {steps} decode steps "
              f"({dec_tokens / steps:.2f} lanes live a step), {dec_s:.3f} s = "
              f"{dec_tokens / dec_s:.1f} tok/s, {1e3 * dec_s / steps:.2f} ms a step "
              f"(B's replayed dispatches; {smi})")
    # the card's own ledger beside the reference's, for the served model on
    # the H100 (its parameter count, its bf16 K and V bytes a token):
    # measured decode seconds against the roofline's modeled ones
    profile = ModelProfile(
        cfg.name, float(MD.param_count(params)),
        kv_bytes_per_token=cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0,
        d_model=cfg.d_model, n_layers=cfg.n_layers)
    tel = gw_b.stats.telemetry
    j_meas, mg_meas = gateway_ledger(tel, profile, H100_SXM_80GB, True)
    j_model, mg_model = gateway_ledger(tel, profile, H100_SXM_80GB, False)
    st = gw_b.stats
    print(f"gateway ledger, reference accounting (A100, llama2-13b profile, modeled): "
          f"{st.carbon_g:.6f} g over {st.requests} requests "
          f"({1e3 * st.carbon_per_request:.4f} mg/request), "
          f"{st.energy_kwh * 3.6e6 / sum(r.gen_tokens for r in tel):.4f} J/generated token")
    print(f"gateway ledger, card ({H100_SXM_80GB.name}, served {cfg.name} profile "
          f"{profile.n_params / 1e9:.3f} B params, {profile.kv_bytes_per_token:.0f} KV "
          f"B/token): modeled power x measured decode seconds {j_meas:.4f} J/generated token, "
          f"{mg_meas:.4f} mgCO2/request; roofline {j_model:.4f} J/generated token, "
          f"{mg_model:.4f} mgCO2/request ({smi})")
    return launches


# the port's serving entry point as a user starts it; three hours of 12
# requests, so that both pools serve and the third hour's plan is solved
# (the LP waits for five profiled requests at every level)
CLI_ARGV = ["--gateway", "--paged", "--prefix-cache", "--regions", "CA,TX",
            "--replicas", "1", "--slots", "8", "--hours", "3", "--requests", "12"]
# the same without --paged (and so without --prefix-cache): dense engines,
# as the CLI serves by default
CLI_ARGV_DENSE = [a for a in CLI_ARGV if a not in ("--paged", "--prefix-cache")]
# the reference's chaos drive (one fault of every class against CA, lanes
# poisoned on the engines, CA's replica crashed; --migrate so a migration's
# destination can vanish), paged and dense
CLI_ARGV_CHAOS = ["--gateway", "--paged", "--chaos", "--migrate"] + CLI_ARGV[3:]
CLI_ARGV_CHAOS_DENSE = [a for a in CLI_ARGV_CHAOS if a != "--paged"]


@contextlib.contextmanager
def counted_entry_runs(replays):
    """Count the runs of every entry, built before or inside the block,
    into ``replays`` ({entry: runs}). On the card every run is a replay: a
    dispatch that builds its entry captures it and then replays it."""
    from repro_torch.serving.graphs import Entry
    run = Entry.run

    def counted(self):
        replays[self] = replays.get(self, 0) + 1
        return run(self)

    Entry.run = counted
    try:
        yield
    finally:
        Entry.run = run


def cli_phase(kernels, plain_calls, argv):
    """The port's serving entry point on the card: ``repro_torch.launch.serve``
    ``main(argv)``, what ``python -m repro_torch.launch.serve`` runs,
    driven in this process so that its launches are held. The counts are
    zeroed just before and read just after; they must equal the expected
    launches over its own engines' forward passes (max_len 96, built by the
    launcher; paged attention 0 on dense engines, without ``--paged``) and
    the kernel nodes their replays ran, and no plain version may run. Its
    lines must show every hour, 0 rejected, and a solved plan; with no
    ``--arch`` it serves the default, the paper's llama2-13b; with
    ``--prefix-cache`` it must serve prefill from cached pages; with
    ``--chaos`` it must print the ``chaos:`` line, recover at least one
    fault and leave nothing stranded (a replica benched by the crash still
    counts its forward passes). Returns each kernel's launches."""
    from repro_torch.launch import serve as cli
    paged, prefix = "--paged" in argv, "--prefix-cache" in argv
    chaos = "--chaos" in argv
    tag = ("cli" if paged else "cli dense") + (" chaos" if chaos else "")
    for kern in kernels.values():
        kern.launches = 0
    plain_calls.clear()
    replays = {}
    out = io.StringIO()
    t0 = time.monotonic()
    with counted_entry_runs(replays), contextlib.redirect_stdout(out):
        gw = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    plain = dict(plain_calls)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"{tag}: {line}")
    hours = int(argv[argv.index("--hours") + 1])
    requests = int(argv[argv.index("--requests") + 1])
    total = [ln for ln in lines if ln.startswith("total:")]
    check(len(total) == 1 and ", 0 rejected," in total[0], f"{tag} total line {total}")
    check([ln.split(":")[0] for ln in lines if ln.startswith("hour ")]
          == [f"hour {h}" for h in range(hours)], f"{tag}: not one line an hour")
    st = gw.stats
    check(st.rejected == 0 and st.requests == hours * requests,
          f"{tag}: {st.requests} accounted, rejected {st.rejected_reasons}")
    solvers = sorted({p.solver for p in st.plans})
    check(set(solvers) - {"warmup"}, f"{tag}: no hour ran a solved plan: {solvers}")
    if chaos:
        line = [ln for ln in lines if ln.startswith("chaos: injected[")]
        stranded = sum(p.load() for p in gw.pools)
        check(len(line) == 1 and st.faults >= 1 and stranded == 0,
              f"{tag}: chaos line {line}, {st.faults} faults recovered, {stranded} "
              "requests stranded")
    # every engine: those serving, and any still benched by a crash
    engines = []
    for pool in gw.pools:
        sched = pool.scheduler
        for eng in list(sched.engines) + [h.engine for h in sched.health.values()]:
            if eng is not None and all(eng is not e for e in engines):
                engines.append(eng)
    cfg = engines[0].cfg
    check(cfg.name == "llama2-13b" and all(eng.cfg == cfg for eng in engines),
          f"{tag}: served {[eng.cfg.name for eng in engines]}, not the default llama2-13b")
    for i, eng in enumerate(engines):
        check_graph_nodes(eng, f"{tag} engine {i}")
    check(all(eng.paged == paged and eng.prefix_cache == prefix for eng in engines),
          f"{tag}: engines paged {[eng.paged for eng in engines]}, prefix cache "
          f"{[eng.prefix_cache for eng in engines]} for {argv}")
    cached = [eng.prefill_tokens_cached for eng in engines]
    check(not prefix or (sum(cached) > 0
                         and sum(r.cached_tokens for r in st.telemetry) == sum(cached)),
          f"{tag}: --prefix-cache engines cached {cached} prefill tokens")
    fwd = [(eng.prefill_groups, eng.steps, eng.chunk_passes) for eng in engines]
    want = {name: sum(expected_launches(cfg.n_layers, *f, paged)[name] for f in fwd)
            for name in kernels}
    check(launches == want, f"{tag}: launches {launches} != expected {want} from "
          f"(prefill groups, decode steps, chunk passes) {fwd}")
    ran = graph_launches(replays)
    check(ran == launches, f"{tag}: its {sum(replays.values())} replays ran kernels "
          f"{ran} by their graphs; counted {launches}")
    check(sum(plain.values()) == 0, f"{tag}: plain versions called: {plain}")
    print(f"{tag}: `python -m repro_torch.launch.serve {' '.join(argv)}` served "
          f"{cfg.name} (the default --arch, {'paged' if paged else 'dense'} KV) in "
          f"{wall:.1f} s (model init and captures included), 0 rejected; plans by "
          f"{solvers}; launches {launches} (= expected over its engines' (prefill "
          f"groups, decode steps, chunk passes) {fwd} = the kernel nodes of its "
          f"{sum(replays.values())} replays), plain calls {plain or 0}; entries "
          f"{[len(eng.entry_points) for eng in engines]}; prefill tokens cached {cached} "
          f"of {sum(r.prompt_tokens for r in st.telemetry)}")
    return launches


def free_device_memory():
    """Drop what nothing references any more (an engine's entries hold
    cycles) and hand the cached blocks back, so the next model has room."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_memory(label, t0):
    """One line of a phase's peak device memory (since the last reset) and
    wall seconds; resets the peak for the next phase."""
    torch.cuda.synchronize()
    print(f"memory {label}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_allocated() / 2**30:.2f} GiB still held; "
          f"{time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()


def build_model(arch, dtype=None):
    """Full-width ``arch`` on the card, in bf16 (its config's dtype) or
    ``dtype``, random weights from seed 0, checked by one forward pass:
    finite logits of shape (1, 16, vocab)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    cfg = get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    t0 = time.monotonic()
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    toks = torch.arange(1, 17, device="cuda")[None]
    logits = MD.forward(cfg, params, toks, mode="prefill")
    check(tuple(logits.shape) == (1, 16, cfg.vocab_size),
          f"{cfg.name}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite prefill logits")
    print(f"serve {cfg.name}: {MD.param_count(params) / 1e9:.3f} B params, "
          f"{MD.param_bytes(params) / 2**30:.2f} GiB weights in {cfg.dtype} "
          f"(init {init_s:.1f} s; tied embeddings {cfg.tie_embeddings}); full-width "
          f"forward: finite logits {tuple(logits.shape)}")
    return cfg, params


# the serve phase's models, one at a time: the paper's model first, with
# every run (five paged serve runs: bf16 KV, int8 KV, chunked prefill 48,
# and sampled traffic with bf16 KV, whole-prompt and chunked; two dense
# runs, the reference's default layout, bf16 KV whole-prompt and chunked
# 48; the gateway; a prefill-group profile), then one paged bf16 serve run
# each of the others. granite is the one config with GQA groups of 4. A run
# is (kv_int8, prefill_chunk, sampled, paged)
SERVE_MODELS = (
    ("llama2_13b", ((False, 0, False, True), (True, 0, False, True),
                    (False, 48, False, True), (False, 0, True, True),
                    (False, 48, True, True), (False, 0, False, False),
                    (False, 48, False, False)), True),
    ("llama2_7b", ((False, 0, False, True),), False),
    ("minicpm_2b", ((False, 0, False, True),), False),
    ("granite_3_2b", ((False, 0, False, True),), False),
)


def serve_phase():
    """Each model of ``SERVE_MODELS`` at full width, its weights freed
    before the next is drawn; then the CLI phase, which draws its own
    llama2-13b. Returns each kernel's launches over every measured drive
    (each counted from 0 and checked on its own)."""
    from repro_torch.kernels import ref
    kernels = wrappers()
    # count calls of the plain versions: the main path must never take them
    plain_calls = {}
    originals = {name: getattr(ref, f"{name}_ref") for name in kernels}

    def counted(name, fn):
        def wrapper(*a, **kw):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name, fn in originals.items():
        setattr(ref, f"{name}_ref", counted(name, fn))
    totals = dict.fromkeys(kernels, 0)
    try:
        with kept_graphs():
            for arch, runs, main_path in SERVE_MODELS:
                t0 = time.monotonic()
                torch.cuda.reset_peak_memory_stats()
                cfg, params = build_model(arch)
                if main_path:
                    profile_prefill(cfg, params)
                    free_device_memory()
                streams = {}
                for kv_int8, chunk, sampled, paged in runs:
                    launches, streams[kv_int8, chunk, sampled, paged] = serve(
                        cfg, params, kv_int8, chunk, kernels, plain_calls, sampled,
                        paged, faults=main_path and not chunk and not sampled,
                        static=main_path)
                    for name, n in launches.items():
                        totals[name] += n
                    free_device_memory()    # the run's engine and its graphs
                for chunk in (0, 48):
                    if (False, chunk, False, False) in streams:
                        dense_against_paged(cfg, chunk, streams[False, chunk, False, False],
                                            streams[False, chunk, False, True])
                if main_path:
                    t1 = time.monotonic()
                    for name, n in serve_prefix(cfg, params, kernels, plain_calls,
                                                streams[False, 0, False, True],
                                                streams[False, 48, False, True]).items():
                        totals[name] += n
                    free_device_memory()
                    print(f"serve {cfg.name} prefix cache run: {time.monotonic() - t1:.1f} s")
                    for name, n in gateway_phase(cfg, params, kernels,
                                                 plain_calls).items():
                        totals[name] += n
                del params
                free_device_memory()
                phase_memory(f"serve {cfg.name}", t0)
            for argv in (CLI_ARGV, CLI_ARGV_DENSE, CLI_ARGV_CHAOS, CLI_ARGV_CHAOS_DENSE):
                t0 = time.monotonic()
                for name, n in cli_phase(kernels, plain_calls, argv).items():
                    totals[name] += n
                free_device_memory()        # the CLI's weights and engines
                phase_memory("cli" + ("" if "--paged" in argv else " dense")
                             + (" chaos" if "--chaos" in argv else ""), t0)
    finally:
        for name, fn in originals.items():
            setattr(ref, f"{name}_ref", fn)
    return totals


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
    report = ptxas_report(log)
    for line in report:
        print(f"build: ptxas {line}")
    if report:
        # both paged kernels: the split kernel in every instantiation, and
        # the combine
        paged = [ln for ln in report if "paged_attention" in ln.split(":")[0]]
        spilled = [ln.split(":")[0] for ln in paged
                   if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        kinds = sorted({ln.split("<")[0] for ln in paged})
        print(f"build: paged kernels {kinds}: {len(paged)} instantiations, "
              f"{len(spilled)} with spills {spilled}")
        # the flash instantiations at head_dim 128 (Llama 2): registers and
        # spills of each, the two kernels whose tiles were cut for them
        for ln in report:
            if "flash_attention" in ln.split(":")[0] and "<128>" in ln.split(":")[0]:
                print(f"build: flash D 128 {ln}")
    hmma = sass_hmma_counts(build.library_path())
    if hmma is None:
        print("build: SASS HMMA count of the bf16 flash kernels: not available "
              "(no cuobjdump)")
    else:
        # the tensor cores in use: every bf16 flash instantiation issues HMMA
        flash = {fn: n for fn, n in hmma.items() if "flash_attention_bf16" in fn}
        check(flash and all(flash.values()),
              f"bf16 flash kernels without HMMA in their SASS: {flash}")
        for fn, n in zip(demangle(list(flash)), flash.values()):
            print(f"build: SASS HMMA count {n} in {fn}")
    t0 = time.monotonic()
    paged_rows = paged_phase()
    t1 = time.monotonic()
    poison_splits = paged_poison_phase()
    check(poison_splits[0] == 1 and poison_splits[-1] > 1,
          f"poisoned-slot checks ran at n_splits {poison_splits}, not one and several")
    print(f"kernel paged_attention poisoned slots: n_splits {poison_splits}; "
          f"{time.monotonic() - t1:.1f} s")
    rms_rows = rmsnorm_phase()
    flash_rows = flash_phase()
    phase_memory("kernel", t0)
    t0 = time.monotonic()
    sampler_phase()
    small_phase("llama2_13b")
    small_phase("granite_3_2b")
    phase_memory("small", t0)
    t0 = time.monotonic()
    static_phase()
    phase_memory("static", t0)
    launches = serve_phase()
    kernels = kernel_line(paged_rows, rms_rows, flash_rows, launches)
    print(f"static: {sum(STATIC_SECONDS):.1f} s in all (the lint, the reduced audit and "
          f"{len(STATIC_SECONDS) - 1} full-width engines' audits, {len(AUDITED)} distinct "
          f"full-width programs); {smi}")
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_line(paged_rows, rms_rows, flash_rows, launches):
    """The ``kernels`` JSON line: each kernel at the shape its main-path
    calls take, llama2-13b's (the CLI's default, the paper's model), with
    granite's beside it, and its launches over the measured drives."""
    mains = {
        "paged_attention": ("paged_attention.py:78", paged_rows,
                            ("llama2-13b B=8", "bf16"), ("main B=8", "bf16")),
        "fused_rmsnorm": ("rmsnorm.py:30", rms_rows,
                          ("llama2-13b decode N=8", "bf16", "residual"),
                          ("decode N=8", "bf16", "residual")),
        "flash_attention": ("flash_attention.py:85", flash_rows,
                            ("llama2-13b B=8 T=128", "bf16"), ("main B=8 T=128", "bf16")),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (tpu, rows, main_key, granite_key) in mains.items():
        csrc = "rmsnorm" if name == "fused_rmsnorm" else name
        row, granite = rows[main_key], rows[granite_key]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{csrc}.cu",
            replaces=f"src/repro/kernels/{tpu}", launches=launches[name],
            **{k: row.get(k) for k in keys}, shape=main_key[0],
            granite_3_2b=dict(shape=granite_key[0], **{k: granite.get(k) for k in keys})))
        if name == "fused_rmsnorm":
            # 41 of the 81 norms of a forward pass (each layer's ln1 and the
            # final norm) take no residual: F.rms_norm computes those
            kernels[-1]["library_ms_no_residual"] = rms_rows[
                main_key[:2] + ("plain",)]["library_ms"]
            kernels[-1]["granite_3_2b"]["library_ms_no_residual"] = rms_rows[
                granite_key[:2] + ("plain",)]["library_ms"]
    return kernels


if __name__ == "__main__":
    sys.exit(main())

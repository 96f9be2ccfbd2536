"""The engine's compiled entry points as CUDA graphs: the port's ``jax.jit``
(no counterpart file in the reference, whose engine jits its table).

An ``Entry`` is one program of the engine's table (``decode_bs{N}_k{K}_greedy``,
``mixed_bs{N}_k{K}_c{C}_full``, ``prefill_bs{N}_p{P}``): a callable
``fn(**inputs)`` over inputs of fixed shapes that returns one tensor.
The inputs are views of one static int64 buffer on the engine's device. A
dispatch writes its values into a staging buffer of the same layout (pinned
host memory on a CUDA engine) and pushes them with one host-to-device copy.
An integer input (token ids, positions, a PRNG key's two uint32 words) is
staged as its int64 value; a float32 input (a sampler's temperature or
top-p) as its int32 bit pattern, which the entry views back as float32 on
the device, inside the graph.
On a CUDA engine the entry captures ``fn`` as a CUDA graph when it is built
and replays the graph on every dispatch; on a CPU engine it runs ``fn`` as
it is. The caller reads the output back (a sync) before it stages the same
entry again, so the staging buffer is never rewritten under a copy in flight.

Capture executes ``fn`` for real (warm-up runs on a side stream, then the
captured run), and the page store is written in place. So both run on the
inputs' *dead* values: every lane dead, every table entry -1, chunk length
0, prompt pages at the trash page. Every write then lands in the trash page.
A sampler's dead inputs are temperature 0 (greedy rows) and key 0.

The kernel wrappers count their calls in Python, which a replay does not
run. Capture records how many calls of each wrapper one run makes, every
replay adds that, and the calls made by warm-up and capture are taken back
out; so a counter equals the calls the card executed for dispatches.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rmsnorm import fused_rmsnorm

# the wrappers whose ``launches`` counters a replay advances
COUNTED = (paged_attention, fused_rmsnorm, flash_attention)
# runs before capture, on a side stream, so lazy set-up (cuBLAS handles and
# workspaces, the kernels' library, shared-memory attributes) is done
WARMUP_RUNS = 2


class GraphPool:
    """One engine's graph memory pool, which all its entries share (they
    never run at once), and what capturing them cost."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = (torch.cuda.graph_pool_handle() if device.type == "cuda"
                       else None)
        self.captures = 0          # entries captured
        self.capture_ms = 0.0      # host wall time spent warming up and capturing

    @property
    def pool_bytes(self) -> int:
        """Device memory the pool holds: its segments in the caching
        allocator's snapshot (0 on a CPU engine)."""
        if self.handle is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self.handle))


class Entry:
    """One entry point: ``fn`` over static inputs laid out by ``layout``
    ({input name: (shape, dead value[, dtype])}, dtype ``torch.int64``, the
    default, or ``torch.float32``), captured into ``pool`` on a CUDA
    engine. Calling it with every input's values (numpy arrays, tensors or
    numbers) stages them and runs; ``eager()`` runs ``fn`` on the staged
    inputs without the graph."""

    def __init__(self, name: str, fn: Callable,
                 layout: Dict[str, tuple], pool: GraphPool):
        self.name, self.fn = name, fn
        dev = pool.device
        sizes = [math.prod(spec[0]) for spec in layout.values()]
        self.stage = torch.zeros(sum(sizes), dtype=torch.int64,
                                 pin_memory=dev.type == "cuda")
        self.buf = torch.zeros(sum(sizes), dtype=torch.int64, device=dev)
        flat = self.stage.numpy()  # noqa: SPL001 — a host (pinned) buffer
        self.host, self.inputs, self.dead = {}, {}, {}
        self.floats = set()        # float32 inputs, staged as int32 bits
        off = 0
        for (key, (shape, dead, *dtype)), n in zip(layout.items(), sizes):
            if dtype and dtype[0] == torch.float32:
                self.floats.add(key)
            elif dtype and dtype[0] != torch.int64:
                raise ValueError(f"{name}: input {key} of dtype {dtype[0]}")
            self.host[key] = flat[off:off + n].reshape(shape)
            self.inputs[key] = self.buf[off:off + n].view(shape)
            self.dead[key] = dead
            off += n
        self.graph = None
        self.out = None
        self.per_run = (0,) * len(COUNTED)
        if dev.type == "cuda":
            self._capture(pool)

    def stage_inputs(self, **values) -> None:
        """Write one dispatch's inputs, every one of them, into the staging
        buffer and push it to the static buffer with one copy."""
        if values.keys() != self.host.keys():
            raise ValueError(f"{self.name}: inputs {sorted(values)} != "
                             f"{sorted(self.host)}")
        for key, v in values.items():
            if key in self.floats:
                v = np.asarray(v, np.float32).view(np.int32)
            self.host[key][...] = v
        self.buf.copy_(self.stage, non_blocking=True)

    def stage_dead(self) -> None:
        """Stage the inputs that write only the trash page (capture's)."""
        self.stage_inputs(**self.dead)

    def eager(self) -> torch.Tensor:
        """Call ``fn`` on the static inputs as they stand, each float32 input
        viewed back from its bit pattern (on the device: no host read)."""
        return self.fn(**{key: x.to(torch.int32).view(torch.float32)
                          if key in self.floats else x
                          for key, x in self.inputs.items()})

    def run(self) -> torch.Tensor:
        """Run on the staged inputs: replay the graph on the card (and
        advance the wrappers' counters by one run's calls), or call ``fn``
        on the CPU. Returns the output (the graph's static output tensor)."""
        if self.graph is None:
            return self.eager()
        self.graph.replay()
        for wrapper, n in zip(COUNTED, self.per_run):
            wrapper.launches += n
        return self.out

    def __call__(self, **values) -> torch.Tensor:
        self.stage_inputs(**values)
        return self.run()

    def _capture(self, pool: GraphPool) -> None:
        t0 = time.perf_counter()
        before = [w.launches for w in COUNTED]
        self.stage_dead()
        cur = torch.cuda.current_stream(pool.device)
        side = torch.cuda.Stream(pool.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.eager()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mid = [w.launches for w in COUNTED]
        # the collector stays off while the stream captures: a collection
        # there can free a dropped engine's graph, a call CUDA refuses
        # during a capture, and the refusal invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool.handle):
                self.out = self.eager()
        finally:
            if collecting:
                gc.enable()
        self.per_run = tuple(w.launches - m for w, m in zip(COUNTED, mid))
        for w, n in zip(COUNTED, before):
            w.launches = n
        self.graph = graph
        pool.captures += 1
        pool.capture_ms += (time.perf_counter() - t0) * 1e3

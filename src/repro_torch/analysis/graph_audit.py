"""Layer 2: the audit of the engine's entry points (counterpart of
``repro/analysis/jaxpr_audit.py``).

The AST layer sees source text; this layer watches what the entries run.
It drives a small engine per variant (dense/paged x fp32/int8) through
the reference's deterministic scenario, then runs every entry point the
drive built under a ``TorchDispatchMode`` that sees each aten op, twice:
on the entry's dead inputs (the ones capture runs on) and on its live
staging (the inputs of its last dispatch, still in its staging buffer).
The store and the staging buffer are restored after an entry's two runs.
On a CUDA engine the entries are
CUDA graphs already; the audit runs their eager callables (``Entry.eager``)
on the same static inputs, so it sees the ops a replay runs. Checks:

* **f64** — no float64 or complex128 tensor goes into or comes out of any
  op. A promotion doubles the bytes a step moves without changing a token.
* **host_read** — no op reads a device value back to the host: none of
  ``SYNCING`` (``.item()`` is ``_local_scalar_dense``), no boolean-mask
  ``index`` / ``index_put`` (its count syncs), no op that takes a tensor
  on the card and returns one on the host. A capture refuses all three.
* **in_place** — each store leaf keeps its storage (``data_ptr``) across
  the run, and no op returns a tensor the shape of a store leaf, or of one
  layer of one, that is not a view of the store (a clone, an out-of-place
  ``index_put``, a cast): a silent copy of the store, the hazard the
  reference's donation check guards against. (The reference's SPL002 has
  no torch meaning; this check takes its role.)
* **bounds** — every index tensor of an op that writes into the store lies
  in ``[0, size)`` of the dimension it indexes: pages ``[0, n_pages]``
  (the trash page is ``n_pages``), dense rows ``[0, n_slots]`` (the sink
  row is ``n_slots``). torch wraps a negative index, so a write at -1
  silently lands on the last page: the counterpart of the reference's
  drop-out-of-bounds scatters. The indices' extremes are gathered on the
  device and read once after the run.
* **inventory** — the audited entry names per variant match the committed
  ``entry_point_inventory.json``. Regenerate with ``--write-inventory`` and
  review the diff.

The engine's table is the record of what was built: an entry enters
``entry_points`` when it is built (at its first use) and is never
removed, so the table after the drive holds every entry the drive built.

The scenario uses ``eos_id=-1`` so every finish is budget- or cap-driven:
entry names depend only on host-side scheduling, never on token values,
so the inventory is the same on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

INVENTORY_DEFAULT = Path(__file__).with_name("entry_point_inventory.json")

# (variant, paged, int8). The reference's tp=2 variants wait for the port's
# tensor parallelism (ROADMAP.md, item 7).
VARIANTS = (
    ("dense_fp32", False, False),
    ("dense_int8", False, True),
    ("paged_fp32", True, False),
    ("paged_int8", True, True),
)
# ops that read a device value back to the host: each syncs the card, and
# a CUDA graph capture refuses them
SYNCING = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "equal",
                     "is_nonzero", "allclose", "unique", "_unique2",
                     "repeat_interleave"})
# writes whose index tensors address the written tensor's dimensions: the
# index list of index_put (dimension d by position d), or one index along
# the op's ``dim`` argument
_INDEX_LIST = ("index_put", "_index_put_impl")
_INDEX_DIM = ("index_copy", "index_fill", "index_add", "index_reduce", "scatter",
              "scatter_add", "scatter_reduce")
_WIDE = (torch.float64, torch.complex128)


def store_leaves(engine) -> List[torch.Tensor]:
    """The KV store's tensors, every segment's leaves in order."""
    return [x for seg in engine.cache for x in seg.values()]


class OpWatch(TorchDispatchMode):
    """Runs every aten op under it and records what checks f64, host_read,
    in_place and bounds find: ``issues`` as (check, detail) pairs;
    ``finish()`` reads the gathered index extremes once and adds the bounds
    issues."""

    def __init__(self, store: List[torch.Tensor]):
        super().__init__()
        self.store = {x.untyped_storage().data_ptr() for x in store}
        self.shapes = ({x.shape for x in store} | {x.shape[1:] for x in store})
        self.issues: List[Tuple[str, str]] = []
        self.indices: List[Tuple[str, int, int, torch.Tensor]] = []   # store writes
        self.ops = 0
        self._kinds: Dict[object, Tuple[str, Tuple[Tuple[int, str], ...]]] = {}

    def _in_store(self, t) -> bool:
        return (isinstance(t, torch.Tensor)
                and t.untyped_storage().data_ptr() in self.store)

    def _kind(self, func) -> Tuple[str, Tuple[Tuple[int, str], ...]]:
        """An op's name and the (position, name) of the arguments it writes,
        read from its schema once."""
        kind = self._kinds.get(func)
        if kind is None:
            written = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                            if a.alias_info is not None and a.alias_info.is_write)
            kind = self._kinds[func] = (func.overloadpacket.__name__, written)
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        name, written = self._kind(func)
        ins = _tensors(args) + _tensors(kwargs.values()) if kwargs else _tensors(args)
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        for t in ins + outs:
            if t.dtype in _WIDE:
                self.issues.append(("f64", f"{name} on a {t.dtype} tensor "
                                           f"{tuple(t.shape)}"))
                break
        if name in SYNCING:
            self.issues.append(("host_read", f"{name} reads a device value"))
        elif _bool_indexed(name, args):
            self.issues.append(("host_read", f"{name} by a boolean mask"))
        elif any(t.is_cpu for t in outs) and any(t.is_cuda for t in ins):
            self.issues.append(("host_read", f"{name} copies to the host"))
        for t in outs:
            if t.shape in self.shapes and not self._in_store(t):
                self.issues.append(("in_place", f"{name} returned a "
                                    f"{tuple(t.shape)} {t.dtype} copy of the store"))
        if any(self._in_store(args[i] if i < len(args) else kwargs.get(arg))
               for i, arg in written):
            self._gather_indices(name.rstrip("_"), args, kwargs)
        return out

    def _gather_indices(self, name, args, kwargs) -> None:
        target = args[0]
        if name in _INDEX_LIST:
            pairs = list(enumerate(args[1]))
        elif name in _INDEX_DIM:
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            pairs = [(dim % target.dim(), args[2] if len(args) > 2 else kwargs["index"])]
        else:
            return
        for dim, idx in pairs:
            if (isinstance(idx, torch.Tensor) and idx.numel()
                    and idx.dtype != torch.bool):
                self.indices.append((name, dim, target.shape[dim], idx))

    def finish(self) -> List[Tuple[str, str]]:
        """Reduce the store writes' indices to their extremes, by op, dim and
        size, read them (one host read for the run) and return every issue
        found."""
        groups: Dict[Tuple[str, int, int], List[torch.Tensor]] = {}
        for name, dim, size, idx in self.indices:
            groups.setdefault((name, dim, size), []).append(idx.flatten())
        if groups:
            extremes = torch.stack([torch.stack(torch.aminmax(torch.cat(g)))
                                    for g in groups.values()]).tolist()
            for (name, dim, size), (lo, hi) in zip(groups, extremes):
                if lo < 0 or hi >= size:
                    self.issues.append(("bounds", f"{name} writes the store at "
                                        f"[{lo}, {hi}] on dim {dim} of size {size}"))
        return self.issues


def _tensors(values) -> List[torch.Tensor]:
    """The tensors among ``values`` and in the lists among them (an aten
    op's arguments nest one level: ``index_put``'s index list)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _bool_indexed(name, args) -> bool:
    """An index or index_put with a boolean mask (it syncs for the count)."""
    return (name in ("index", "index_put", "index_put_", "_index_put_impl_")
            and len(args) > 1
            and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for t in args[1] if t is not None))


# ---------------------------------------------------------------- report
@dataclasses.dataclass(frozen=True)
class AuditIssue:
    variant: str
    entry: str
    check: str       # "f64" | "host_read" | "in_place" | "bounds" | "inventory"
    detail: str

    def render(self) -> str:
        return f"[{self.variant}] {self.entry}: {self.check}: {self.detail}"


@dataclasses.dataclass
class AuditReport:
    issues: List[AuditIssue]
    audited: Dict[str, List[str]]    # variant -> sorted entry names

    @property
    def rc(self) -> int:
        return 1 if self.issues else 0

    def render(self, verbose: bool = False) -> str:
        out = [i.render() for i in self.issues]
        n = sum(len(v) for v in self.audited.values())
        if verbose:
            for variant, names in sorted(self.audited.items()):
                for name in names:
                    out.append(f"audited [{variant}] {name}")
        out.append(f"graph audit: {n} entries across "
                   f"{len(self.audited)} variants, "
                   f"{len(self.issues)} issues")
        return "\n".join(out)


# ---------------------------------------------------------------- checks
def audit_entry(engine, entry, variant: str = "") -> List[AuditIssue]:
    """Run ``entry``'s callable under an ``OpWatch``, on its dead inputs and
    on its live staging, and return what checks f64, host_read, in_place and
    bounds find. The store and the staging buffer are as they were after."""
    store = store_leaves(engine)
    snap = [x.clone() for x in store]
    live = entry.stage.clone()
    issues: List[AuditIssue] = []
    try:
        for staging in ("dead", "live"):
            if staging == "dead":
                entry.stage_dead()
            else:
                entry.stage.copy_(live)
                entry.buf.copy_(entry.stage)
            ptrs = [x.data_ptr() for x in store]
            with OpWatch(store) as watch:
                entry.eager()
            found = watch.finish()
            if [x.data_ptr() for x in store_leaves(engine)] != ptrs:
                found.append(("in_place", "a store leaf changed its storage"))
            issues += [AuditIssue(variant, entry.name, check, f"{staging}: {detail}")
                       for check, detail in found]
    finally:
        for x, s in zip(store, snap):
            x.copy_(s)
        entry.stage.copy_(live)
        entry.buf.copy_(entry.stage)
    return issues


def audit_engine(engine, variant: str = "") -> Tuple[List[str], List[AuditIssue]]:
    """Audit every entry in the engine's table: (names audited, issues)."""
    names = sorted(engine.entry_points)
    issues: List[AuditIssue] = []
    for name in names:
        issues += audit_entry(engine, engine.entry_points[name], variant)
    return names, issues


# -------------------------------------------------------------- scenario
def _build_engine(paged: bool, int8: bool, device):
    from repro_torch.configs import reduced
    from repro_torch.models import model as MD
    from repro_torch.models.common import resolve_device
    from repro_torch.serving.engine import InferenceEngine

    dev = resolve_device(device)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    params = MD.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return InferenceEngine(cfg, params, n_slots=4, max_len=64, eos_id=-1,
                           decode_block=8, paged=paged, kv_int8=int8,
                           page_size=16, prefill_chunk=4, device=dev)


def _drive(engine) -> None:
    """The reference's scenario (``jaxpr_audit._drive``): prefill groups,
    all three sampler modes, batch buckets and the mixed chunked-prefill
    entry. eos_id=-1 makes every finish budget-driven, so the built entry
    names do not depend on sampled values."""
    from repro_torch.serving.sampler import SamplingParams as SP

    enc = engine.tok.encode
    # phase 1: full house, heterogeneous sampling -> "full" bucket.
    # Budgets are STAGGERED so one slot frees while the rest are live: the
    # next admission then streams through the mixed chunked-prefill entry
    engine.submit(enc("alpha"), max_new_tokens=24)
    engine.submit(enc("bravo bravo"), max_new_tokens=16,
                  sampling=SP(temperature=0.8))
    engine.submit(enc("charlie three"), max_new_tokens=12,
                  sampling=SP(temperature=0.7, top_k=8))
    engine.submit(enc("delta"), max_new_tokens=24)
    engine.step()
    # mid-flight admission: streams through the mixed entry
    engine.submit(enc("echo echo echo"), max_new_tokens=8,
                  sampling=SP(temperature=0.9))
    engine.run_to_completion()
    # phase 2: greedy-only pair -> "greedy" mode at a smaller bucket
    engine.submit(enc("fox"), max_new_tokens=8)
    engine.submit(enc("golf four"), max_new_tokens=8)
    engine.run_to_completion()
    # phase 3: single temperature-only request -> "temp" mode, bs=1
    engine.submit(enc("hotel"), max_new_tokens=8,
                  sampling=SP(temperature=0.5))
    engine.run_to_completion()


# ------------------------------------------------------------- inventory
def load_inventory(path: Path) -> Optional[Dict[str, List[str]]]:
    if not path.exists():
        return None
    return {k: list(v) for k, v in json.loads(path.read_text()).items()}


def save_inventory(path: Path, audited: Dict[str, List[str]]) -> None:
    path.write_text(json.dumps(
        {k: sorted(v) for k, v in sorted(audited.items())}, indent=2) + "\n")


def check_inventory(audited: Dict[str, List[str]],
                    committed: Optional[Dict[str, List[str]]],
                    ) -> List[AuditIssue]:
    if committed is None:
        return [AuditIssue("*", "*", "inventory",
                           f"no committed inventory at "
                           f"{INVENTORY_DEFAULT.name}; run with "
                           "--write-inventory and commit the file")]
    issues: List[AuditIssue] = []
    for variant in sorted(set(audited) | set(committed)):
        have = set(audited.get(variant, ()))
        want = set(committed.get(variant, ()))
        for name in sorted(want - have):
            issues.append(AuditIssue(variant, name, "inventory",
                                     "in committed inventory but never "
                                     "built — dead variant?"))
        for name in sorted(have - want):
            issues.append(AuditIssue(variant, name, "inventory",
                                     "built but not in committed "
                                     "inventory — new variant; review and "
                                     "--write-inventory"))
    return issues


def run_audit(device="cuda", inventory_path: Optional[Path] = None,
              write_inventory: bool = False) -> AuditReport:
    """Build, drive and audit an engine per variant on ``device``, then hold
    the names against the committed inventory (or rewrite it)."""
    inventory_path = inventory_path or INVENTORY_DEFAULT
    issues: List[AuditIssue] = []
    audited: Dict[str, List[str]] = {}
    for variant, paged, int8 in VARIANTS:
        engine = _build_engine(paged, int8, device)
        _drive(engine)
        audited[variant], found = audit_engine(engine, variant)
        issues += found
    if write_inventory:
        save_inventory(inventory_path, audited)
    else:
        issues += check_inventory(audited, load_inventory(inventory_path))
    return AuditReport(issues, audited)

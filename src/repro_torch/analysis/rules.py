"""The port's lint rules, SPL001, SPL003 and SPL004, for torch (counterpart
of ``repro/analysis/rules.py``; the codes keep the reference's meanings
where they carry over).

Every rule is a pure function ``(ModuleContext, ...) -> [Finding]`` over
one parsed module. The rules are syntactic: they see no types and no
dataflow beyond one scope's assignments, so each documents exactly what
it matches; what slips through the AST is the graph audit's job
(``graph_audit.py`` runs every entry and watches its ops), and the card's
sync count (``torch.cuda.set_sync_debug_mode``) is the ground truth for
which sites really sync. ``# noqa: SPLxxx`` and the config allowlist are
applied by the driver, not here.

A *torch expression* is, within one scope: a call rooted at ``torch``
(``torch.isfinite(x)``), a name the scope assigns from a torch
expression, or a method call, attribute, subscript or arithmetic on a
torch expression, except the metadata reads ``shape``, ``dtype``,
``device``, ``size()``, ``numel()`` and their kind, which read no device
value. A parameter's type is unknown, so it is no torch expression.

SPL001 host-sync-in-hot-path
    In functions reachable from the block loop (callgraph.py from
    ``config.HOT_PATH_ROOTS``): ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.to("cpu")`` / ``.to(torch.device("cpu"))`` (also as
    ``device=``), any ``.synchronize()`` (``torch.cuda.synchronize()``,
    ``Event.synchronize()``, ``Stream.synchronize()``), ``float()`` /
    ``int()`` / ``bool()`` of a torch expression, and ``np.asarray`` /
    ``np.array`` of a torch expression. A site that wraps another counts
    once: ``x.cpu().numpy()`` is the ``.cpu()``, ``int(x.item())`` the
    ``.item()``. ``.numpy()`` and ``.tolist()`` of a tensor that lies on
    the host (a host PRNG key, a pinned staging buffer) copy nothing from
    the card; the AST cannot tell, so such a site carries
    ``# noqa: SPL001 — <reason>`` (the list of codes ends at the dash).

SPL002 donation-after-use
    Not a torch rule: torch has no buffer donation. The port's entries
    write the KV store in place, and the graph audit's in-place check
    (``graph_audit``'s ``in_place``: every store leaf keeps its storage,
    no op returns a copy of the store) takes its role.

SPL003 nondeterminism
    As the reference's: bare ``hash()``; iteration over an unsorted
    ``set`` (for / comprehension / consuming calls like ``list`` or
    ``np.fromiter``, exempt when directly wrapped in ``sorted`` /
    ``np.sort`` / ``np.unique``); ``time.time()`` and stdlib ``random.*``
    inside the configured deterministic paths.

SPL004 recompile hazard
    ``torch.compile(f)(...)`` invoked inline (a fresh compiled callable
    every call); ``torch.compile`` or a ``torch.cuda.graph`` capture inside
    a loop (a compile or a capture per iteration); an entry-point-table key
    built from an f-string whose format field is a *call* (e.g.
    ``f"bs{len(rows)}"``: unbucketed values mint unbounded entries).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.callgraph import iter_scopes
from repro_torch.analysis.findings import Finding

_SORT_WRAPPERS = {"sorted", "sort", "unique"}
_SET_CONSUMERS_NAME = {"list", "tuple", "enumerate", "iter"}
_SET_CONSUMERS_ATTR = {"fromiter", "join"}
# tensor metadata: read on the host without touching device memory
_META = {"shape", "dtype", "device", "ndim", "size", "numel", "dim",
         "element_size", "nbytes", "itemsize", "stride", "data_ptr",
         "is_cuda", "is_floating_point", "layout"}


@dataclasses.dataclass
class ModuleContext:
    path: str
    tree: ast.Module
    lines: List[str]
    parents: Dict[ast.AST, ast.AST] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def finding(self, rule: str, node: ast.AST, scope: str,
                message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule, self.path, scope, line, snippet, message)


def parse_module(path: str, source: str) -> ModuleContext:
    return ModuleContext(path, ast.parse(source, filename=path),
                         source.splitlines())


# ---------------------------------------------------------------- helpers
def _terminal(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _root_name(node: ast.AST) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _owned_by_module(tree: ast.Module) -> Iterator[ast.AST]:
    """Module-scope nodes: everything except function bodies (class-level
    statements stay with the module)."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scope_nodes(qualname: str, node: ast.AST,
                 tree: ast.Module) -> Iterator[ast.AST]:
    if qualname == "<module>":
        yield from _owned_by_module(tree)
    else:
        yield from ast.walk(node)


# ---------------------------------------------------------------- SPL001
def _tensor_expr(node: ast.AST, names: Set[str]) -> bool:
    """Is ``node`` a torch expression (module docstring), given the scope's
    names bound to torch expressions?"""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr not in _META and _tensor_expr(node.value, names)
    if isinstance(node, ast.Subscript):
        return _tensor_expr(node.value, names)
    if isinstance(node, ast.Call):
        func = node.func
        if not isinstance(func, ast.Attribute) or func.attr in _META:
            return False
        return _root_name(func) == "torch" or _tensor_expr(func.value, names)
    if isinstance(node, ast.BinOp):
        return _tensor_expr(node.left, names) or _tensor_expr(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return _tensor_expr(node.operand, names)
    if isinstance(node, ast.Compare):
        # identity and membership compare no values
        return (not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                        for op in node.ops)
                and any(_tensor_expr(n, names) for n in [node.left] + node.comparators))
    if isinstance(node, ast.BoolOp):
        return any(_tensor_expr(n, names) for n in node.values)
    if isinstance(node, ast.IfExp):
        return _tensor_expr(node.body, names) or _tensor_expr(node.orelse, names)
    return False


def _tensor_names(scope_node: ast.AST) -> Set[str]:
    """Names a scope binds to torch expressions (to a fixpoint, so the order
    of assignments does not matter)."""
    assigns = [n for n in ast.walk(scope_node) if isinstance(n, ast.Assign)]
    names: Set[str] = set()
    while True:
        grown = set(names)
        for node in assigns:
            if _tensor_expr(node.value, names):
                for target in node.targets:
                    for t in ast.walk(target):
                        if isinstance(t, ast.Name):
                            grown.add(t.id)
        if grown == names:
            return names
        names = grown


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _terminal(node.func) == "device"
            and bool(node.args) and _is_cpu(node.args[0]))


def _sync_kind(node: ast.AST) -> str:
    """The device-to-host copy or wait a call makes by itself ("" if none):
    the method forms of SPL001."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return ""
    name = node.func.attr
    if name in ("item", "tolist", "cpu") and not node.args and not node.keywords:
        return f".{name}()"
    if name == "synchronize":
        return ".synchronize()"
    if name == "to" and (any(_is_cpu(a) for a in node.args) or any(
            kw.arg == "device" and _is_cpu(kw.value) for kw in node.keywords)):
        return '.to("cpu")'
    return ""


def spl001(ctx: ModuleContext, hot_scopes: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for qualname, scope_node in iter_scopes(ctx.tree):
        if not ("*" in hot_scopes or qualname in hot_scopes):
            continue
        names = _tensor_names(scope_node) if qualname != "<module>" else set()
        for node in _scope_nodes(qualname, scope_node, ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node)
            name = _terminal(node.func)
            if kind:
                out.append(ctx.finding(
                    "SPL001", node, qualname,
                    f"host sync ({kind}) on the block's hot path"))
            elif (name == "numpy" and isinstance(node.func, ast.Attribute)
                  and not _sync_kind(node.func.value)):
                out.append(ctx.finding(
                    "SPL001", node, qualname,
                    ".numpy() on the block's hot path (a device tensor is "
                    "copied to the host first)"))
            elif (name in ("asarray", "array")
                  and _root_name(node.func) in ("np", "numpy") and node.args
                  and not _sync_kind(node.args[0])
                  and _tensor_expr(node.args[0], names)):
                out.append(ctx.finding(
                    "SPL001", node, qualname,
                    f"np.{name}() of a torch expression copies device values "
                    "to the host on the block's hot path"))
            elif (name in ("float", "int", "bool")
                  and isinstance(node.func, ast.Name) and node.args
                  and not _sync_kind(node.args[0])
                  and _tensor_expr(node.args[0], names)):
                out.append(ctx.finding(
                    "SPL001", node, qualname,
                    f"{name}() of a torch expression forces a host sync on "
                    "the block's hot path"))
    return out


# ---------------------------------------------------------------- SPL003
def _set_vars(scope_node: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(scope_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = node.value
            if isinstance(value, (ast.Set, ast.SetComp)) or (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in ("set", "frozenset")):
                names.add(node.targets[0].id)
    return names


def _is_set_expr(node: ast.AST, setvars: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset")):
        return True
    return isinstance(node, ast.Name) and node.id in setvars


def _sort_wrapped(ctx: ModuleContext, node: ast.AST) -> bool:
    parent = ctx.parents.get(node)
    while parent is not None and not isinstance(parent, ast.stmt):
        if isinstance(parent, ast.Call) \
                and _terminal(parent.func) in _SORT_WRAPPERS:
            return True
        parent = ctx.parents.get(parent)
    return False


def _random_imports(tree: ast.Module) -> Tuple[bool, Set[str]]:
    """(module imports stdlib ``random``, names imported from it)."""
    bare = False
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "random":
                    bare = True
        elif isinstance(node, ast.ImportFrom) and node.module == "random":
            names.update(alias.asname or alias.name for alias in node.names)
    return bare, names


def spl003(ctx: ModuleContext, deterministic: bool) -> List[Finding]:
    out: List[Finding] = []
    has_random, random_names = _random_imports(ctx.tree)
    for qualname, scope_node in iter_scopes(ctx.tree):
        setvars = (_set_vars(scope_node) if qualname != "<module>"
                   else set())
        for node in _scope_nodes(qualname, scope_node, ctx.tree):
            if isinstance(node, ast.For) \
                    and _is_set_expr(node.iter, setvars):
                out.append(ctx.finding(
                    "SPL003", node, qualname,
                    "iteration over an unsorted set — order feeds "
                    "downstream state; wrap in sorted()"))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter, setvars):
                        out.append(ctx.finding(
                            "SPL003", node, qualname,
                            "comprehension over an unsorted set — wrap in "
                            "sorted()"))
            elif isinstance(node, ast.Call):
                name = _terminal(node.func)
                if name == "hash" and isinstance(node.func, ast.Name):
                    out.append(ctx.finding(
                        "SPL003", node, qualname,
                        "bare hash() is PYTHONHASHSEED-dependent for "
                        "str/bytes — use zlib.crc32 or hashlib"))
                elif ((name in _SET_CONSUMERS_NAME
                       and isinstance(node.func, ast.Name))
                      or (name in _SET_CONSUMERS_ATTR
                          and isinstance(node.func, ast.Attribute))):
                    if (node.args
                            and _is_set_expr(node.args[0], setvars)
                            and not _sort_wrapped(ctx, node)):
                        out.append(ctx.finding(
                            "SPL003", node, qualname,
                            f"{name}() materializes an unsorted set — "
                            "order feeds downstream state; wrap in "
                            "sorted()/np.sort()"))
                elif (deterministic and name == "time"
                      and _root_name(node.func) == "time"):
                    out.append(ctx.finding(
                        "SPL003", node, qualname,
                        "time.time() in a deterministic path (telemetry "
                        "should use time.monotonic / perf_counter; plans "
                        "should take t as input)"))
                elif deterministic and (
                        (_root_name(node.func) == "random" and has_random
                         and isinstance(node.func, ast.Attribute))
                        or (isinstance(node.func, ast.Name)
                            and node.func.id in random_names)):
                    out.append(ctx.finding(
                        "SPL003", node, qualname,
                        "stdlib random in a deterministic path — use a "
                        "seeded np.random.Generator or torch.Generator"))
    return out


# ---------------------------------------------------------------- SPL004
def _in_loop(ctx: ModuleContext, node: ast.AST) -> bool:
    parent = ctx.parents.get(node)
    while parent is not None and not isinstance(
            parent, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
        if isinstance(parent, (ast.For, ast.While)):
            return True
        parent = ctx.parents.get(parent)
    return False


def _fstring_call_field(node: ast.AST) -> bool:
    return isinstance(node, ast.JoinedStr) and any(
        isinstance(v, ast.FormattedValue) and isinstance(v.value, ast.Call)
        for v in node.values)


def _torch_call(func: ast.AST, name: str) -> bool:
    """``torch.<...>.name``: ``torch.compile``, ``torch.cuda.graph``."""
    return _terminal(func) == name and _root_name(func) == "torch"


def spl004(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for qualname, scope_node in iter_scopes(ctx.tree):
        for node in _scope_nodes(qualname, scope_node, ctx.tree):
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Call)
                        and _torch_call(node.func.func, "compile")):
                    out.append(ctx.finding(
                        "SPL004", node, qualname,
                        "torch.compile(f)(...) invoked inline compiles a "
                        "fresh callable on every call — bind it once"))
                elif ((_torch_call(node.func, "compile")
                       or _torch_call(node.func, "graph"))
                      and _in_loop(ctx, node)):
                    out.append(ctx.finding(
                        "SPL004", node, qualname,
                        f"{_terminal(node.func)} inside a loop compiles or "
                        "captures once per iteration — hoist it or key it "
                        "in the entry-point table"))
                elif (_terminal(node.func) == "setdefault"
                      and isinstance(node.func, ast.Attribute)
                      and "entry_point" in ast.unparse(node.func.value)
                      and node.args
                      and _fstring_call_field(node.args[0])):
                    out.append(ctx.finding(
                        "SPL004", node, qualname,
                        "entry-point name minted from an f-string with a "
                        "call field — bucket the value into a bounded "
                        "variable first"))
            elif (isinstance(node, ast.Subscript)
                  and "entry_point" in ast.unparse(node.value)
                  and _fstring_call_field(node.slice)):
                out.append(ctx.finding(
                    "SPL004", node, qualname,
                    "entry-point table keyed by an f-string with a call "
                    "field — unbounded variant minting; bucket the value "
                    "first"))
    return out

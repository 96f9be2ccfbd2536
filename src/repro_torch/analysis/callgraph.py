"""Best-effort intra-repo call graph for hot-path reachability (SPL001); a
copy of ``repro/analysis/callgraph.py``.

Python ASTs carry no types, so edges are matched by *terminal name*: a
call ``self.pages.ensure_capacity(...)`` is an edge to every known
definition named ``ensure_capacity``. That over-approximates — a generic
name can pull unrelated definitions into the hot set — which is the right
failure mode for a lint gate: extra coverage surfaces as an explicit
finding to allowlist or ``# noqa``, never as a silently unchecked sync.

Scopes are top-level functions and class methods; nested ``def``s belong
to their enclosing scope (their bodies are scanned with it, their calls
count as the parent's calls).

One edge more than the reference's graph: a call by a class's name
(``Entry(name, fn, layout, pool)``) reaches that class's ``__init__``, so
what building an entry runs inside the block loop is hot too. A call
through a local name bound to an object (``out = fn(**inputs)``, an
``Entry``'s ``__call__``) resolves to nothing by name; the graph audit
covers what such entries run.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Set, Tuple

Scope = Tuple[str, str]   # (repo-relative path, qualname)


def iter_scopes(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every top-level scope in a module:
    functions, class methods, and finally ``("<module>", tree)`` for
    statements outside any def (rules must skip nodes owned by an inner
    scope when walking the module node)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{item.name}", item
    yield "<module>", tree


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _called_names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = _terminal_name(n.func)
            if name:
                out.add(name)
    return out


class CallGraph:
    def __init__(self) -> None:
        self.defs: Dict[Scope, ast.AST] = {}
        self.by_name: Dict[str, List[Scope]] = {}
        self.calls: Dict[Scope, Set[str]] = {}

    def add_module(self, path: str, tree: ast.Module) -> None:
        for qualname, node in iter_scopes(tree):
            if qualname == "<module>":
                continue
            scope = (path, qualname)
            self.defs[scope] = node
            self.by_name.setdefault(qualname.rsplit(".", 1)[-1],
                                    []).append(scope)
            self.calls[scope] = _called_names(node)
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and any(
                    isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name == "__init__" for item in node.body):
                self.by_name.setdefault(node.name, []).append(
                    (path, f"{node.name}.__init__"))

    def reachable(self, roots: Iterable[str]) -> Set[Scope]:
        """Transitive closure from ``"path::qualname"`` root specs over
        terminal-name-matched edges."""
        frontier: List[Scope] = []
        for spec in roots:
            path, qualname = spec.split("::")
            scope = (path, qualname)
            if scope in self.defs:
                frontier.append(scope)
        seen: Set[Scope] = set(frontier)
        while frontier:
            scope = frontier.pop()
            for name in self.calls.get(scope, ()):
                for callee in self.by_name.get(name, ()):
                    if callee not in seen:
                        seen.add(callee)
                        frontier.append(callee)
        return seen

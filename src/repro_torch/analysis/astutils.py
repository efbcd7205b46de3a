"""Shared AST infrastructure for the port's lint rules (a copy of the JAX
package's ``analysis/astutils.py``; the port imports nothing of it).

Builds a best-effort, name-based view of the source tree:

* per-module import maps and function tables,
* a call graph across the linted modules,
* the *traced roots* of the JAX package's rules (functions handed to
  ``jax.jit`` / ``shard_map`` / ``lax.cond``-family transforms), kept so the
  index is the reference's, though the port has none of them: the port's
  rules name their roots themselves (``rules/r2_host_sync.py``),
* ``# repro-lint: disable=R2[,R5]`` comment extraction.

The resolution is deliberately approximate (pure-AST, no imports are
executed): calls that cannot be resolved by name are ignored, which can
only make the reachable sets *smaller*.  Rules are tuned so the shipped
tree is clean; the escape hatch covers audited exceptions.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Optional

DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+)")

# transforms whose function arguments run under a jax trace
_JIT_WRAPPERS = {"jax.jit", "jit", "jax.make_jaxpr", "make_jaxpr",
                 "jax.pmap", "pmap", "jax.checkpoint", "jax.remat"}
_SHARD_WRAPPERS = {"shard_map", "_shard_map", "jax.shard_map",
                   "jax.experimental.shard_map.shard_map"}
# (callee suffix, positions of function-valued args); None = all args
_BRANCH_WRAPPERS = {
    "lax.cond": (1, 2), "lax.switch": None, "lax.scan": (1,),
    "lax.while_loop": (0, 1), "lax.fori_loop": (2,), "lax.map": (0,),
    "lax.associative_scan": (0,),
}


@dataclasses.dataclass
class FuncInfo:
    """One function (or lambda) definition with its lexical context."""

    module: "ModuleInfo"
    qualname: str                      # e.g. "Engine._unified_impl"
    node: ast.AST                      # FunctionDef | AsyncFunctionDef | Lambda

    @property
    def key(self) -> str:
        return f"{self.module.name}:{self.qualname}"

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def lineno(self) -> int:
        return self.node.lineno

    def positional_params(self) -> list[str]:
        """Positional parameter names with no default (the traced-arg
        convention: static config rides keyword-only / defaulted params)."""
        a = self.node.args
        pos = list(a.posonlyargs) + list(a.args)
        n_default = len(a.defaults)
        if n_default:
            pos = pos[:-n_default]
        names = [p.arg for p in pos]
        return [n for n in names if n not in ("self", "cls")]


@dataclasses.dataclass
class ModuleInfo:
    name: str                          # dotted module name
    path: Path
    source: str
    tree: ast.Module
    imports: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)  # qual -> FuncInfo
    disables: dict = dataclasses.field(default_factory=dict)   # line -> {rule}


def module_name_for(path: Path) -> str:
    """Dotted module name, rooted at the nearest ``src`` dir if present."""
    parts = list(path.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def _collect_disables(source: str) -> dict:
    out: dict[int, set] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = DISABLE_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                out.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass
    return out


def _collect_imports(tree: ast.Module) -> dict:
    imp: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imp[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                imp[a.asname or a.name] = f"{node.module}.{a.name}"
    return imp


def _collect_functions(mod: ModuleInfo) -> None:
    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                mod.functions[qual] = FuncInfo(mod, qual, child)
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)
    visit(mod.tree, "")


def parse_module(path: Path, name: Optional[str] = None,
                 source: Optional[str] = None) -> ModuleInfo:
    src = source if source is not None else path.read_text()
    tree = ast.parse(src, filename=str(path))
    mod = ModuleInfo(name=name or module_name_for(path), path=path,
                     source=src, tree=tree)
    mod.imports = _collect_imports(tree)
    mod.disables = _collect_disables(src)
    _collect_functions(mod)
    return mod


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve(mod: ModuleInfo, name: str) -> str:
    """Expand the first segment of a dotted name through the import map."""
    head, _, rest = name.partition(".")
    target = mod.imports.get(head)
    if target is None:
        return name
    return f"{target}.{rest}" if rest else target


_NORMALIZE = {"jax.numpy": "jnp", "numpy": "np", "jax.lax": "lax"}


def normalized(mod: ModuleInfo, node: ast.AST) -> Optional[str]:
    """Resolved dotted callee with jnp/np/lax spelled canonically,
    e.g. ``jnp.argsort`` whatever the local import alias was."""
    d = dotted(node)
    if d is None:
        return None
    r = resolve(mod, d)
    for full, short in _NORMALIZE.items():
        if r == full:
            return short
        if r.startswith(full + "."):
            return short + r[len(full):]
    return r


class Index:
    """Cross-module function table + call graph + traced roots."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules = {m.name: m for m in modules}
        self.by_fq: dict[str, FuncInfo] = {}
        self.by_key: dict[str, FuncInfo] = {}
        for m in self.modules.values():
            for qual, fi in m.functions.items():
                self.by_fq[f"{m.name}.{qual}"] = fi
                self.by_key[fi.key] = fi
        self._edges: dict[str, set] = {}
        self.jit_roots: list[FuncInfo] = []
        self.shard_roots: list[FuncInfo] = []
        self.branch_roots: list[FuncInfo] = []
        self._lambda_n = 0
        for m in self.modules.values():
            self._scan_module(m)

    # -- resolution ---------------------------------------------------------

    def _enclosing_class(self, fi: FuncInfo) -> Optional[str]:
        parts = fi.qualname.split(".")
        return parts[-2] if len(parts) >= 2 else None

    def resolve_func(self, mod: ModuleInfo, expr: ast.AST,
                     enclosing: Optional[FuncInfo] = None,
                     localmap: Optional[dict] = None) -> Optional[FuncInfo]:
        """Resolve an expression to a FuncInfo in the index, best-effort."""
        if isinstance(expr, ast.Lambda):
            self._lambda_n += 1
            fi = FuncInfo(mod, f"<lambda#{self._lambda_n}>", expr)
            return fi
        if isinstance(expr, ast.Call):
            callee = dotted(expr.func)
            if callee and callee.split(".")[-1] == "partial" and expr.args:
                return self.resolve_func(mod, expr.args[0], enclosing, localmap)
            return None
        d = dotted(expr)
        if d is None:
            return None
        if localmap and d in localmap:
            return self.resolve_func(mod, localmap[d], enclosing, localmap)
        # self.method -> method of the enclosing class
        if d.startswith("self.") and enclosing is not None:
            cls = self._enclosing_class(enclosing)
            if cls:
                fi = mod.functions.get(f"{cls}.{d[5:]}")
                if fi:
                    return fi
        # local / nested name within the enclosing function's scope
        if enclosing is not None:
            fi = mod.functions.get(f"{enclosing.qualname}.{d}")
            if fi:
                return fi
        if d in mod.functions:
            return mod.functions[d]
        fq = resolve(mod, d)
        if fq in self.by_fq:
            return self.by_fq[fq]
        # module attribute reference: repro_torch.models.moe.moe_block
        tail = fq.rsplit(".", 1)
        if len(tail) == 2 and tail[0] in self.modules:
            return self.modules[tail[0]].functions.get(tail[1])
        return None

    # -- scanning -----------------------------------------------------------

    def _scan_module(self, mod: ModuleInfo) -> None:
        # local "name = functools.partial(fn, ...)" / "name = fn" aliases,
        # per enclosing function
        for qual, fi in list(mod.functions.items()):
            localmap: dict[str, ast.AST] = {}
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    localmap[node.targets[0].id] = node.value
            fi._localmap = localmap  # type: ignore[attr-defined]
        for qual, fi in list(mod.functions.items()):
            edges = self._edges.setdefault(fi.key, set())
            localmap = getattr(fi, "_localmap", {})
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve_func(mod, node.func, fi, localmap)
                if callee is not None and not isinstance(callee.node, ast.Lambda):
                    edges.add(callee.key)
                self._scan_call_for_roots(mod, node, fi, localmap, edges)
        # module-level calls (e.g. decorators / module body jit calls)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                self._scan_call_for_roots(mod, node, None, {}, None)

    def _scan_call_for_roots(self, mod, call, enclosing, localmap, edges):
        callee = dotted(call.func)
        if callee is None:
            return
        resolved = resolve(mod, callee)
        last = callee.split(".")[-1]

        def grab(exprs, bucket):
            for e in exprs:
                fi = self.resolve_func(mod, e, enclosing, localmap)
                if fi is not None:
                    bucket.append(fi)
                    if edges is not None and not isinstance(fi.node, ast.Lambda):
                        edges.add(fi.key)

        if resolved in _JIT_WRAPPERS or last == "jit":
            args = list(call.args[:1])
            args += [k.value for k in call.keywords if k.arg in ("fun", "f")]
            grab(args, self.jit_roots)
        elif last in _SHARD_WRAPPERS or resolved in _SHARD_WRAPPERS:
            args = list(call.args[:1])
            args += [k.value for k in call.keywords if k.arg in ("f", "fn")]
            grab(args, self.shard_roots)
        else:
            for suffix, positions in _BRANCH_WRAPPERS.items():
                if resolved.endswith(suffix) or callee.endswith(suffix):
                    if positions is None:
                        args = list(call.args)
                    else:
                        args = [call.args[i] for i in positions
                                if i < len(call.args)]
                    grab(args, self.branch_roots)
                    break

    # -- reachability -------------------------------------------------------

    def reachable(self, roots: Iterable[FuncInfo]) -> dict[str, FuncInfo]:
        """BFS over the call graph from ``roots`` (named functions only;
        lambdas contribute their body calls via the enclosing function)."""
        seen: dict[str, FuncInfo] = {}
        queue = []
        for r in roots:
            if isinstance(r.node, ast.Lambda):
                continue
            if r.key not in seen:
                seen[r.key] = r
                queue.append(r)
        while queue:
            fi = queue.pop()
            for key in self._edges.get(fi.key, ()):
                if key not in seen and key in self.by_key:
                    seen[key] = self.by_key[key]
                    queue.append(self.by_key[key])
            # nested defs run under the same trace
            for qual, sub in fi.module.functions.items():
                if qual.startswith(fi.qualname + ".") and sub.key not in seen:
                    seen[sub.key] = sub
                    queue.append(sub)
        return seen


__all__ = ["FuncInfo", "ModuleInfo", "Index", "parse_module", "dotted",
           "resolve", "normalized", "module_name_for", "DISABLE_RE"]

"""R2: no host sync reachable from the step's device-side bodies."""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.astutils import dotted, normalized
from repro_torch.analysis.lint import Finding

# method calls that wait for the device and copy its values to the host
# (``synchronize`` also covers torch.cuda.synchronize and Stream / Event),
# or size their output from device values (``nonzero`` and the ops built
# on it)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize", "nonzero",
                 "masked_select", "unique", "unique_consecutive"}
# boolean tensors: comparisons, their &, |, ^ and ~, and these calls
_MASK_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
               "logical_xor", "logical_not", "eq", "ne", "lt", "le", "gt",
               "ge"}
# builtins that read a tensor's value on the host
_CONCRETIZERS = {"float", "int", "bool"}
# tensor and container methods that answer from host metadata
_HOST_METHODS = {"size", "dim", "numel", "element_size", "stride",
                 "storage_offset", "data_ptr", "is_contiguous", "get",
                 "index", "count", "bit_length", "axis_size", "axis_index",
                 "keys", "values", "items", "startswith", "endswith"}
# the roots: (last module component, qualname) of the device-side bodies
_ROOTS = {("engine", "Engine._unified_impl"),
          ("engine", "Engine._verify_impl"),
          ("engine", "Engine._prefill_impl"),
          ("engine", "Engine._decode_impl"), ("model", "forward"),
          ("train_step", "loss_fn"), ("train_step", "value_and_grad")}


def _reads_device(node: ast.AST, mod) -> bool:
    """True when the expression holds a ``torch.`` call or a method call
    on a value that is not an imported module (a tensor's, in the step's
    bodies) other than the host-metadata methods: ``int(x.sum())``,
    ``float(torch.max(x))``; not ``int(math.ceil(n / 2))`` or
    ``int(x.size(0))``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = normalized(mod, sub.func) or ""
        if name.split(".")[0] == "torch":
            return True
        if not isinstance(sub.func, ast.Attribute) \
                or sub.func.attr in _HOST_METHODS:
            continue
        base = dotted(sub.func.value)      # None: `(a == b).all()`, `x[0]...`
        if base is None or base.split(".")[0] not in mod.imports:
            return True
    return False


def _is_mask(node: ast.AST, masks: set) -> bool:
    """True when the expression is a boolean tensor by its form: a
    comparison, a name bound to one, their ``&`` / ``|`` / ``^`` / ``~``,
    or a call of ``_MASK_CALLS``."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(node.left, masks) or _is_mask(node.right, masks)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, masks)
    if isinstance(node, ast.Call):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else ""
        return name in _MASK_CALLS
    return False


def _mask_reads(fn: ast.AST) -> Iterable[ast.Subscript]:
    """Reads ``x[mask]`` (the mask alone or in a tuple of indices) in
    ``fn``: boolean-mask indexing sizes its result by a ``nonzero`` of the
    mask, which waits for the device."""
    masks: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_mask(node.value, masks):
            masks.add(node.targets[0].id)
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            idx = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                else [node.slice]
            if any(_is_mask(i, masks) for i in idx):
                yield node


class HostSyncRule:
    """No host sync reachable from the step's device-side bodies.

    The engine's host loop (``Engine.unified_step`` and friends) syncs on
    purpose, once, after a step's program is issued: it reads the sampled
    ids and stamps the time.  Inside the program (the step bodies
    ``Engine._unified_impl`` / ``_verify_impl`` / ``_prefill_impl`` /
    ``_decode_impl``, ``models.model.forward``, the training step's
    ``loss_fn`` and ``value_and_grad``, every public wrapper of
    ``kernels/ops.py``, and what they reach), a read of a device value on
    the host stalls the CPU until the card drains its queue, so the next
    kernels are launched late: every serve of the port is host-bound, and
    such a stall costs the whole launch lead.

    Flags, in those functions: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize``, a
    stream's or an event's), ``nonzero`` / ``masked_select`` / ``unique``
    (an output sized by device values), a read through a boolean mask
    (``x[ok]`` with ``ok`` a comparison, a name bound to one, or their
    ``&`` / ``|`` / ``~``: a hidden ``nonzero``), and ``float()`` /
    ``int()`` / ``bool()`` of an expression holding a ``torch.`` call or a
    tensor method call.  Shape arithmetic (``int(math.ceil(...))``,
    ``x.shape``, ``x.size(0)``) is not flagged.  An audited sync (one the algorithm needs, uniform on every
    rank) carries ``# repro-lint: disable=R2`` and a one-line reason.
    """

    id = "R2"
    title = "no host sync reachable from the step's device-side bodies"

    def _roots(self, idx):
        roots = []
        for fi in idx.by_key.values():
            name = fi.module.name
            # a self-test fixture module stands for any of the root modules
            fixture = name.startswith("fixture_") and name.endswith("_r2")
            if (name.rsplit(".", 1)[-1], fi.qualname) in _ROOTS or fixture \
                    and fi.qualname in {q for _, q in _ROOTS}:
                roots.append(fi)
            elif name.endswith("kernels.ops") and "." not in fi.qualname \
                    and not fi.qualname.startswith("_"):
                roots.append(fi)
        return roots

    def check(self, ctx) -> Iterable[Finding]:
        idx = ctx.index
        for fi in idx.reachable(self._roots(idx)).values():
            mod = fi.module
            for node in _mask_reads(fi.node):
                yield Finding(
                    self.id, str(mod.path), node.lineno, node.col_offset,
                    f"a read through a boolean mask in {fi.qualname}, "
                    "reachable from the step's device-side bodies: its "
                    "size is a nonzero of the mask, read on the host",
                    symbol=fi.qualname)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS:
                    yield Finding(
                        self.id, str(mod.path), node.lineno, node.col_offset,
                        f"`.{node.func.attr}()` in {fi.qualname}, reachable "
                        "from the step's device-side bodies: a host sync "
                        "inside the step (move it to the host loop)",
                        symbol=fi.qualname)
                    continue
                name = normalized(mod, node.func)
                if name in _CONCRETIZERS and node.args \
                        and _reads_device(node.args[0], mod):
                    yield Finding(
                        self.id, str(mod.path), node.lineno, node.col_offset,
                        f"`{name}(...)` of a tensor in {fi.qualname}, "
                        "reachable from the step's device-side bodies: "
                        "reads a device value on the host",
                        symbol=fi.qualname)

    FIXTURE_BAD = '''
import torch


class Engine:
    def _unified_impl(self, tokens, q_lens, v_lens):
        logits = self.params @ tokens
        best = float(torch.max(logits))    # reads a device value
        top = int(q_lens.max())            # a tensor method, on the host
        ids = logits.argmax(-1).tolist()   # device -> host copy
        torch.cuda.synchronize()           # waits for the card
        ok = (q_lens > 0) & torch.isfinite(logits).all(-1)
        live = logits[ok]                  # a hidden nonzero
        return logits.item()               # device -> host copy
'''

    FIXTURE_GOOD = '''
import math
import torch


class Engine:
    def _unified_impl(self, tokens, q_lens, v_lens):
        cap = int(math.ceil(tokens.shape[0] * 1.25))   # shape arithmetic
        rows = int(tokens.size(0))                     # host metadata
        ok = (q_lens > 0)[:, None]
        out = torch.where(ok, self.params @ tokens, 0)  # no mask read
        return out[:cap], rows

    def unified_step(self, tokens, q_lens, v_lens):
        out = self._unified_impl(tokens, q_lens, v_lens)
        return out[0].tolist()         # fine: the host loop, after the step
'''


RULE = HostSyncRule()

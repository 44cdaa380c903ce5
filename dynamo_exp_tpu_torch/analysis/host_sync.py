"""host-sync checker: no implicit device->host syncs in hot-path zones.

Counterpart of ``dynamo_exp_tpu/analysis/host_sync.py``, retargeted to
torch. What blocks the host on a CUDA tensor (and therefore the engine
loop, when it happens there):

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")`` of a value not proven to live on the host;
- ``torch.cuda.synchronize()``, and any ``.synchronize()`` (an event's
  is a host wait on one event, not on the whole card, but it is still
  a wait: each one is an inline-waived, reviewed entry);
- ``int()`` / ``float()`` / ``bool()`` of a device tensor, and its
  truthiness (``if t:`` / ``not t`` / ``t and u`` / ``t > 0``);
- the ops whose output shape depends on the data, which copy a count
  to the host before they can allocate: ``.nonzero()``,
  ``torch.where(cond)`` with one argument, boolean-mask indexing of a
  device tensor, ``masked_select``, ``torch.unique`` and
  ``repeat_interleave`` without ``output_size=``.

The checker runs light per-function dataflow, as the JAX one does, so
it can tell the two sides of a copy apart: a name bound from a
``torch.*`` factory given ``device=``, from ``.to(device)`` /
``.cuda()``, or from the engine's device attributes (``DEVICE_ATTRS``)
is DEVICE; a name bound from ``np.*``, ``torch.from_numpy``, a pinned
allocation (``pin_memory=True``, ``.pin_memory()``, ``pinned_empty``)
or one of the host attributes (``HOST_ATTRS``: the pinned copies a
dispatch's outputs land in) is HOST. ``.numpy()`` of a pinned host
buffer is bookkeeping, not a sync, and is not flagged; the wait is the
event's ``.synchronize()`` before it. Calls whose receiver can't be
proven HOST are flagged conservatively: a reviewed
``# dynlint: sync-point(reason)`` is exactly the point.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    ScopeIndex,
    Zone,
    attr_chain,
    base_name,
    dataflow_units,
    own_nodes,
    zone_for,
)

RULE = "host-sync"

# Methods that copy a device value to the host (their results are host
# values); ``.synchronize()`` waits without a result.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"int", "float", "bool"}
# Data-dependent output shapes: the op reads a count back first.
_SHAPE_METHODS = {"nonzero", "masked_select", "unique", "repeat_interleave"}
_SHAPE_FNS = {"nonzero", "masked_select", "unique", "repeat_interleave", "where"}
_HOST_FNS = {"from_numpy", "pinned_empty"}

_DEVICE = "device"
_HOST = "host"

# Attributes known to hold device tensors engine-wide (the KV pools,
# the penalty counts, the weights, a graph's buffers, a chained
# window's carry): a cast or truthiness of one is always a sync. Local
# names get classified by dataflow; these cover the ``self.<attr>`` /
# ``pending.<attr>`` spellings dataflow can't see.
DEVICE_ATTRS = frozenset(
    {
        "k_cache",
        "v_cache",
        "_counts",
        "model",
        "tokens_dev",
        "positions_dev",
        "in_buf",
        "inputs",
        "outputs",
    }
)
# Attributes known to hold host tensors: a dispatch's outputs copied
# into pinned buffers behind it (``_PendingRagged.ys``).
HOST_ATTRS = frozenset({"ys"})


def _is_np_root(chain: tuple[str, ...]) -> bool:
    return bool(chain) and chain[0] in ("np", "numpy")


def _is_torch_root(chain: tuple[str, ...]) -> bool:
    return bool(chain) and chain[0] == "torch"


def _kw(node: ast.Call, name: str) -> ast.AST | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu_const(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _is_dtype(node: ast.AST) -> bool:
    """``torch.float32`` / ``x.dtype``: the argument of a cast."""
    chain = attr_chain(node)
    return bool(chain) and (chain[-1] == "dtype" or (
        chain[0] == "torch" and len(chain) == 2 and chain[1] != "device"))


def _true_const(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


class _FunctionFlow(ast.NodeVisitor):
    """One function's name classification (DEVICE / HOST / unknown)."""

    def __init__(
        self,
        device_attrs: frozenset[str] = DEVICE_ATTRS,
        host_attrs: frozenset[str] = HOST_ATTRS,
    ) -> None:
        self.classes: dict[str, str] = {}
        self.masks: set[str] = set()  # names bound to device boolean masks
        self.device_attrs = device_attrs
        self.host_attrs = host_attrs

    # ------------------------------------------------------ classification
    def classify(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Call):
            return self._classify_call(node)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
            return self.classify(node.elt)
        if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
            inner = node
            while isinstance(inner, ast.Subscript):
                inner = inner.value
            chain = attr_chain(inner)
            # Dotted access only (`self._counts`, `pending.ys`): a bare
            # local that happens to share a name stays dataflow-classified.
            if len(chain) >= 2 and chain[-1] in self.device_attrs:
                return _DEVICE
            if len(chain) >= 2 and chain[-1] in self.host_attrs:
                return _HOST
            base = base_name(node)
            if base is not None:
                return self.classes.get(base)
            return None
        if isinstance(node, ast.BinOp):
            kinds = {self.classify(node.left), self.classify(node.right)}
            if _DEVICE in kinds:
                return _DEVICE
            if kinds == {_HOST}:
                return _HOST
            return None
        if isinstance(node, ast.Tuple):
            kinds = {self.classify(e) for e in node.elts}
            if len(kinds) == 1:
                return kinds.pop()
        if isinstance(node, ast.Constant):
            return _HOST
        return None

    def _classify_call(self, node: ast.Call) -> str | None:
        chain = attr_chain(node.func)
        if chain and chain[-1] in _HOST_FNS:
            return _HOST
        if _is_np_root(chain):
            return _HOST  # np.zeros/np.asarray/... build host buffers
        if _is_torch_root(chain):
            if _true_const(_kw(node, "pin_memory")):
                return _HOST
            device = _kw(node, "device")
            if device is not None:
                return _HOST if _is_cpu_const(device) else _DEVICE
            if any(self.classify(a) == _DEVICE for a in node.args):
                return _DEVICE
            return None
        if isinstance(node.func, ast.Attribute):
            method = node.func.attr
            recv = self.classify(node.func.value)
            if method in _SYNC_METHODS or method == "pin_memory":
                return _HOST
            if method == "cuda":
                return _DEVICE
            if method == "to":
                device = node.args[0] if node.args else _kw(node, "device")
                if device is None or _is_dtype(device):
                    return recv  # a dtype cast stays where it is
                return _HOST if _is_cpu_const(device) else _DEVICE
            # A method call on a device value yields another device
            # value (`x.sum()`, `x.index_select(...)`); on a host one, a
            # host value.
            return recv
        return None

    def is_mask(self, node: ast.AST) -> bool:
        """A device boolean: a comparison with a device operand, a
        bitwise combination or inversion of masks, or a name bound to
        one."""
        if isinstance(node, ast.Compare):
            return any(
                self.classify(e) == _DEVICE for e in [node.left, *node.comparators]
            ) and not all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
        ):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.Name):
            return node.id in self.masks
        return False

    def _bind(self, target: ast.AST, kind: str | None) -> None:
        if kind is None:
            return
        if isinstance(target, ast.Name):
            # DEVICE is sticky: a later host rebind (`x = x.cpu()`) must
            # not retroactively exempt the copying call: the
            # classification is flow-insensitive, so the conservative
            # merge keeps the device taint for the whole function.
            if kind == _HOST and self.classes.get(target.id) == _DEVICE:
                return
            self.classes[target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, kind)

    def visit_Assign(self, node: ast.Assign) -> None:
        kind = self.classify(node.value)
        for t in node.targets:
            self._bind(t, kind)
            if isinstance(t, ast.Name) and self.is_mask(node.value):
                self.masks.add(t.id)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._bind(node.target, self.classify(node.value))
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        # Iterating a HOST value yields host rows; a DEVICE value
        # yields device slices.
        self._bind(node.target, self.classify(node.iter))
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        # `[y.numpy() for y in pending.ys]`: the target takes the
        # iterable's class, as a for loop's does.
        self._bind(node.target, self.classify(node.iter))
        self.generic_visit(node)

    # Don't descend into nested defs: they get their own flow pass.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


class HostSyncChecker:
    """Flags implicit device->host syncs inside declared hot-path zones."""

    rule = RULE

    def __init__(self, zones: tuple[Zone, ...] | None = None):
        if zones is None:
            from .zones import HOT_PATH_ZONES

            zones = HOT_PATH_ZONES
        self.zones = zones

    # ----------------------------------------------------------- interface
    def check(
        self, rel_path: str, tree: ast.Module, source: str
    ) -> list[Finding]:
        zone = zone_for(self.zones, rel_path)
        if zone is None:
            return []
        scopes = ScopeIndex(tree)
        findings: list[Finding] = []
        # One dataflow unit per function (plus the module body): nested
        # defs are their own unit, never re-checked under the outer
        # function's name classification.
        for unit in dataflow_units(tree):
            flow = _FunctionFlow()
            body = unit.body if isinstance(unit.body, list) else []
            for stmt in body:
                flow.visit(stmt)
            for node in own_nodes(unit):
                self._check_node(rel_path, node, flow, zone, scopes, findings)
        return findings

    def check_source(self, rel_path: str, source: str) -> list[Finding]:
        return self.check(rel_path, ast.parse(source), source)

    # ------------------------------------------------------------ internals

    def _check_node(
        self,
        rel_path: str,
        node: ast.AST,
        flow: _FunctionFlow,
        zone: Zone,
        scopes: ScopeIndex,
        findings: list[Finding],
    ) -> None:
        def flag(n: ast.AST, message: str) -> None:
            if not scopes.in_scope(n, zone):
                return
            findings.append(
                Finding(
                    rule=RULE,
                    file=rel_path,
                    line=n.lineno,
                    col=n.col_offset,
                    end_line=getattr(n, "end_lineno", n.lineno) or n.lineno,
                    message=message,
                )
            )

        if isinstance(node, ast.Call):
            self._check_call(node, flow, flag)
        elif isinstance(node, ast.Subscript):
            if flow.classify(node.value) == _DEVICE and flow.is_mask(node.slice):
                flag(
                    node,
                    "boolean-mask indexing of a device tensor reads its "
                    "count back to the host",
                )
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            self._check_truthy(node.test, flow, flag)
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                self._check_truthy(cond, flow, flag)
        elif isinstance(node, ast.BoolOp):
            for v in node.values:
                self._check_truthy(v, flow, flag)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            self._check_truthy(node.operand, flow, flag)

    def _check_call(self, node: ast.Call, flow: _FunctionFlow, flag) -> None:
        chain = attr_chain(node.func)
        if chain == ("torch", "cuda", "synchronize"):
            flag(node, "torch.cuda.synchronize() waits for the whole card")
            return
        if _is_torch_root(chain) and chain[-1] in _SHAPE_FNS and len(chain) == 2:
            fn = chain[-1]
            if fn == "where" and len(node.args) + len(node.keywords) != 1:
                return  # torch.where(cond, a, b) keeps its shape
            if fn == "repeat_interleave" and _kw(node, "output_size") is not None:
                return
            arg = node.args[0] if node.args else None
            if arg is not None and flow.classify(arg) != _HOST:
                flag(
                    node,
                    f"torch.{fn}(...) has a data-dependent output shape: "
                    f"its count is read back to the host",
                )
            return
        if not isinstance(node.func, ast.Attribute):
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _CASTS
                and node.args
                and flow.classify(node.args[0]) == _DEVICE
            ):
                flag(node, f"{node.func.id}() of a device tensor forces a host sync")
            return
        method = node.func.attr
        recv = flow.classify(node.func.value)
        if method == "synchronize":
            flag(node, ".synchronize() blocks the host in a hot-path zone")
        elif method in _SYNC_METHODS or (
            method == "to" and node.args and _is_cpu_const(node.args[0])
        ):
            # A receiver dataflow already proved HOST (a pinned buffer,
            # a numpy-backed tensor) is bookkeeping, not a sync.
            if recv != _HOST:
                what = "to(\"cpu\")" if method == "to" else f"{method}()"
                flag(node, f".{what} copies a device value to the host "
                     f"in a hot-path zone")
        elif method in _SHAPE_METHODS:
            if method == "repeat_interleave" and _kw(node, "output_size") is not None:
                return
            if recv != _HOST:
                flag(
                    node,
                    f".{method}() has a data-dependent output shape: its "
                    f"count is read back to the host",
                )

    @staticmethod
    def _check_truthy(test: ast.AST, flow: _FunctionFlow, flag) -> None:
        for expr, why in HostSyncChecker._truthy_exprs(test):
            if flow.classify(expr) == _DEVICE:
                flag(expr, f"{why} of a device tensor forces a host sync")

    @staticmethod
    def _truthy_exprs(test: ast.AST):
        """Expressions evaluated for truth in a test position: the bare
        value itself, and (the common accidental-sync idiom) each side
        of a comparison (`if n > 0:` blocks exactly like `if n:`).
        Identity checks (`is` / `is not`) never read the tensor and are
        skipped: `if self.k_cache is None:` is the lazy-init idiom, not
        a sync. BoolOp / `not` sub-expressions yield nothing here: the
        tree walk visits those nodes directly, so expanding them again
        would double-report."""
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return
            for e in [test.left, *test.comparators]:
                yield e, "comparison"
        elif isinstance(test, ast.BoolOp) or (
            isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
        ):
            return
        else:
            yield test, "truthiness"

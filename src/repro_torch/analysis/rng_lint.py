"""AST lint enforcing the port's RNG and host-sync discipline (port of
``repro.analysis.rng_lint``, DESIGN.md §15).

Walks every Python file under the given roots and emits
:class:`~repro_torch.analysis.findings.Finding` records.  The port draws
every stream from ``core.rng.generator(device, seed, *parts)`` (a fresh
``torch.Generator`` seeded by ``derive_seed(seed, *parts)``) where the
reference folds JAX keys, so the reference's key rules become rules about
generators and seed parts:

``rng-global-draw`` (reference: ``rng-raw-key``)
    A torch sampler with no ``generator=`` (``torch.rand`` / ``randn`` /
    ``randint`` / ``randperm`` / ``bernoulli`` / ``multinomial`` /
    ``normal`` / ``poisson`` and their ``*_like`` forms, the in-place
    ``.uniform_`` / ``.normal_`` / ``.bernoulli_`` / ``.random_`` /
    ``.exponential_`` ...), or any draw from numpy's module-level RNG
    (``np.random.<sampler>``, ``np.random.seed``): a draw from a global
    stream depends on every draw before it, so a run is no longer a
    function of its seed and round index.
``rng-fixed-seed`` (reference: ``rng-raw-key``)
    A literal seed passed to ``generator`` (its first part),
    ``derive_seed``, ``manual_seed``, ``torch.manual_seed`` or
    ``np.random.default_rng`` in library code.
``rng-stream-reuse`` (reference: ``rng-key-reuse``)
    Two generators (or ``derive_seed`` seeds) built from the same parts
    in one scope: identical parts mean identical streams.  Uses in
    different arms of one conditional (an ``if`` statement, the code
    after an ``if`` whose body returns, or a conditional expression) are
    exclusive and exempt.
``rng-generator-fanout`` (reference: ``rng-key-fanout``)
    One ``Generator`` object (bound from ``generator(...)`` /
    ``torch.Generator(...)`` in the scope, or a parameter annotated
    ``torch.Generator``) handed to two consumer calls: their draws are
    coupled by order, so injecting one consumer's randomness (the parity
    tests' ``Draws``) shifts the other's.
``rng-stream-tag`` (reference: ``rng-fold-tag``)
    A constant string part of a ``generator`` or ``derive_seed`` call
    that is not registered in :mod:`repro_torch.analysis.tags`.
``loop-host-sync`` (reference: ``scan-host-sync``)
    In a function reachable from a round-loop root (:data:`LOOP_ROOTS`):
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
    ``float`` / ``int`` / ``bool`` of a tensor-tainted value, or one
    formatted into an f-string; ``torch.nonzero`` / ``unique`` /
    ``masked_select`` / ``argwhere`` / ``equal`` / ``allclose``, a
    one-argument ``torch.where``, ``repeat_interleave`` with no
    ``output_size``; ``torch.cuda.synchronize`` and any
    ``.synchronize()``; and a host-to-device copy
    (``torch.tensor`` / ``torch.as_tensor`` with ``device=``, ``.cuda()``,
    ``.to(<device>)``), which on the card waits for the stream as a
    read does (``torch.cuda.set_sync_debug_mode`` reports both).
``loop-tensor-if`` (reference: ``scan-tracer-if``)
    In the same functions: an ``if``, ``while`` or ``assert`` whose test
    reads a tensor-tainted value, an implicit ``__bool__`` sync.  Shape,
    ``dtype``, ``is None`` / ``is not None``, ``isinstance`` and ``len``
    tests are excluded.

``scan-fresh-lambda`` has no counterpart: it guards compile caches keyed
by a callable's identity, which eager torch does not have.  The port's
caches on a round path (``kernels.dasha_update.quantize_plan`` /
``sparsify_plan``, ``models.common.dtype_scalar``) are ``lru_cache``\\ s
keyed by ints, bools and dtypes, never by a callable, so a fresh closure
costs a round nothing there.

Reachability is a per-repo call graph seeded at the declared roots and
closed over callee *names*, as the reference's is at ``lax.scan`` bodies:
an attribute call matches any same-named function anywhere in the linted
tree.  That over-approximates (a name match marks more code as hot), so
the hot-path rules gate on *tensor taint*: a function's parameters
(except ``self`` / ``cls`` and parameters annotated with a host type such
as ``int`` or ``np.ndarray``), any ``torch.<op>(...)`` result, and names
assigned from them.  Static reads (``.shape``, ``.dtype``, ``.device``,
``len``, the state's ``t`` / ``seed``) and calls that return host values
(``int(...)``, ``.item()``, a function annotated ``-> int``) do not
taint.  A root that matches no function is itself a finding
(``loop-root-stale``), as a stale allowlist entry is.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .tags import REGISTERED_TAGS, TAG_NAMES

#: the round loops the hot-path rules start from, as (path suffix,
#: qualname): the Driver's chunk (``Sweeper``'s ``_LaneDriver`` inherits
#: it), the vectorized simulator's chunks and async campaign, the heap
#: simulator's chunk, faulted and async loops, and the trainer's round
#: (the per-chunk hook of ``launch.train.train``'s Driver loop and the
#: seed-era train step)
LOOP_ROOTS: Tuple[Tuple[str, str], ...] = (
    ("repro_torch/methods/driver.py", "Driver._run_chunk"),
    ("repro_torch/fed/vecsim.py", "VecFedSim._chunk_scatter"),
    ("repro_torch/fed/vecsim.py", "VecFedSim._chunk_slab"),
    ("repro_torch/fed/vecsim.py", "VecFedSim._chunk_faulted"),
    ("repro_torch/fed/vecsim.py", "VecFedSim._run_async"),
    ("repro_torch/fed/sim.py", "FedSim._run_chunk"),
    ("repro_torch/fed/sim.py", "FedSim._run_faulted"),
    ("repro_torch/fed/sim.py", "FedSim._run_async"),
    ("repro_torch/launch/train.py", "train.hook"),
    ("repro_torch/optim/distributed.py", "make_train_step.step"),
)
#: callee names reachability never follows: a round never starts a run,
#: and every ``run`` / ``main`` of the port is a caller of the loops
LOOP_ENTRIES = {"run", "main"}

#: torch samplers that draw from the global generator unless given one
TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
#: in-place tensor samplers (``x.uniform_(...)``)
INPLACE_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "log_normal_", "geometric_",
}
#: ``np.random`` attributes that do not draw from numpy's global RNG
NP_RANDOM_SAFE = {
    "default_rng", "Generator", "RandomState", "SeedSequence",
    "BitGenerator", "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}
NP_ALIASES = {"np", "numpy", "onp"}
#: callees whose first positional argument is a seed
SEEDERS = {"manual_seed", "manual_seed_all", "default_rng", "seed",
           "RandomState"}

#: tensor methods that read the device value on the host
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: torch ops (``torch.x(...)`` or ``t.x(...)``) whose output shape or
#: Python result depends on the data
SYNC_OPS = {"nonzero", "unique", "unique_consecutive", "masked_select",
            "argwhere", "equal", "allclose", "is_nonzero"}
#: builtins that read a tensor's value on the host
HOST_CASTS = {"float", "int", "bool", "complex"}
#: calls whose result is a host value whatever their arguments
HOST_CALLS = HOST_CASTS | {"len", "str", "repr", "isinstance", "hasattr",
                           "callable", "type", "id", "getattr", "range",
                           "tuple", "list", "sorted"}
#: tensor methods whose result is a host value (no device read)
HOST_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                "is_contiguous", "stride", "storage_offset", "nelement",
                "item", "tolist", "get_device", "is_floating_point",
                "is_complex", "join", "format", "encode", "decode",
                "startswith", "endswith", "lower", "upper", "strip"}
#: attribute reads that are static on the host (never taint a test); the
#: state's round index ``t`` / ``step`` and ``seed`` are Python ints by the
#: port's RNG contract (``core/rng.py``)
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "type", "is_cuda",
                "layout", "requires_grad", "itemsize", "nbytes", "names",
                "t", "seed", "step"}
#: torch functions that return host objects
TORCH_HOST_FUNCS = {"device", "Size", "is_tensor", "is_floating_point",
                    "is_complex", "is_grad_enabled", "get_default_dtype",
                    "finfo", "iinfo", "Generator", "no_grad", "enable_grad",
                    "inference_mode", "is_available", "current_device",
                    "device_count", "get_device_name", "promote_types",
                    "result_type", "can_cast", "current_stream", "Event",
                    "Stream", "set_sync_debug_mode", "get_sync_debug_mode",
                    "max_memory_allocated", "memory_allocated", "dtype"}
#: annotations of parameters that hold host values
HOST_TYPES = {"int", "float", "bool", "str", "bytes", "complex", "ndarray",
              "Path", "Callable", "Namespace", "Generator"}

_FUNCLIKE = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
#: statements that leave their block
_EXITS = (ast.Return, ast.Raise, ast.Continue, ast.Break)
_SCOPES = _FUNCLIKE + (ast.ClassDef,)


def _terminal_name(node: ast.AST) -> Optional[str]:
    """foo -> 'foo'; a.b.foo -> 'foo'; anything else -> None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` -> 'a.b.c' for a chain of names (else '')."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_torch_call(func: ast.AST) -> bool:
    """``torch.x(...)`` / ``torch.a.x(...)``."""
    return _dotted(func).split(".")[0] == "torch" and \
        isinstance(func, ast.Attribute)


def _is_np_random(func: ast.AST) -> bool:
    """``np.random.<x>`` (or ``numpy.random.<x>``)."""
    if not isinstance(func, ast.Attribute):
        return False
    base = func.value
    return isinstance(base, ast.Attribute) and base.attr == "random" \
        and isinstance(base.value, ast.Name) and base.value.id in NP_ALIASES


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _walk_same_scope(node: ast.AST) -> List[ast.AST]:
    """Descendants, without entering nested function/class scopes."""
    return _descendants(node, _SCOPES)


def _walk_with_lambdas(node: ast.AST) -> List[ast.AST]:
    """Descendants, entering lambdas (an inline lambda runs as part of its
    function) but not nested ``def`` or ``class`` scopes."""
    return _descendants(node, _DEFS)


def _descendants(node: ast.AST, stop) -> List[ast.AST]:
    out: List[ast.AST] = []
    stack = [c for c in ast.iter_child_nodes(node)
             if not isinstance(c, stop)]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(c for c in ast.iter_child_nodes(n)
                     if not isinstance(c, stop))
    return out


def _own_exprs(st: ast.stmt) -> List[ast.expr]:
    """The statement's immediate expressions (not nested statements)."""
    out = []
    for child in ast.iter_child_nodes(st):
        if isinstance(child, ast.expr):
            out.append(child)
        elif isinstance(child, (ast.withitem, ast.comprehension)):
            out.extend(c for c in ast.iter_child_nodes(child)
                       if isinstance(c, ast.expr))
    return out


def _nested_bodies(st: ast.stmt) -> Iterator[Tuple[str, List[ast.stmt]]]:
    for attr in ("body", "orelse", "finalbody"):
        sub = getattr(st, attr, None)
        if sub and isinstance(sub[0], ast.stmt):
            yield attr, sub
    for i, h in enumerate(getattr(st, "handlers", []) or []):
        yield f"handler{i}", h.body


@dataclasses.dataclass
class FuncInfo:
    path: str
    qualname: str
    node: ast.AST          # FunctionDef | AsyncFunctionDef | Lambda | Module
    callees: Set[str]      # terminal names of calls + bare-Name call args
    is_root: bool = False

    def body_stmts(self) -> List[ast.stmt]:
        if isinstance(self.node, ast.Lambda):
            e = ast.Expr(self.node.body)
            ast.copy_location(e, self.node.body)
            return [e]
        return list(self.node.body)


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    """True when an annotation names a host type and no tensor."""
    if ann is None:
        return False
    names = {_terminal_name(n) for n in ast.walk(ann)} - {None}
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        names = set(ann.value.replace("[", " ").replace("]", " ")
                    .replace(",", " ").replace(".", " ").split())
    return bool(names & HOST_TYPES) and "Tensor" not in names


class _Collector(ast.NodeVisitor):
    """Pass A: enumerate functions, their callee names, and the names of
    functions whose return annotation is a host type."""

    def __init__(self, path: str, tree: ast.AST):
        self.path = path
        self.tree = tree
        self.stack: List[str] = []
        self.funcs: List[FuncInfo] = []
        self.host_returns: Set[str] = set()
        #: annotated class fields: name -> whether every annotation of it
        #: in this file is a host type
        self.fields: Dict[str, bool] = {}
        self.visit(tree)

    def visit_ClassDef(self, node: ast.ClassDef):
        for st in node.body:
            if isinstance(st, ast.AnnAssign) and \
                    isinstance(st.target, ast.Name):
                name = st.target.id
                self.fields[name] = self.fields.get(name, True) and \
                    _host_annotation(st.annotation)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node, name: str):
        callees: Set[str] = set()
        subs = list(_walk_with_lambdas(node))
        stored = {n.id for n in subs if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Store)}
        for sub in subs:
            if isinstance(sub, ast.Call):
                t = _terminal_name(sub.func)
                if t:
                    callees.add(t)
                for a in sub.args:
                    # higher-order: f(body, ...), unless the name is a value
                    # the function binds itself
                    if isinstance(a, ast.Name) and a.id not in stored:
                        callees.add(a.id)
        self.funcs.append(
            FuncInfo(self.path, ".".join(self.stack + [name]), node, callees))
        if not isinstance(node, ast.Lambda) and \
                _host_annotation(node.returns):
            self.host_returns.add(name)
        self.stack.append(name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_func(node, "<lambda>")

    def module_scope(self) -> FuncInfo:
        return FuncInfo(self.path, "", self.tree, set())


def _mark_roots(collectors: Sequence[_Collector],
                roots: Sequence[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """Mark the functions the roots name; returns the roots that match
    none."""
    missing = []
    for suffix, qual in roots:
        hit = False
        for col in collectors:
            if not col.path.endswith(suffix):
                continue
            for f in col.funcs:
                if f.qualname == qual:
                    f.is_root = hit = True
        if not hit:
            missing.append((suffix, qual))
    return missing


def _reachable(collectors: Sequence[_Collector]) -> Set[Tuple[str, str]]:
    """Close the root seeds over the global callee-name graph."""
    by_name: Dict[str, List[FuncInfo]] = {}
    for col in collectors:
        for f in col.funcs:
            by_name.setdefault(f.qualname.rsplit(".", 1)[-1], []).append(f)
    frontier = [f for col in collectors for f in col.funcs if f.is_root]
    seen: Set[Tuple[str, str]] = set()
    while frontier:
        f = frontier.pop()
        key = (f.path, f.qualname)
        if key in seen:
            continue
        seen.add(key)
        for callee in f.callees - LOOP_ENTRIES:
            frontier.extend(g for g in by_name.get(callee, ())
                            if (g.path, g.qualname) not in seen)
    return seen


# ---------------------------------------------------------------------------
# Per-scope RNG rules
# ---------------------------------------------------------------------------

#: a use's branch context: innermost-out stack of (conditional id, arm).
#: Two uses are mutually exclusive -- and so never build the same stream
#: twice -- when they sit in different arms of the same conditional
_Branch = Tuple[Tuple[int, str], ...]


def _exclusive(a: _Branch, b: _Branch) -> bool:
    arms_a = dict(a)
    return any(arms_a.get(cond_id, arm) != arm for cond_id, arm in b)


def _branch_map(root: ast.AST, base: _Branch) -> Dict[int, _Branch]:
    """id(node) -> branch stack for every node under ``root``."""
    out: Dict[int, _Branch] = {}

    def rec(n: ast.AST, branch: _Branch) -> None:
        out[id(n)] = branch
        if isinstance(n, ast.IfExp):
            rec(n.test, branch)
            rec(n.body, branch + ((id(n), "body"),))
            rec(n.orelse, branch + ((id(n), "orelse"),))
            return
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, _SCOPES):
                rec(c, branch)

    rec(root, base)
    return out


def _is_generator_call(call: ast.Call) -> bool:
    """``generator(device, *parts)`` (core.rng) or ``torch.Generator(...)``."""
    t = _terminal_name(call.func)
    return t == "generator" or (t == "Generator" and _is_torch_call(call.func))


def _stream_parts(call: ast.Call) -> Optional[List[ast.expr]]:
    """The seed parts of a stream-building call: ``generator``'s args after
    the device, ``derive_seed``'s args; None for other calls."""
    t = _terminal_name(call.func)
    if t == "generator" and call.args:
        return list(call.args[1:])
    if t == "derive_seed":
        return list(call.args)
    return None


def _is_literal_number(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float)) and \
        not isinstance(node.value, bool)


def _global_draw(call: ast.Call) -> Optional[str]:
    """What global stream ``call`` draws from, or None."""
    f = call.func
    t = _terminal_name(f)
    has_gen = _kw(call, "generator") is not None
    if t in TORCH_SAMPLERS and _is_torch_call(f) and not has_gen:
        return f"{_dotted(f)}() draws from torch's global generator"
    if t in INPLACE_SAMPLERS and isinstance(f, ast.Attribute) \
            and not has_gen:
        return f".{t}() draws from torch's global generator"
    if _is_np_random(f) and t not in NP_RANDOM_SAFE:
        return f"{_dotted(f)}() uses numpy's global RNG"
    return None


def _fixed_seed(call: ast.Call) -> bool:
    t = _terminal_name(call.func)
    if t == "generator" and len(call.args) >= 2:
        return _is_literal_number(call.args[1])
    if t == "derive_seed" and call.args:
        return _is_literal_number(call.args[0])
    if t in SEEDERS and call.args and isinstance(call.func, ast.Attribute):
        return _is_literal_number(call.args[0])
    return False


def _rng_rules(fn: FuncInfo, out: List[Finding]) -> None:
    """rng-global-draw / rng-fixed-seed / rng-stream-reuse /
    rng-generator-fanout / rng-stream-tag."""
    epoch: Dict[str, int] = {}
    gens: Set[Tuple[str, int]] = set()          # names bound to a Generator
    streams: Dict[str, List[Tuple[ast.Call, _Branch]]] = {}
    consumers: Dict[Tuple[str, int], List[Tuple[ast.Call, _Branch]]] = {}

    def cur(name: str) -> Tuple[str, int]:
        return (name, epoch.get(name, 0))

    node = fn.node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.annotation is not None and "Generator" in {
                    _terminal_name(n) for n in ast.walk(arg.annotation)}:
                gens.add(cur(arg.arg))

    def bind(target: ast.AST, is_gen: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                bind(elt, False)
            return
        if isinstance(target, ast.Name):
            epoch[target.id] = epoch.get(target.id, 0) + 1
            if is_gen:
                gens.add(cur(target.id))

    def use_call(call: ast.Call, branch: _Branch) -> None:
        msg = _global_draw(call)
        if msg:
            out.append(Finding("rng-global-draw", fn.path, call.lineno,
                               fn.qualname, msg + " — pass a generator "
                               "from core.rng.generator(...)"))
        if _fixed_seed(call):
            out.append(Finding(
                "rng-fixed-seed", fn.path, call.lineno, fn.qualname,
                f"{ast.unparse(call.func)}() gets a literal seed — derive "
                "it from the run's seed"))
        parts = _stream_parts(call)
        if parts is not None:
            _tag_rule(fn, call, parts, out)
            if parts:
                key = ast.dump(ast.Tuple(elts=parts, ctx=ast.Load()))
                uses = streams.setdefault(key, [])
                if any(not _exclusive(branch, b) for _, b in uses):
                    first = uses[0][0]
                    out.append(Finding(
                        "rng-stream-reuse", fn.path, call.lineno,
                        fn.qualname,
                        f"stream parts {ast.unparse(ast.Tuple(elts=parts, ctx=ast.Load()))!r}"
                        f" built twice (first at line {first.lineno}): "
                        "identical streams"))
                uses.append((call, branch))
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Name) and cur(arg.id) in gens:
                uses = consumers.setdefault(cur(arg.id), [])
                if any(not _exclusive(branch, b) for _, b in uses):
                    first = uses[0][0]
                    out.append(Finding(
                        "rng-generator-fanout", fn.path, call.lineno,
                        fn.qualname,
                        f"generator {arg.id!r} reaches a second consumer "
                        f"call (first at line {first.lineno}): their draws "
                        "are coupled by order"))
                uses.append((call, branch))

    def walk_stmts(stmts: Sequence[ast.stmt], base: _Branch) -> None:
        for st in stmts:
            if isinstance(st, _SCOPES):
                continue                 # nested scopes get their own pass
            if isinstance(st, ast.If) and not st.orelse and st.body and \
                    isinstance(st.body[-1], _EXITS):
                # an early exit: the statements after the `if` are its
                # else arm
                walk_stmts(st.body, base + ((id(st), "body"),))
                base = base + ((id(st), "orelse"),)
                for e in _own_exprs(st):
                    for sub in [e, *_walk_same_scope(e)]:
                        if isinstance(sub, ast.Call):
                            use_call(sub, base[:-1])
                continue
            for e in _own_exprs(st):
                subs = [e, *_walk_same_scope(e)]
                branches = _branch_map(e, base) if any(
                    isinstance(n, ast.IfExp) for n in subs) else {}
                for sub in subs:
                    if isinstance(sub, ast.Call):
                        use_call(sub, branches.get(id(sub), base))
            if isinstance(st, ast.Assign):
                is_gen = isinstance(st.value, ast.Call) \
                    and _is_generator_call(st.value)
                for tgt in st.targets:
                    bind(tgt, is_gen)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                bind(st.target, isinstance(st.value, ast.Call)
                     and _is_generator_call(st.value))
            for arm, body in _nested_bodies(st):
                walk_stmts(body, base + ((id(st), arm),)
                           if isinstance(st, ast.If) else base)

    walk_stmts(fn.body_stmts(), ())


def _tag_rule(fn: FuncInfo, call: ast.Call, parts: List[ast.expr],
              out: List[Finding]) -> None:
    for part in parts:
        if isinstance(part, ast.Starred):
            continue
        name = _terminal_name(part)
        if isinstance(part, (ast.Name, ast.Attribute)) \
                and name in REGISTERED_TAGS:
            continue
        if isinstance(part, ast.Constant) and isinstance(part.value, str) \
                and part.value not in TAG_NAMES:
            out.append(Finding(
                "rng-stream-tag", fn.path, call.lineno, fn.qualname,
                f"stream part {part.value!r} is not in the "
                "repro_torch.analysis.tags registry"))


# ---------------------------------------------------------------------------
# Hot-path rules
# ---------------------------------------------------------------------------

def _taint_seeds(node: ast.AST) -> Set[str]:
    if not hasattr(node, "args") or not isinstance(node.args, ast.arguments):
        return set()
    args = node.args
    out = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.arg in {"self", "cls"} or _host_annotation(a.annotation):
            continue
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    if args.kwarg:
        out.add(args.kwarg.arg)
    return out


class _Taint:
    """Tensor taint of one function: which expressions may hold a device
    tensor."""

    def __init__(self, fn: FuncInfo, host_returns: Set[str],
                 host_fields: Set[str]):
        self.names = _taint_seeds(fn.node)
        self.host_returns = host_returns
        self.static_attrs = STATIC_ATTRS | host_fields

    def host_call(self, call: ast.Call) -> bool:
        """True when the call's result is a host value."""
        f = call.func
        t = _terminal_name(f)
        if isinstance(f, ast.Name):
            return t in HOST_CALLS or t in self.host_returns
        if t in HOST_METHODS or _dotted(f).split(".")[0] in NP_ALIASES:
            return True                  # numpy computes on the host
        if _is_torch_call(f):
            return t in TORCH_HOST_FUNCS
        return t in self.host_returns

    def hits(self, expr: ast.AST) -> Set[str]:
        """Tainted names read in ``expr`` (a pseudo-name for a torch op's
        result), skipping host reads: static attributes, host calls and
        identity tests."""
        found: Set[str] = set()

        def rec(n: ast.AST) -> None:
            if isinstance(n, _SCOPES):
                return
            if isinstance(n, ast.Compare) \
                    and all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                            ast.NotIn)) for op in n.ops):
                return           # identity and membership tests: host bools
            if isinstance(n, ast.IfExp):         # the value, not the test
                rec(n.body)
                rec(n.orelse)
                return
            if isinstance(n, ast.Attribute) and n.attr in self.static_attrs:
                return
            if isinstance(n, ast.Call):
                if self.host_call(n):
                    return
                if _is_torch_call(n.func):
                    found.add(f"<{_dotted(n.func)}()>")
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in self.names:
                found.add(n.id)
            for c in ast.iter_child_nodes(n):
                rec(c)

        rec(expr)
        return found

    def assign(self, st: ast.stmt) -> None:
        """Propagate taint through the statement's bindings."""
        targets: List[ast.AST] = []
        value = None
        if isinstance(st, ast.Assign):
            targets, value = st.targets, st.value
        elif isinstance(st, (ast.AnnAssign, ast.AugAssign)) \
                and st.value is not None:
            targets, value = [st.target], st.value
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            targets, value = [st.target], st.iter
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                if item.optional_vars is not None and self.hits(
                        item.context_expr):
                    self._taint_target(item.optional_vars)
            return
        if value is not None and self.hits(value):
            for tgt in targets:
                self._taint_target(tgt)

    def _taint_target(self, tgt: ast.AST) -> None:
        """Taint the names a target binds (not the object of an attribute
        or item it writes: ``self.x = t`` leaves ``self`` clean)."""
        if isinstance(tgt, ast.Name):
            self.names.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._taint_target(elt)
        elif isinstance(tgt, ast.Starred):
            self._taint_target(tgt.value)


def _device_arg(call: ast.Call) -> bool:
    """``.to(...)`` names a device: a ``device=`` keyword, a string, a
    ``torch.device(...)``, or a name the port gives devices (``dev``,
    ``device``, ``problem.device`` ...)."""
    if _kw(call, "device") is not None:
        return True
    if not call.args:
        return False
    a = call.args[0]
    if isinstance(a, ast.Constant):
        return isinstance(a.value, str)
    if isinstance(a, ast.Call):
        return _terminal_name(a.func) == "device"
    t = _terminal_name(a)
    return bool(t) and "dev" in t.lower()


def _to_cpu(call: ast.Call) -> bool:
    dev = _kw(call, "device") or (call.args[0] if call.args else None)
    if isinstance(dev, ast.Constant):
        return dev.value == "cpu"
    if isinstance(dev, ast.Call) and _terminal_name(dev.func) == "device" \
            and dev.args and isinstance(dev.args[0], ast.Constant):
        return dev.args[0].value == "cpu"
    return False


def _sync_message(call: ast.Call, taint: _Taint) -> Optional[str]:
    """Why ``call`` waits for the device, or None."""
    f = call.func
    t = _terminal_name(f)
    text = ast.unparse(f)
    if isinstance(f, ast.Attribute):
        recv = f.value
        if t in SYNC_METHODS and taint.hits(recv):
            return f"{text}() reads a device value on the host"
        if t == "to" and _to_cpu(call):
            return f"{text}('cpu') copies to the host"
        if t == "synchronize":
            return f"{text}() waits for the device"
        if t in SYNC_OPS and (_is_torch_call(f) or taint.hits(recv)) \
                and _dotted(recv) not in NP_ALIASES:
            return f"{text}() has a data-dependent result"
        if t == "repeat_interleave" and _kw(call, "output_size") is None:
            # t.repeat_interleave(repeats) / torch.repeat_interleave(t,
            # repeats): a tensor of repeats is read on the host
            pos = 1 if _is_torch_call(f) else 0
            reps = _kw(call, "repeats") or (
                call.args[pos] if len(call.args) > pos else None)
            if reps is not None and taint.hits(reps):
                return (f"{text}() of tensor repeats without output_size "
                        "reads them on the host")
        if t == "where" and _is_torch_call(f) and len(call.args) == 1:
            return f"{text}(cond) has a data-dependent result"
        if t in ("tensor", "as_tensor") and _is_torch_call(f) \
                and _kw(call, "device") is not None:
            return (f"{text}(..., device=) copies host data to the device "
                    "and waits for the stream")
        if t == "cuda" and not _is_torch_call(f) and not call.args:
            return f"{text}() copies host data to the device"
        non_blocking = _kw(call, "non_blocking")
        if t == "to" and _device_arg(call) and not (
                isinstance(non_blocking, ast.Constant) and non_blocking.value):
            return (f"{text}(<device>) may copy between host and device "
                    "and wait for the stream")
        return None
    if t in HOST_CASTS and isinstance(f, ast.Name):
        args = list(call.args)
        if any(taint.hits(a) for a in args):
            return f"{t}() of a tensor reads its value on the host"
    return None


def _loop_rules(fn: FuncInfo, host_returns: Set[str], host_fields: Set[str],
                out: List[Finding]) -> None:
    """loop-host-sync / loop-tensor-if inside loop-reachable functions."""
    taint = _Taint(fn, host_returns, host_fields)
    for sub in _walk_with_lambdas(fn.node):
        if isinstance(sub, ast.Lambda):         # an inline lambda's args
            taint.names |= _taint_seeds(sub)

    def handle_expr(e: ast.AST) -> None:
        for sub in [e, *_walk_with_lambdas(e)]:
            if isinstance(sub, ast.Call):
                msg = _sync_message(sub, taint)
                if msg:
                    out.append(Finding("loop-host-sync", fn.path, sub.lineno,
                                       fn.qualname, msg))
            elif isinstance(sub, ast.FormattedValue) \
                    and taint.hits(sub.value):
                out.append(Finding(
                    "loop-host-sync", fn.path, sub.value.lineno, fn.qualname,
                    "formatting a tensor into a string reads it on the "
                    "host"))

    def test_of(st: ast.stmt) -> Optional[ast.expr]:
        if isinstance(st, (ast.If, ast.While, ast.Assert)):
            return st.test
        return None

    def walk_stmts(stmts: Sequence[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, _SCOPES):
                continue                 # nested defs are linted separately
            if not isinstance(st, ast.Raise):   # an error path, not a round
                for e in _own_exprs(st):
                    handle_expr(e)
            test = test_of(st)
            if test is not None:
                hits = taint.hits(test)
                if hits:
                    kind = type(st).__name__.lower()
                    out.append(Finding(
                        "loop-tensor-if", fn.path, st.lineno, fn.qualname,
                        f"`{kind}` on tensor value(s) {sorted(hits)} calls "
                        "__bool__, a host sync — use torch.where"))
            taint.assign(st)
            for _, body in _nested_bodies(st):
                walk_stmts(body)

    walk_stmts(fn.body_stmts())


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _py_files(roots: Sequence[str]) -> List[str]:
    files: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if not d.startswith((".", "__pycache__"))]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    return sorted(files)


def _lint(collectors: Sequence[_Collector],
          loop_roots: Sequence[Tuple[str, str]],
          out: List[Finding]) -> List[Finding]:
    for suffix, qual in _mark_roots(collectors, loop_roots):
        out.append(Finding("loop-root-stale", suffix, 0, qual,
                           "round-loop root matches no function"))
    hot = _reachable(collectors)
    host_returns = set().union(*(c.host_returns for c in collectors)) \
        if collectors else set()
    fields: Dict[str, bool] = {}
    for c in collectors:
        for name, host in c.fields.items():
            fields[name] = fields.get(name, True) and host
    host_fields = {name for name, host in fields.items() if host}
    for col in collectors:
        _rng_rules(col.module_scope(), out)
        for f in col.funcs:
            _rng_rules(f, out)
            if (f.path, f.qualname) in hot and \
                    not isinstance(f.node, ast.Lambda):
                _loop_rules(f, host_returns, host_fields, out)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def _collect(roots: Sequence[str], repo_root: str,
             out: List[Finding]) -> List[_Collector]:
    """Parse every ``*.py`` under ``roots``, paths relative to
    ``repo_root``; a file that does not parse becomes a finding."""
    collectors: List[_Collector] = []
    for path in _py_files(roots):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except SyntaxError as exc:
            out.append(Finding("syntax-error", rel, exc.lineno or 0, "",
                               str(exc.msg)))
            continue
        collectors.append(_Collector(rel, tree))
    return collectors


def lint_paths(roots: Sequence[str], repo_root: str = ".",
               loop_roots: Sequence[Tuple[str, str]] = ()
               ) -> List[Finding]:
    """Lint every ``*.py`` under ``roots``; returns raw (un-allowlisted)
    findings sorted by location.  The hot-path rules start from
    ``loop_roots`` (the port's are :data:`LOOP_ROOTS`)."""
    out: List[Finding] = []
    return _lint(_collect(roots, repo_root, out), loop_roots, out)


def lint_source(src: str, path: str = "<memory>",
                loop_roots: Sequence[str] = ()) -> List[Finding]:
    """Lint a source string — the hook the rule self-tests drive;
    ``loop_roots`` are qualnames in it that the hot-path rules start
    from."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [Finding("syntax-error", path, exc.lineno or 0, "",
                        str(exc.msg))]
    col = _Collector(path, tree)
    return _lint([col], [(path, q) for q in loop_roots], [])


def hot_functions(roots: Sequence[str], repo_root: str = ".",
                  loop_roots: Sequence[Tuple[str, str]] = ()):
    """The (path, qualname) of every function the hot-path rules lint:
    those reachable from ``loop_roots``."""
    collectors = _collect(roots, repo_root, [])
    _mark_roots(collectors, loop_roots)
    return _reachable(collectors)


def enclosing_function(path: str, line: int) -> str:
    """The qualname of the innermost function of ``path`` whose lines hold
    ``line`` ("" at module scope): where a runtime site sits, in the
    terms of a finding's ``symbol``."""
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    best = ""

    def rec(node: ast.AST, stack: List[str]) -> None:
        nonlocal best
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = stack + [child.name]
                if child.lineno <= line <= child.end_lineno:
                    if not isinstance(child, ast.ClassDef):
                        best = ".".join(inner)
                    rec(child, inner)
            elif isinstance(child, ast.Lambda):
                if child.lineno <= line <= child.end_lineno:
                    best = ".".join(stack + ["<lambda>"])
                rec(child, stack + ["<lambda>"])
            else:
                rec(child, stack)

    rec(tree, [])
    return best

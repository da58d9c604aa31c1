"""The port's lint rules (`repro_torch.staticcheck.rules`; counterpart of
``repro.staticcheck.rules``).

The reference's rules guard a traced JAX program: a Pallas kernel body, a
jit or scan body.  The port runs eagerly and launches hand-written CUDA
kernels through ``ctypes``, so its bug classes are others.  Each rule
here is the counterpart of one reference rule (named in brackets) and
carries a known-bad fixture under ``staticcheck/fixtures/``:

* ``KRN001`` (PAL001) -- a kernel wrapper reads a card tensor on the host
  to pick a branch or a kernel: ``.item()``, ``.tolist()``, or
  ``int`` / ``float`` / ``bool`` of a tensor or of its subscript.  Each
  launch then waits for the stream; ``kernels.fused_step`` selects among
  its six policies inside the kernel (``select_gamma``) for this reason.
* ``KRN002`` (PAL002) -- a function that hands ``.data_ptr()`` to a
  launcher also makes a tensor with no ``device=`` (``torch.zeros(())``,
  ``torch.from_numpy(a)``), not through ``*_like``, ``new_*`` or
  ``.to(dev)``.  The plain CPU path works; on the card the kernel is
  given a host pointer.
* ``KRN003`` (PAL003) -- in a module that loads a library through
  ``kernels.build.load``: a public wrapper that launches without
  ``kernel_route``; a device literal (``"cuda"``, ``"cuda:0"``,
  ``"cpu"``) on the launch path; a ``try`` around a build or launch whose
  ``except`` calls the plain version (``*_ref``) or returns -- the
  fallback that ``kernels.dispatch`` forbids.
* ``RNG001`` (JIT001) -- a draw from a global random state:
  ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``normal`` /
  ``bernoulli`` / ``multinomial`` (or an in-place ``x.uniform_()`` ...)
  without ``generator=``; ``np.random.<draw>`` (``default_rng(seed)``
  and ``Generator`` are the explicit form); the ``random`` module.
* ``HOST001`` (JIT002) -- a Python ``if`` / ``while`` inside a loop body
  whose test reads a tensor's value: one stream wait per event or step.
  Exempt: ``is [not] None``, ``isinstance`` and the metadata reads
  ``.shape``, ``.dtype``, ``.device``, ``.numel()`` (and ``.ndim``,
  ``.dim()``, ``.size()``, ``.is_cuda``, ``len``), which never wait.
* ``CACHE001`` (CACHE001) -- in-place mutation of a tensor after it was
  captured by ``IdKey`` / ``tree_key`` for a ``cached_program`` key:
  ``x[...] = ...``, ``x.add_(...)``, any ``*_`` method (``sweep.cache``
  keeps the reference's frozen-capture contract).

What the AST cannot see is decided by names: a tensor, for ``KRN001``, is
a name handed to ``kernel_route``, a name whose ``.data_ptr()`` is taken,
or a parameter annotated ``torch.Tensor``; for ``HOST001`` also a name
assigned from a ``torch.*`` call or from a tensor's own methods,
subscripts and arithmetic.  A conversion under ``torch.is_tensor(x)``
being false (``float(g) if not torch.is_tensor(g)``) is of a number.

Rules are pure AST analysis -- no import of ``torch`` or of the linted
code, so the lint runs in a fraction of a second.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["Finding", "ModuleInfo", "Rule", "ALL_RULES", "RULE_DOCS"]


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


# ------------------------------------------------------------- helpers ----

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func) or ""


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _walk_calls(node: ast.AST) -> Iterable[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def _own_body(func: ast.AST) -> Iterable[ast.AST]:
    """Walk a function's (or module's) body EXCLUDING nested function defs
    -- their statements belong to the nested scope.  Pre-order, source
    order, so assignments are seen before the branches that use them."""
    def rec(nodes):
        for n in nodes:
            if isinstance(n, _FUNC_NODES):
                continue  # nested scope: analyzed separately
            yield n
            yield from rec(ast.iter_child_nodes(n))
    yield from rec(getattr(func, "body", []))


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _is_method(call: ast.Call, *names: str) -> bool:
    return isinstance(call.func, ast.Attribute) and call.func.attr in names


def _is_launch_call(call: ast.Call) -> bool:
    """A call of a kernel launcher: ``lib.<kernel>_launch(...)``, the
    module's own ``_launch(...)``, or any callee (``fns[name](...)``)
    handed a ``.data_ptr()`` other than a list being filled."""
    name = _last(_call_name(call))
    if name.endswith("_launch"):
        return True
    return name not in ("append", "extend", "insert") and any(
        isinstance(a, ast.Call) and _is_method(a, "data_ptr")
        for a in call.args)


def _is_load_call(call: ast.Call) -> bool:
    return _last(_call_name(call)) == "load"


def _annotated_tensor(arg: ast.arg) -> bool:
    """A parameter annotated ``torch.Tensor`` (``| None`` and
    ``Optional[...]`` included)."""
    ann = arg.annotation
    return ann is not None and any(
        isinstance(n, (ast.Name, ast.Attribute))
        and _last(_dotted(n) or "") == "Tensor" for n in ast.walk(ann))


def _all_args(func: ast.AST) -> List[ast.arg]:
    a = getattr(func, "args", None)
    if a is None:
        return []
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs) + \
        ([a.vararg] if a.vararg else []) + ([a.kwarg] if a.kwarg else [])


def _target_names(target: ast.AST) -> Iterable[str]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def _is_tensor_test(test: ast.expr) -> Optional[str]:
    """The name ``x`` of a ``torch.is_tensor(x)`` or ``isinstance(x,
    torch.Tensor)`` test, else None."""
    if isinstance(test, ast.Call) and test.args \
            and isinstance(test.args[0], ast.Name):
        name = _last(_call_name(test))
        if name == "is_tensor" or (
                name == "isinstance" and len(test.args) == 2
                and _last(_dotted(test.args[1]) or "") == "Tensor"):
            return test.args[0].id
    return None


def _guarded_nodes(func: ast.AST) -> Dict[ast.AST, Set[str]]:
    """Every node of ``func``'s own body mapped to the names that are known
    NOT to be tensors there: the false branch of ``torch.is_tensor(x)``
    (in an ``if`` or a conditional expression), the true branch of ``not
    torch.is_tensor(x)``."""
    out: Dict[ast.AST, Set[str]] = {}

    def visit(node: ast.AST, guarded: frozenset):
        if isinstance(node, _FUNC_NODES) and node is not func:
            return
        out[node] = set(guarded)
        if isinstance(node, (ast.If, ast.IfExp)):
            test = node.test
            negated = isinstance(test, ast.UnaryOp) \
                and isinstance(test.op, ast.Not)
            name = _is_tensor_test(test.operand if negated else test)
            visit(test, guarded)
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) \
                else [node.orelse]
            g_body = guarded | {name} if (name and negated) else guarded
            g_else = guarded | {name} if (name and not negated) else guarded
            for n in body:
                visit(n, g_body)
            for n in orelse:
                visit(n, g_else)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    for stmt in getattr(func, "body", []):
        visit(stmt, frozenset())
    return out


class ModuleInfo:
    """Shared per-module analysis consumed by every rule."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.all_nodes = list(ast.walk(tree))
        self.all_calls = [n for n in self.all_nodes if isinstance(n, ast.Call)]
        # every named function in the module (any nesting), by bare name
        self.funcs: Dict[str, List[ast.AST]] = {}
        for n in self.all_nodes:
            if isinstance(n, _FUNC_NODES):
                self.funcs.setdefault(n.name, []).append(n)
        self.top_funcs = [n for n in tree.body if isinstance(n, _FUNC_NODES)]
        self.loads_kernels = any(
            isinstance(n, ast.ImportFrom)
            and (n.module or "").rsplit(".", 1)[-1] == "build"
            and any(a.name == "load" for a in n.names)
            for n in self.all_nodes) or any(
            _call_name(c).endswith("build.load") for c in self.all_calls)
        self._launch_path: Optional[Set[ast.AST]] = None
        self._nodes: Dict[int, List[ast.AST]] = {}

    def nodes(self, func: ast.AST) -> List[ast.AST]:
        """``_own_body(func)`` as a list, computed once per function."""
        key = id(func)
        if key not in self._nodes:
            self._nodes[key] = list(_own_body(func))
        return self._nodes[key]

    def calls(self, func: ast.AST) -> List[ast.Call]:
        return [n for n in self.nodes(func) if isinstance(n, ast.Call)]

    def private_closure(self, roots: Iterable[ast.AST]) -> Set[ast.AST]:
        """``roots`` plus the same-module functions they call whose names
        start with ``_``, transitively; plain versions (``*_ref``) and
        public functions are not entered."""
        seen = set(roots)
        frontier = list(seen)
        while frontier:
            f = frontier.pop()
            for call in self.calls(f):
                callee = _last(_call_name(call))
                if not callee.startswith("_") or callee.endswith("_ref"):
                    continue
                for g in self.funcs.get(callee, []):
                    if g not in seen:
                        seen.add(g)
                        frontier.append(g)
        return seen

    def launches(self, func: ast.AST) -> bool:
        return any(_is_launch_call(c) for c in self.calls(func))

    @property
    def wrappers(self) -> List[ast.AST]:
        """Public module-level functions whose private closure launches a
        kernel (a kernel module's entry points)."""
        return [f for f in self.top_funcs if not f.name.startswith("_")
                and any(self.launches(g)
                        for g in self.private_closure([f]))]

    @property
    def launch_path(self) -> Set[ast.AST]:
        """The functions a launch runs through in a kernel module: every
        launcher and every public wrapper's private closure (the plain
        versions left out); empty elsewhere."""
        if self._launch_path is None:
            path: Set[ast.AST] = set()
            if self.loads_kernels:
                launchers = [f for fs in self.funcs.values() for f in fs
                             if self.launches(f)]
                path = self.private_closure(launchers + self.wrappers)
            self._launch_path = path
        return self._launch_path


class Rule:
    name = ""
    doc = ""

    def check(self, info: ModuleInfo) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, info: ModuleInfo, node: ast.AST, msg: str) -> Finding:
        return Finding(info.path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), self.name, msg)


# --------------------------------------------------------------- rules ----

_HOST_CASTS = ("int", "float", "bool")


def _kernel_tensors(info: ModuleInfo, func: ast.AST) -> Set[str]:
    """Names a kernel wrapper treats as tensors: handed to
    ``kernel_route``, ``.data_ptr()`` taken, or annotated ``Tensor``."""
    names = {a.arg for a in _all_args(func) if _annotated_tensor(a)}
    for call in info.calls(func):
        if _last(_call_name(call)) == "kernel_route":
            names |= {a.id for a in call.args if isinstance(a, ast.Name)}
        if _is_method(call, "data_ptr") \
                and isinstance(call.func.value, ast.Name):
            names.add(call.func.value.id)
    return names


def _base_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class HostSelect(Rule):
    name = "KRN001"
    doc = ("a kernel wrapper reads a card tensor on the host (.item(), "
           ".tolist(), int/float/bool of a tensor) to pick a branch or a "
           "kernel: a stream wait per launch; select inside the kernel "
           "like fused_step.select_gamma")

    def check(self, info: ModuleInfo) -> List[Finding]:
        out = []
        for f in sorted(info.launch_path, key=lambda n: n.lineno):
            tensors = _kernel_tensors(info, f)
            guarded = _guarded_nodes(f)
            for call in info.calls(f):
                what = None
                if _is_method(call, "item", "tolist") and not call.args:
                    what = f".{call.func.attr}()"
                elif _call_name(call) in _HOST_CASTS and len(call.args) == 1:
                    base = _base_name(call.args[0])
                    if base in tensors and base not in guarded.get(call, ()):
                        what = f"{_call_name(call)}({ast.unparse(call.args[0])})"
                if what:
                    out.append(self.finding(
                        info, call,
                        f"{what} in kernel wrapper {f.name!r} reads a card "
                        "tensor on the host: every launch waits for the "
                        "stream; pass the tensor to the kernel and select "
                        "there (as fused_step.select_gamma does)"))
        return out


_FACTORIES = ("zeros", "ones", "empty", "full", "tensor", "arange",
              "linspace", "logspace", "eye", "empty_strided", "rand",
              "randn", "randint", "randperm", "from_numpy", "as_tensor")


class HostAlloc(Rule):
    name = "KRN002"
    doc = ("a function that hands .data_ptr() to a launcher makes a tensor "
           "with no device= (not *_like, new_* or .to(dev)): a host "
           "pointer reaches the kernel")

    def check(self, info: ModuleInfo) -> List[Finding]:
        out = []
        funcs = [f for fs in info.funcs.values() for f in fs]
        for f in sorted(funcs, key=lambda n: n.lineno):
            calls = info.calls(f)
            if not any(_is_method(c, "data_ptr") for c in calls):
                continue
            moved = {id(c.func.value) for c in calls
                     if _is_method(c, "to", "cuda")}
            for call in calls:
                name = _call_name(call)
                if not name.startswith("torch.") \
                        or _last(name) not in _FACTORIES \
                        or _has_kw(call, "device") or id(call) in moved:
                    continue
                out.append(self.finding(
                    info, call,
                    f"{name}(...) without device= in {f.name!r}, which "
                    "hands .data_ptr() to a launcher: the tensor is made "
                    "on the host and the kernel would read a host pointer; "
                    "pass device= (or use *_like / new_* / .to(dev))"))
        return out


_DEVICE_LITERALS = ("cuda", "cpu")


def _device_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and (node.value in _DEVICE_LITERALS or node.value.startswith("cuda:"))


class UnroutedLaunch(Rule):
    name = "KRN003"
    doc = ("a kernel launch not routed through kernels.dispatch: a public "
           "wrapper without kernel_route, a device literal on the launch "
           "path, or an except that falls back to the plain version")

    def check(self, info: ModuleInfo) -> List[Finding]:
        if not info.loads_kernels:
            return []
        out = []
        for f in info.wrappers:
            if not any(_last(_call_name(c)) == "kernel_route"
                       for g in info.private_closure([f])
                       for c in info.calls(g)):
                out.append(self.finding(
                    info, f,
                    f"public wrapper {f.name!r} launches a kernel without "
                    "kernels.dispatch.kernel_route: the device of its "
                    "tensors must choose the kernel or the plain version"))
        for f in sorted(info.launch_path, key=lambda n: n.lineno):
            for n in info.nodes(f):
                if _device_literal(n):
                    out.append(self.finding(
                        info, n,
                        f"device literal {n.value!r} on the launch path "
                        f"({f.name!r}): the device comes from the tensors "
                        "(kernel_route) or the caller (resolve_device)"))
        builds = {f.name for f in info.launch_path} | {
            name for name, fs in info.funcs.items()
            if any(_is_load_call(c) for f in fs for c in info.calls(f))}
        for n in info.all_nodes:
            if not isinstance(n, ast.Try):
                continue
            guarded = any(_is_launch_call(c) or _is_load_call(c)
                          or _last(_call_name(c)) in builds
                          for stmt in n.body for c in _walk_calls(stmt))
            if not guarded:
                continue
            for h in n.handlers:
                falls_back = any(
                    isinstance(x, ast.Return)
                    or (isinstance(x, ast.Call)
                        and _last(_call_name(x)).endswith("_ref"))
                    for stmt in h.body for x in ast.walk(stmt))
                if falls_back:
                    out.append(self.finding(
                        info, h,
                        "except around a kernel build or launch falls back "
                        "(returns, or calls the plain version): a kernel "
                        "that fails must raise (kernels.dispatch)"))
        return out


_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like")
_INPLACE_DRAWS = ("uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_")
_NP_EXPLICIT = ("default_rng", "Generator", "SeedSequence", "BitGenerator",
                "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937")


class GlobalRng(Rule):
    name = "RNG001"
    doc = ("a draw from a global random state (torch.rand*/normal/"
           "bernoulli/multinomial without generator=, np.random.<draw>, "
           "the random module); pass an explicit generator")

    def check(self, info: ModuleInfo) -> List[Finding]:
        random_mods = {a.asname or a.name for n in info.all_nodes
                       if isinstance(n, ast.Import) for a in n.names
                       if a.name == "random"}
        random_fns = {a.asname or a.name for n in info.all_nodes
                      if isinstance(n, ast.ImportFrom)
                      and n.module == "random" for a in n.names}
        out = []
        for call in info.all_calls:
            name = _call_name(call)
            parts = name.split(".")
            bad = False
            if len(parts) == 2 and parts[0] == "torch" \
                    and parts[1] in _TORCH_DRAWS:
                bad = not _has_kw(call, "generator")
            elif _is_method(call, *_INPLACE_DRAWS):
                bad = not _has_kw(call, "generator")
            elif len(parts) == 3 and parts[0] in ("np", "numpy") \
                    and parts[1] == "random":
                bad = parts[2] not in _NP_EXPLICIT
            elif (len(parts) == 2 and parts[0] in random_mods) \
                    or (len(parts) == 1 and name in random_fns):
                bad = True
            if bad:
                out.append(self.finding(
                    info, call,
                    f"{name}() draws from a global random state: results "
                    "then depend on every earlier draw in the process; "
                    "pass generator= (torch) or use "
                    "np.random.default_rng(seed)"))
        return out


_META_ATTRS = ("shape", "dtype", "device", "ndim", "is_cuda")
_META_METHODS = ("numel", "dim", "size")
_NOT_TENSOR_FNS = ("is_tensor", "device", "Generator", "no_grad",
                   "is_floating_point", "get_default_dtype", "Size",
                   "is_grad_enabled", "inference_mode", "iinfo", "finfo",
                   "numel", "dtype")


def _tensor_expr(node: ast.AST, tensors: Set[str]) -> bool:
    """True when ``node`` evaluates to a tensor as far as names tell: a
    ``torch.*`` call (not a metadata one), or a tensor name's subscript,
    arithmetic or method (not ``.item()``/``.tolist()``/metadata)."""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Call):
        name = _call_name(node)
        if name.startswith("torch.") and not name.startswith("torch.cuda."):
            return _last(name) not in _NOT_TENSOR_FNS
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in ("item", "tolist") + _META_METHODS:
                return False
            return _tensor_expr(node.func.value, tensors)
        return False
    if isinstance(node, ast.Subscript):
        return _tensor_expr(node.value, tensors)
    if isinstance(node, ast.BinOp):
        return _tensor_expr(node.left, tensors) \
            or _tensor_expr(node.right, tensors)
    if isinstance(node, ast.UnaryOp):
        return _tensor_expr(node.operand, tensors)
    if isinstance(node, ast.Attribute):
        return node.attr in ("T", "mT", "real", "imag") \
            and _tensor_expr(node.value, tensors)
    return False


def _reads_tensor_value(test: ast.expr, tensors: Set[str]) -> List[str]:
    """The tensor names whose VALUE ``test`` reads (sorted); [] when every
    tensor reference is an ``is``/``isinstance`` structure test or a
    metadata read."""
    if isinstance(test, ast.Compare) \
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return []
    if isinstance(test, ast.Call) and _last(_call_name(test)) in (
            "isinstance", "callable", "hasattr", "is_tensor"):
        return []
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _reads_tensor_value(test.operand, tensors)
    if isinstance(test, ast.BoolOp):
        return sorted({n for v in test.values
                       for n in _reads_tensor_value(v, tensors)})
    parents = {child: node for node in ast.walk(test)
               for child in ast.iter_child_nodes(node)}
    read = set()
    for n in ast.walk(test):
        if not (isinstance(n, ast.Name) and n.id in tensors):
            continue
        p = parents.get(n)
        if isinstance(p, ast.Attribute) and p.value is n:
            if p.attr in _META_ATTRS:
                continue
            if p.attr in _META_METHODS and isinstance(parents.get(p),
                                                      ast.Call):
                continue
        if isinstance(p, ast.Call) and _call_name(p) == "len":
            continue
        read.add(n.id)
    return sorted(read)


# the port's event loops: each calls the functions it is handed once per
# event (``core.engine``); a same-module function that hands one of its
# own parameters to a loop is a loop too (``federated.server._scan``)
_EVENT_LOOPS = ("solver_loop", "strided_scan")


def _passed_functions(arg: ast.AST) -> List[str]:
    """Names of the functions an argument hands over: a bare name, either
    side of a conditional expression, ``functools.partial(f, ...)``."""
    if isinstance(arg, ast.Name):
        return [arg.id]
    if isinstance(arg, ast.IfExp):
        return _passed_functions(arg.body) + _passed_functions(arg.orelse)
    if isinstance(arg, ast.Call) and _last(_call_name(arg)) == "partial" \
            and arg.args:
        return _passed_functions(arg.args[0])
    return []


def _loop_bodies(info: ModuleInfo) -> Dict[ast.AST, str]:
    """Functions run once per event -- handed by name to an event loop --
    and the functions nested in them, each with the loop's name."""
    funcs = [f for fs in info.funcs.values() for f in fs]
    loops = set(_EVENT_LOOPS)
    grew = True
    while grew:
        grew = False
        for f in funcs:
            params = {a.arg for a in _all_args(f)}
            if f.name not in loops and any(
                    _last(_call_name(c)) in loops
                    and any(isinstance(a, ast.Name) and a.id in params
                            for a in c.args) for c in info.calls(f)):
                loops.add(f.name)
                grew = True
    # a name rebound to another function (``advance = advance_guarded``)
    # hands over either
    aliases: Dict[str, Set[str]] = {}
    for n in info.all_nodes:
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Name) \
                and n.value.id in info.funcs:
            for t in n.targets:
                if isinstance(t, ast.Name):
                    aliases.setdefault(t.id, set()).add(n.value.id)
    bodies: Dict[ast.AST, str] = {}
    for call in info.all_calls:
        loop = _last(_call_name(call))
        if loop not in loops:
            continue
        for a in call.args:
            for name in _passed_functions(a):
                for alias in {name} | aliases.get(name, set()):
                    for f in info.funcs.get(alias, []):
                        bodies.setdefault(f, loop)
    for f, loop in list(bodies.items()):
        for n in ast.walk(f):
            if isinstance(n, _FUNC_NODES) and n not in bodies:
                bodies[n] = loop
    return bodies


class CardBranch(Rule):
    name = "HOST001"
    doc = ("a Python if/while whose test reads a tensor's value in a "
           "function an event loop runs per event, or inside a loop body "
           "(one stream wait per event or step; `is None`, isinstance and "
           ".shape/.dtype/.device/.numel() tests are exempt)")

    def check(self, info: ModuleInfo) -> List[Finding]:
        out = []
        bodies = _loop_bodies(info)
        for f, loop in sorted(bodies.items(), key=lambda kv: kv[0].lineno):
            # as the reference's JIT002: the body's arguments are traced
            # values, and so is what is computed from them
            tainted = {a.arg for a in _all_args(f)} - {"self"}
            for stmt in info.nodes(f):
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(n, ast.Name) and n.id in tainted
                        for n in ast.walk(stmt.value)):
                    for t in stmt.targets:
                        tainted |= set(_target_names(t))
                if isinstance(stmt, (ast.If, ast.While)):
                    names = _reads_tensor_value(stmt.test, tainted)
                    if names:
                        out.append(self.finding(
                            info, stmt,
                            f"host `{type(stmt).__name__.lower()}` on "
                            f"value(s) {names} in {f.name!r}, which "
                            f"{loop} runs once per event: every event "
                            "waits for the stream; keep the choice on the "
                            "device (torch.where) or branch on host "
                            "structure"))
        funcs = [f for fs in info.funcs.values() for f in fs
                 if f not in bodies]
        for f in sorted(funcs, key=lambda n: n.lineno):
            tensors = {a.arg for a in _all_args(f) if _annotated_tensor(a)}
            loops: List[ast.AST] = []
            for stmt in info.nodes(f):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                        and stmt.value is not None \
                        and _tensor_expr(stmt.value, tensors):
                    targets = stmt.targets if isinstance(stmt, ast.Assign) \
                        else [stmt.target]
                    for t in targets:
                        tensors |= set(_target_names(t))
                if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                        and _tensor_expr(stmt.iter, tensors):
                    tensors |= set(_target_names(stmt.target))
                if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    loops.append(stmt)
            seen = set()
            for loop in loops:
                body = [loop] if isinstance(loop, ast.While) else []
                body += [n for s in loop.body for n in _own_body_of(s)]
                for stmt in body:
                    if not isinstance(stmt, (ast.If, ast.While)) \
                            or id(stmt) in seen:
                        continue
                    seen.add(id(stmt))
                    names = _reads_tensor_value(stmt.test, tensors)
                    if names:
                        out.append(self.finding(
                            info, stmt,
                            f"host `{type(stmt).__name__.lower()}` on the "
                            f"value of tensor(s) {names} inside a loop of "
                            f"{f.name!r}: every pass waits for the stream; "
                            "keep the choice on the device (torch.where) "
                            "or test host metadata"))
        return out


def _own_body_of(stmt: ast.AST) -> Iterable[ast.AST]:
    """``stmt`` and its nested statements, nested defs excluded."""
    if isinstance(stmt, _FUNC_NODES):
        return
    yield stmt
    for child in ast.iter_child_nodes(stmt):
        yield from _own_body_of(child)


_MUTATING_METHODS = ("fill", "sort", "put", "resize", "itemset", "setfield",
                     "partition", "setflags")


def _mutating_method(attr: str) -> bool:
    """A tensor's in-place method (``add_``, ``copy_``, ``zero_``: one
    trailing underscore) or numpy's in-place ones."""
    return (attr.endswith("_") and not attr.endswith("__")) \
        or attr in _MUTATING_METHODS


class MutateCaptured(Rule):
    name = "CACHE001"
    doc = ("in-place mutation of a tensor after capture by IdKey/tree_key "
           "(cached_program treats captures as frozen)")

    def check(self, info: ModuleInfo) -> List[Finding]:
        out = []
        scopes: List[ast.AST] = [info.tree]
        scopes += [f for fs in info.funcs.values() for f in fs]
        for scope in scopes:
            nodes = info.nodes(scope)
            captured = {
                c.args[0].id
                for c in nodes if isinstance(c, ast.Call)
                and _last(_call_name(c)) in ("IdKey", "tree_key")
                and c.args and isinstance(c.args[0], ast.Name)}
            if not captured:
                continue
            for n in nodes:
                target = None
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id in captured:
                            target = t.value.id
                elif isinstance(n, ast.AugAssign) \
                        and isinstance(n.target, ast.Subscript) \
                        and isinstance(n.target.value, ast.Name) \
                        and n.target.value.id in captured:
                    target = n.target.value.id
                elif isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and _mutating_method(n.func.attr) \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id in captured:
                    target = n.func.value.id
                if target is not None:
                    out.append(self.finding(
                        info, n,
                        f"in-place mutation of {target!r} after it was "
                        "captured by IdKey/tree_key for a cached_program "
                        "key: identity-keyed captures are frozen -- the "
                        "cache would keep serving the program built on the "
                        "old contents (REPRO_CACHE_CHECK=1 catches this at "
                        "run time; build a new tensor instead)"))
        return out


ALL_RULES: Sequence[Rule] = (HostSelect(), HostAlloc(), UnroutedLaunch(),
                             GlobalRng(), CardBranch(), MutateCaptured())

RULE_DOCS = {r.name: r.doc for r in ALL_RULES}

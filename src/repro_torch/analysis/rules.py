"""The HFEL lint rules for the port. Port of ``repro.analysis.rules``.

The port's claims are parity contracts too (each kernel against its plain
version, every module against the JAX package's), and each rule checks one
way they rot in eager PyTorch:

HFEL001  unseeded randomness: numpy's module-level RNG and
         ``default_rng()`` without a seed (the JAX package's rule), and
         ``torch.rand*``, ``randn``, ``randint``, ``randperm``, ``normal``
         and the in-place ``normal_`` / ``uniform_`` / ``random_`` without
         ``generator=``: the port draws from explicit generators, never
         from torch's global one.
HFEL002  ``time.time()`` — non-monotonic under NTP; interval timing must use
         ``time.perf_counter()`` (wall-clock uses get a pragma).
HFEL003  host syncs in ``src/repro_torch/core`` and ``kernels``: ``.cpu()``,
         and ``.item()``, ``.tolist()``, ``float()``, ``int()``, ``bool()``
         or ``np.asarray``/``np.array`` of a tensor. On the card each one
         waits for every queued launch; the hot loops allow one a round.
HFEL005  float64 (``torch.float64``, ``.double()``, a ``"float64"``
         literal) in ``src/repro_torch/kernels`` — the kernels' arithmetic
         is float32 by parity contract.

The JAX package's other rules are about tracing and have no eager
counterpart, so the port has none of them (:data:`JAX_ONLY_NAMES` lists
their names): HFEL004 (Python control flow on traced values: eager control
flow reads concrete values, a host sync HFEL003 sees), HFEL006 (jitted
functions without buffer donation: an eager step updates in place) and
HFEL007 (``jax.random`` keys replicated under ``shard_map``: the port's
ranks hold explicit generators).

"Of a tensor" is a taint heuristic, tuned to this repo: within a function
(its nested functions sharing its names), a name assigned from an
expression with a ``torch.`` call or another tainted name is a tensor, and
so is a ``self.`` attribute assigned one anywhere in the module;
shape-like attribute reads (``.shape``, ``.ndim``, ``.dtype``, ...) and
``len()`` and friends break the taint.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding

# the JAX package's rule machinery that has no eager counterpart: the jit
# scope analysis behind HFEL003/004/006/007, and those rules (the port's
# HFEL003 is :func:`rule_hfel003`)
JAX_ONLY_NAMES = frozenset({
    "JIT_NAMES", "PARTIAL_NAMES", "WRAPPER_TAILS", "JitScope",
    "find_jit_scopes", "rule_hfel003_004", "HFEL006_MIN_TRACED",
    "rule_hfel006", "RNG_SPLIT_PREFIXES", "rule_hfel007",
})

DETAINT_ATTRS = {"shape", "ndim", "dtype", "size", "nbytes", "device",
                 "is_cuda", "layout", "itemsize", "requires_grad"}
DETAINT_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id",
                 "repr", "str", "numel", "dim", "size", "element_size",
                 "data_ptr", "is_contiguous", "is_floating_point"}
HOST_SYNC_BUILTINS = {"float", "bool", "int"}
HOST_SYNC_DOTTED = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
HOST_SYNC_METHODS = {"item", "tolist"}
NP_RANDOM_PREFIXES = ("np.random.", "numpy.random.")
SEEDED_CTOR_TAILS = {"default_rng", "Generator", "RandomState", "PCG64",
                     "Philox", "SFC64", "MT19937"}
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "rand_like",
                  "randn_like", "randint_like", "normal", "bernoulli",
                  "multinomial"}
TORCH_INPLACE_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                          "exponential_", "geometric_", "log_normal_",
                          "cauchy_"}
HOST_SYNC_DIRS = ("src/repro_torch/core/", "src/repro_torch/kernels/")
KERNEL_DIR = "src/repro_torch/kernels/"


def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _tail(name: str | None) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _finding(rule: str, path: str, lines: list[str], node: ast.AST,
             message: str) -> Finding:
    lineno = getattr(node, "lineno", 1)
    line = lines[lineno - 1].strip() if lineno <= len(lines) else ""
    return Finding(rule, path, lineno, getattr(node, "col_offset", 0),
                   message, line)


# -- HFEL001 / HFEL002 --------------------------------------------------------

def rule_hfel001(tree: ast.AST, path: str, lines: list[str]) -> list[Finding]:
    """Unseeded RNG: numpy's module-level samplers or unseeded generator
    constructors (as the JAX package's rule), and torch samplers without
    an explicit ``generator=``."""
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in TORCH_INPLACE_SAMPLERS and \
                not any(kw.arg == "generator" for kw in node.keywords):
            out.append(_finding(
                "HFEL001", path, lines, node,
                f".{node.func.attr}() without generator= draws from torch's "
                "global RNG — pass an explicit torch.Generator"))
            continue
        if name is None:
            continue
        if name.startswith("torch.") and name.count(".") == 1 and \
                _tail(name) in TORCH_SAMPLERS:
            if not any(kw.arg == "generator" for kw in node.keywords):
                out.append(_finding(
                    "HFEL001", path, lines, node,
                    f"{name}() without generator= draws from torch's "
                    "global RNG — pass an explicit torch.Generator"))
            continue
        if not name.startswith(NP_RANDOM_PREFIXES):
            if isinstance(node.func, ast.Name) and \
                    name == "default_rng" and not node.args:
                out.append(_finding(
                    "HFEL001", path, lines, node,
                    "default_rng() without a seed — pass an explicit seed "
                    "so runs are reproducible"))
            continue
        tail = _tail(name)
        if tail in SEEDED_CTOR_TAILS:
            seeded = bool(node.args) and not (
                isinstance(node.args[0], ast.Constant)
                and node.args[0].value is None)
            seeded = seeded or any(kw.arg == "seed" for kw in node.keywords)
            if not seeded:
                out.append(_finding(
                    "HFEL001", path, lines, node,
                    f"np.random.{tail}() without a seed — pass an explicit "
                    "seed so runs are reproducible"))
        elif tail != "seed":
            out.append(_finding(
                "HFEL001", path, lines, node,
                f"np.random.{tail} uses numpy's module-level RNG state — "
                "use a seeded np.random.default_rng(seed) generator"))
    return out


def rule_hfel002(tree: ast.AST, path: str, lines: list[str]) -> list[Finding]:
    """time.time() — non-monotonic under NTP adjustment; interval timing
    must use time.perf_counter() (pragma genuine wall-clock uses)."""
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and dotted(node.func) == "time.time":
            out.append(_finding(
                "HFEL002", path, lines, node,
                "time.time() is non-monotonic (NTP) — use "
                "time.perf_counter() for intervals, or pragma a genuine "
                "wall-clock use"))
    return out


# -- HFEL003: host syncs ------------------------------------------------------

def _expr_tainted(expr: ast.expr, taint: set[str]) -> bool:
    """Whether ``expr`` (by the module's taint) holds a tensor."""
    name = dotted(expr)
    if name is not None and name in taint:
        return True
    if isinstance(expr, ast.Name):
        return False
    if isinstance(expr, ast.Attribute):
        if expr.attr in DETAINT_ATTRS:
            return False
        return _expr_tainted(expr.value, taint)
    if isinstance(expr, ast.Call):
        fname = dotted(expr.func)
        if fname in DETAINT_CALLS or _tail(fname) in DETAINT_CALLS:
            return False
        if fname is not None and fname.startswith("torch."):
            return True
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in HOST_SYNC_METHODS | {"numpy"}:
            return False                         # host data, read once
        if isinstance(expr.func, ast.Attribute):     # a method call
            return _expr_tainted(expr.func.value, taint)
        return any(_expr_tainted(a, taint) for a in expr.args)
    if isinstance(expr, ast.Subscript):
        return _expr_tainted(expr.value, taint)
    if isinstance(expr, ast.IfExp):        # the value is a branch's
        return _expr_tainted(expr.body, taint) or \
            _expr_tainted(expr.orelse, taint)
    if isinstance(expr, (ast.Constant, ast.Lambda, ast.JoinedStr)):
        return False
    return any(_expr_tainted(c, taint) for c in ast.iter_child_nodes(expr)
               if isinstance(c, ast.expr))


def _targets(target: ast.expr) -> list[str]:
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for el in target.elts for n in _targets(el)]
    if isinstance(target, ast.Starred):
        return _targets(target.value)
    name = dotted(target)
    return [name] if name is not None else []


def _taint(root: ast.AST, taint: set[str]) -> set[str]:
    """``taint`` grown by the assignments under ``root`` (two passes
    approximate the fixpoint)."""
    taint = set(taint)
    for _ in range(2):
        for node in ast.walk(root):
            if isinstance(node, ast.Assign):
                if _expr_tainted(node.value, taint):
                    for t in node.targets:
                        taint.update(_targets(t))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if node.value is not None and \
                        _expr_tainted(node.value, taint):
                    taint.update(_targets(node.target))
            elif isinstance(node, (ast.For, ast.comprehension)):
                if _expr_tainted(node.iter, taint):
                    taint.update(_targets(node.target))
    return taint


def _scopes(tree: ast.AST) -> list[tuple[ast.AST, set[str]]]:
    """(outermost function or the module's top-level code, its taint): a
    function's names (its nested functions' included) and the module's
    ``self.`` attributes that hold tensors."""
    attrs = {n for n in _taint(tree, set()) if n.startswith("self.")}
    functions = [n for n in ast.iter_child_nodes(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for cls in ast.iter_child_nodes(tree):
        if isinstance(cls, ast.ClassDef):
            functions += [n for n in cls.body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    top = ast.Module(body=[n for n in tree.body if not isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))],
        type_ignores=[])
    return [(fn, _taint(fn, attrs)) for fn in functions] + \
        [(top, _taint(top, attrs))]


def rule_hfel003(tree: ast.AST, path: str, lines: list[str]) -> list[Finding]:
    """Host syncs in the core and kernel code."""
    if not path.startswith(HOST_SYNC_DIRS) and \
            not any(f"/{d}" in path for d in HOST_SYNC_DIRS):
        return []
    out: list[Finding] = []
    for root, taint in _scopes(tree):
        out += _host_syncs(root, taint, path, lines)
    return out


def _host_syncs(root: ast.AST, taint: set[str], path: str,
                lines: list[str]) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "cpu" and not node.args:
            out.append(_finding(
                "HFEL003", path, lines, node,
                ".cpu() copies to the host and waits for the card"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_SYNC_METHODS and \
                _expr_tainted(node.func.value, taint):
            out.append(_finding(
                "HFEL003", path, lines, node,
                f".{node.func.attr}() of a tensor waits for the card"))
        elif isinstance(node.func, ast.Name) and \
                node.func.id in HOST_SYNC_BUILTINS and \
                len(node.args) == 1 and _expr_tainted(node.args[0], taint):
            out.append(_finding(
                "HFEL003", path, lines, node,
                f"{node.func.id}() of a tensor reads it on the host and "
                "waits for the card"))
        elif name in HOST_SYNC_DOTTED and node.args and \
                _expr_tainted(node.args[0], taint):
            out.append(_finding(
                "HFEL003", path, lines, node,
                f"{name}() of a tensor copies it to the host"))
    return out


# -- HFEL005 ------------------------------------------------------------------

def rule_hfel005(tree: ast.AST, path: str, lines: list[str]) -> list[Finding]:
    """float64 creep into the float32 kernel contract."""
    if KERNEL_DIR not in path:
        return []
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                node.attr in ("float64", "double"):
            out.append(_finding(
                "HFEL005", path, lines, node,
                f"{node.attr} in kernel code — the kernels are float32 by "
                "parity contract"))
        elif isinstance(node, ast.Constant) and \
                node.value in ("float64", "f8", ">f8", "<f8"):
            out.append(_finding(
                "HFEL005", path, lines, node,
                f"dtype literal {node.value!r} in kernel code — the "
                "kernels are float32 by parity contract"))
    return out


def run_rules(tree: ast.AST, path: str, lines: list[str]) -> list[Finding]:
    out: list[Finding] = []
    out += rule_hfel001(tree, path, lines)
    out += rule_hfel002(tree, path, lines)
    out += rule_hfel003(tree, path, lines)
    out += rule_hfel005(tree, path, lines)
    return out

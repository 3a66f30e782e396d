"""The port mirrors the JAX package: every module of ``src/repro`` has its
counterpart in ``src/repro_torch`` (same path), and every public
top-level name a JAX module defines (functions, classes, assignments) is
defined or imported by its counterpart. By AST alone: nothing is
imported.

The exceptions, each written here with its reason:

* modules only the port has: ``convert`` (checkpoints between the two
  packages), ``core/prng`` (JAX's threefry stream, bit for bit),
  ``kernels/build`` (the nvcc build), ``launch/ranks`` (spawning ranks),
  ``utils/collectives`` (the mesh's collectives), and the package's own
  ``__init__`` (the JAX package is a namespace package);
* ``models/attention.py::blocked_attention``: dropped on purpose, every
  attention over a whole sequence runs the flash kernel;
* the names ``src/repro_torch/analysis/rules.py`` itself declares
  JAX-only (``JAX_ONLY_NAMES``): the jit-scope machinery and the rules
  HFEL004/006/007, which have no eager counterpart.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

PORT_ONLY = {"__init__", "convert", "core/prng", "kernels/build",
             "launch/ranks", "utils/collectives"}
DROPPED = {("models/attention", "blocked_attention")}


def modules(root: Path) -> dict:
    return {str(p.relative_to(root).with_suffix("")): p
            for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts}


def defined(tree: ast.Module) -> set:
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def bound(tree: ast.Module) -> set:
    """Names a module defines or imports at its top level."""
    out = defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def jax_only_rules() -> set:
    tree = ast.parse((PORT / "analysis" / "rules.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "JAX_ONLY_NAMES"
                for t in node.targets):
            return {c.value for c in ast.walk(node.value)
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)}
    raise AssertionError("rules.py declares no JAX_ONLY_NAMES")


def test_every_module_has_its_counterpart():
    jax, port = modules(JAX), modules(PORT)
    assert sorted(set(jax) - set(port)) == []
    assert sorted(set(port) - set(jax)) == sorted(PORT_ONLY)


def test_every_public_name_has_its_counterpart():
    exempt = set(DROPPED)
    exempt |= {("analysis/rules", n) for n in jax_only_rules()}
    missing = []
    for mod, path in modules(JAX).items():
        want = defined(ast.parse(path.read_text()))
        have = bound(ast.parse((PORT / f"{mod}.py").read_text()))
        missing += [(mod, n) for n in sorted(want - have)
                    if (mod, n) not in exempt]
    assert missing == []


def test_exceptions_are_still_needed():
    """Each written exception names something the port really lacks."""
    port = modules(PORT)
    for mod, name in DROPPED:
        assert name not in bound(ast.parse(port[mod].read_text()))
    rules = bound(ast.parse(port["analysis/rules"].read_text()))
    assert not (jax_only_rules() & rules)
    jax_rules = defined(ast.parse(
        (JAX / "analysis" / "rules.py").read_text()))
    assert jax_only_rules() <= jax_rules

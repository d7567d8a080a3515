"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``tpumix_torch`` is the program, ``tpumix`` the JAX
package."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpumix"}


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: imported_top_levels(p) & FORBIDDEN for p in sources()}
    assert {p: n for p, n in found.items() if n} == {}


def test_the_port_passes_the_whole_name_comparison():
    assert "tpumix_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    found = {p: imported_top_levels(p) & {"tpumix_torch", "tpumix"}
             for p in sources("reference")}
    assert {p: n for p, n in found.items() if n} == {}


def test_only_the_program_module_imports_the_program():
    """(The tests break the program's path on purpose, so they may.)"""
    users = {os.path.relpath(p, BENCH) for p in sources()
             if "tpumix_torch" in imported_top_levels(p)
             and not os.path.relpath(p, BENCH).startswith("tests")}
    assert users <= {os.path.join("core", "program.py"), os.path.join("core", "harness.py")}


def test_the_scan_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import tpumix.ops\nfrom jax import numpy\nimport tpumix_torch\n")
    assert imported_top_levels(str(bad)) & FORBIDDEN == {"tpumix", "jax"}

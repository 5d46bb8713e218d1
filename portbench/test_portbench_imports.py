"""The harness and its reference load neither JAX nor the JAX package:
a CPU run of a tiny cell in a fresh process, then a look at what the
process has loaded, by whole top-level names (``repro_torch`` begins
with ``repro``). The reference imports nothing of the port either."""
import ast
import subprocess
import sys
import textwrap

from portbench.spec import HERE

ROOT = HERE.parent


def test_a_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys, pathlib, tempfile
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        from portbench.conftest import make_bench
        from portbench.harness import run_cell, forbidden_modules
        root = pathlib.Path(tempfile.mkdtemp())
        bench = make_bench(root)
        result, _ = run_cell(root, "tiny-moe.tiny", 5, 2.0, device="cpu",
                             bench_dir=bench, log=lambda *a: None)
        assert result["attempted"] > 0
        print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
        print("FORBIDDEN", forbidden_modules())
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "FORBIDDEN")))
    assert lines["FORBIDDEN"] == "[]"
    loaded = eval(lines["LOADED"])  # noqa: S307 - our own print
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_no_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "contextlib", "torch"}, path
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path

"""Nothing under port_bench imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""
import ast
from pathlib import Path

from harness import checks

BENCH = Path(__file__).resolve().parents[1]
PORT = "real_time_ray_tracing_engine_tpu_torch"
JAX_PKG = "real_time_ray_tracing_engine_tpu"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_banned_names_are_whole_top_level_names():
    loaded = ["jax.numpy", "jaxlib", "flax.linen", JAX_PKG,
              f"{JAX_PKG}.ops", PORT, f"{PORT}.ops.integrator", "jaxtyping",
              "torch", "flaxen"]
    assert checks.banned_modules(loaded) == sorted(
        ["jax.numpy", "jaxlib", "flax.linen", JAX_PKG, f"{JAX_PKG}.ops"])


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = set(checks.BANNED) & imported_tops(f)
        assert not bad, f"{f} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert len(files) >= 7
    for f in files:
        tops = imported_tops(f)
        assert not {t for t in tops if t.startswith(JAX_PKG)}, f
        assert tops <= {"torch", "numpy", "math", "json", "dataclasses",
                        "typing", "__future__"}, (f, tops)

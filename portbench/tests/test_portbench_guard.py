"""The whole-name import guard and the benchmark's own imports."""
import ast
import os

import pytest

from portbench.run import forbidden_loaded

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("modules,found", [
    (["pisces_tpu_torch", "pisces_tpu_torch.apps.pisces"], []),
    (["pisces_tpu"], ["pisces_tpu"]),
    (["pisces_tpu.ops.stats"], ["pisces_tpu"]),
    (["jax"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_like", "pisces_tpu_extra", "numpy"], []),
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert forbidden_loaded(modules) == found


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    """The reference and the read layouts (the tests' own among them)
    import nothing of the program or JAX."""
    for sub in ("reference", "layouts", os.path.join("tests", "layouts")):
        d = os.path.join(HERE, sub)
        files = [n for n in os.listdir(d) if n.endswith(".py")]
        assert files, sub
        for name in files:
            names = _imports(os.path.join(d, name))
            assert not names & {"pisces_tpu_torch", "pisces_tpu", "jax",
                                "jaxlib", "flax"}, (sub, name)
    for name in ("gen.py", "roofline.py", "control.py"):
        assert "pisces_tpu_torch" not in _imports(os.path.join(HERE, name))


def test_no_benchmark_file_imports_jax():
    for dirpath, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                names = _imports(os.path.join(dirpath, name))
                assert not names & {"pisces_tpu", "jax", "jaxlib", "flax"}


def test_read_layouts_load_without_torch_or_scipy(small_root):
    """The generator's child process loads the layout: no layout imports
    torch or scipy, whose import would run beside the measured process's
    set-up."""
    import subprocess
    import sys

    from portbench.tests.conftest import add_paired_layout
    add_paired_layout(small_root)
    names = sorted(n[:-3] for n in os.listdir(os.path.join(
        small_root, "portbench", "layouts")) if n.endswith(".py"))
    assert {"single_end", "paired_xd"} <= set(names)
    code = (
        "import sys\n"
        "from portbench import gen\n"
        "for name in sys.argv[2:]:\n"
        "    gen.load_layout({'reads': {'layout': name}}, sys.argv[1])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'torch', 'scipy'}))\n")
    out = subprocess.run([sys.executable, "-c", code, small_root] + names,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(HERE), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

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
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            names = _imports(os.path.join(ref, name))
            assert not names & {"pisces_tpu_torch", "pisces_tpu", "jax",
                                "jaxlib", "flax"}, name
    for name in ("gen.py", "roofline.py", "control.py"):
        assert "pisces_tpu_torch" not in _imports(os.path.join(HERE, name))


def test_no_benchmark_file_imports_jax():
    for dirpath, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                names = _imports(os.path.join(dirpath, name))
                assert not names & {"pisces_tpu", "jax", "jaxlib", "flax"}

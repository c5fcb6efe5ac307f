"""The port stands alone: no module of inverse_path_tracer_torch, and not
chip_smoke.py, imports jax or anything of inverse_path_tracer_tpu."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "inverse_path_tracer_torch")
FORBIDDEN = ("jax", "jaxlib", "inverse_path_tracer_tpu")


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_tpu_package_import(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, inverse_path_tracer_torch, inverse_path_tracer_torch.ops.kernels.build, "
            "inverse_path_tracer_torch.render.diff, inverse_path_tracer_torch.models.recover, "
            "inverse_path_tracer_torch.utils.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)

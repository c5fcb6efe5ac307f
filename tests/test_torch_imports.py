"""The port stands alone: no module of inverse_path_tracer_torch, not
chip_smoke.py and no script of tools/ imports jax, anything of
inverse_path_tracer_tpu or PIL (the card's machine has neither JAX nor
PIL)."""

import ast
import os
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "inverse_path_tracer_torch")
FORBIDDEN = ("jax", "jaxlib", "inverse_path_tracer_tpu", "PIL")


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PORT, os.path.join(REPO, "tools")):
        for root, _, names in os.walk(top):
            files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_tools_are_checked():
    assert os.path.join(REPO, "tools", "time_extract.py") in port_files()


def test_new_modules_are_checked():
    files = port_files()
    for rel in ("ops/bvh.py", "utils/native.py", "parallel/shard.py", "parallel/multihost.py",
                "experiments/common.py", "experiments/gate.py", "experiments/recover100.py",
                "experiments/full_pipeline.py", "ops/kernels/reorder_kernel.py"):
        assert os.path.join(PORT, rel) in files, rel


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
            "inverse_path_tracer_torch.utils.checkpoint, inverse_path_tracer_torch.render.inverse, "
            "inverse_path_tracer_torch.ops.kernels.inverse_kernel, "
            "inverse_path_tracer_torch.models.gcn, inverse_path_tracer_torch.data.pipeline, "
            "inverse_path_tracer_torch.utils.metrics, inverse_path_tracer_torch.assets, "
            "inverse_path_tracer_torch.ops.kernels.clusters, "
            "inverse_path_tracer_torch.ops.kernels.staged_kernel, "
            "inverse_path_tracer_torch.ops.kernels.reorder_kernel, inverse_path_tracer_torch.cli, "
            "inverse_path_tracer_torch.utils.plyviz, inverse_path_tracer_torch.utils.profiling, "
            "inverse_path_tracer_torch.ops.bvh, inverse_path_tracer_torch.utils.native, "
            "inverse_path_tracer_torch.parallel.shard, inverse_path_tracer_torch.parallel.multihost, "
            "inverse_path_tracer_torch.experiments.gate, "
            "inverse_path_tracer_torch.experiments.recover100, "
            "inverse_path_tracer_torch.experiments.full_pipeline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)

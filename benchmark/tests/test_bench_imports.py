"""A cell's run and the reference load no JAX and nothing of the JAX
package; the reference loads nothing of the program either.  Module names
are compared by their whole top-level name (the part before the first
dot): the program's name begins with the JAX package's."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT, SEED, TINY

JAX = {"jax", "jaxlib", "flax", "inverse_path_tracer_tpu"}
PROGRAM = "inverse_path_tracer_torch"


def _top_levels(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = ("from benchmark import run\n"
            f"rc = run.main(['--workload', 'cornell30.recover16', '--seed', '{SEED}', "
            f"'--seconds', '0.2'], device='cpu', overrides={dict(TINY)!r}, "
            f"gen_dir={str(tmp_path)!r})\nassert rc == 0\n")
    names = _top_levels(code)
    assert PROGRAM in names and not names & JAX


def test_the_reference_loads_neither_jax_nor_the_program():
    names = _top_levels("import benchmark.reference.tracer, benchmark.reference.scene")
    assert not names & (JAX | {PROGRAM})


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & JAX, path
            if os.sep + "reference" + os.sep in path:
                assert PROGRAM not in tops, path

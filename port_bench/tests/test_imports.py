"""No process of a run holds a module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``horovod_tpu`` (``horovod_tpu_torch`` is not
``horovod_tpu``), and no file of the benchmark imports one."""

import ast
import json
import os
import subprocess
import sys

from port_bench import card

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

RUN = r"""
import json, sys
from port_bench import card
from port_bench.tests import tiny
result, notes, forbidden = tiny.run("gpt", seconds=0.5)
top = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"top": top, "ranks": forbidden,
                  "here": card.forbidden_modules()}))
"""


def test_whole_top_level_names():
    assert card.forbidden_modules(["horovod_tpu_torch.optim", "jaxtyping",
                                   "flaxen"]) == []
    assert card.forbidden_modules(["jax.numpy", "horovod_tpu.ops"]) == \
        ["horovod_tpu", "jax"]


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ranks"] == [] and got["here"] == []
    assert not set(got["top"]) & set(card.FORBIDDEN)
    assert "horovod_tpu_torch" in got["top"]


def test_no_benchmark_file_imports_jax():
    for dirpath, _, files in os.walk(HERE):
        for name in files:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, name)).read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in card.FORBIDDEN, (name, m)

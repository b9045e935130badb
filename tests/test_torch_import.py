"""The port imports torch and never jax / flax, and it (with chip_smoke.py)
imports on a machine that has neither yaml, PIL nor `datasets`."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, importlib.abc, json, pkgutil, sys
BLOCK = set(sys.argv[1].split(",")) if sys.argv[1] else set()
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import markushgrapher_torch
mods = [m.name for m in pkgutil.walk_packages(markushgrapher_torch.__path__,
                                              "markushgrapher_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(json.dumps({"modules": mods, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))}))
"""


def _run(block: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, block],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("block", ["", "jax,jaxlib,flax,yaml,PIL,datasets"])
def test_port_imports_no_jax(block):
    out = _run(block)
    assert out["loaded"] == []
    for name in ("markushgrapher_torch.models.markushgrapher",
                 "markushgrapher_torch.decode.generate",
                 "markushgrapher_torch.eval_main",
                 "markushgrapher_torch.ops.bias_build",
                 "markushgrapher_torch.ops.flash_attention",
                 "markushgrapher_torch.ops.mxu_decode"):
        assert name in out["modules"]

"""The port imports torch and never jax / flax nor the JAX package
`markushgrapher_tpu`, and it (with chip_smoke.py) imports on a machine that
has neither yaml, PIL nor `datasets`."""

import ast
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
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "markushgrapher_tpu"))}))
"""


def _run(block: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, block],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("block", [
    pytest.param("markushgrapher_tpu", id=""),
    pytest.param("jax,jaxlib,flax,markushgrapher_tpu,yaml,PIL,datasets",
                 id="jax,jaxlib,flax,yaml,PIL,datasets")])
def test_port_imports_no_jax(block):
    out = _run(block)
    assert out["loaded"] == []
    for name in ("markushgrapher_torch.models.markushgrapher",
                 "markushgrapher_torch.decode.generate",
                 "markushgrapher_torch.eval_main",
                 "markushgrapher_torch.ops.bias_build",
                 "markushgrapher_torch.ops.flash_attention",
                 "markushgrapher_torch.ops.flash_relbias",
                 "markushgrapher_torch.data.bucketing",
                 "markushgrapher_torch.ops.mxu_decode",
                 "markushgrapher_torch.data.markush_tokenizer",
                 "markushgrapher_torch.chem.evaluation",
                 "markushgrapher_torch.data.device_pixels",
                 "markushgrapher_torch.ocr.grammar",
                 "markushgrapher_torch.ocr.vlm",
                 "markushgrapher_torch.ocr.engine",
                 "markushgrapher_torch.ops.megastep",
                 "markushgrapher_torch.ops.tensor_core",
                 "markushgrapher_torch.ops.preprocess",
                 "markushgrapher_torch.train.trainer",
                 "markushgrapher_torch.train.optim",
                 "markushgrapher_torch.train.checkpoint",
                 "markushgrapher_torch.train.losses",
                 "markushgrapher_torch.train.tf_metrics",
                 "markushgrapher_torch.train_main",
                 "markushgrapher_torch.data.augment",
                 "markushgrapher_torch.utils.tracker",
                 "markushgrapher_torch.scripts.apply_ocr",
                 "markushgrapher_torch.scripts.run_inference",
                 "markushgrapher_torch.scripts.image_dir_to_hf_dataset",
                 "markushgrapher_torch.scripts.prepare_hf_dataset"):
        assert name in out["modules"]


def test_build_compiles_every_kernel_source():
    """Every CUDA source of the port is in the build list, and every kernel
    of the build has a launch counter."""
    from markushgrapher_torch.ops import _build

    sources = sorted(os.listdir(os.path.join(REPO, "markushgrapher_torch",
                                             "csrc")))
    assert sorted(_build.SOURCES) == [s for s in sources if s.endswith(".cu")]
    # flash_bias_bwd.cu holds two kernels, each with its counter;
    # decode_int4.cu's entry also serves the lattice, counted under the
    # name of the function it serves
    counters = {"flash_bias_bwd": ["flash_bias_dkv", "flash_bias_dq"],
                "decode_int4": ["decode_int4", "lattice_self_int4"]}
    kernels = [n for s in _build.SOURCES
               for n in counters.get(s[:-3], [s[:-3]])]
    assert sorted(_build.LAUNCHES) == sorted(kernels)


def _imported_roots(path):
    """Top-level package of every import statement in a source file,
    function-level (lazy) imports included."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "markushgrapher_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = sorted((os.path.relpath(f, REPO), root) for f in files
                 for root in _imported_roots(f)
                 if root in ("markushgrapher_tpu", "jax", "jaxlib", "flax"))
    assert bad == []

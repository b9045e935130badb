"""Weight bridge between the JAX package's flax parameter tree and the
port's `state_dict`.

Names: the flax path joined with "." (`encoder.layer_0.attn.q.weight`, the
Swin's `molscribe_encoder.stage0_block1.attn.qkv.weight`, `merge0`, the
ChemicalOCR tree's `vision.block_0.qkv.weight`, `layer_0.o.weight`, ...);
flax `kernel` / LayerNorm `scale` become `weight`.

Layouts: flax Dense / DenseGeneral kernels are [in..., out...] (attention
q/k/v [D, H, Dk], o [H, Dk, D], Swin qkv [dim, 3, H, hd] and proj
[H, hd, dim], lm_head [D, V]; OCR vision qkv [D, 3, H, hd] and proj
[H, hd, D], OCR LM q/k/v [D, H or G, hd] and o [H, hd, D]); torch Linear
weights are [out, in] with the feature axes flattened. Biases flatten;
tables, embeddings (`embed` [V, D], `pos_embed`) and RMSNorm weights pass
through. Both directions copy values bit for bit; `params_to_jax` takes the
model's config (a MarkushGrapherConfig, or an OCRConfig for the OCR tree)
for the reverse shapes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from markushgrapher_torch.config import MarkushGrapherConfig

# kernels whose first TWO axes are contracted ([H, Dk, out]): MarkushGrapher
# and Swin attention outputs, the OCR vision blocks' proj and LM layers' o
_TWO_AXIS_IN = re.compile(r"(^|\.)((attn|self_attn|cross_attn)\.(o|proj)"
                          r"|block_\d+\.proj|layer_\d+\.o)$")
_SWIN_STAGE = re.compile(r"stage(\d+)_block")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves; with or without the {"params": ...}
    wrapper) -> torch state_dict of float32 tensors."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        module, name = ".".join(path[:-1]), path[-1]
        if name == "kernel":
            n_in = 2 if _TWO_AXIS_IN.search(module) else 1
            fan_in = int(np.prod(arr.shape[:n_in]))
            arr = arr.reshape(fan_in, -1).T
            name = "weight"
        elif name == "bias" and arr.ndim > 1:
            arr = arr.reshape(-1)
        elif name == "scale":
            name = "weight"
        key = f"{module}.{name}" if module else name
        out[key] = torch.tensor(arr)
    return out


_LINEAR_LEAVES = {"q", "k", "v", "o", "wi", "wi_0", "wi_1", "wo", "proj",
                  "qkv", "fc1", "fc2", "mlp_fc1", "mlp_fc2", "reduction",
                  "lm_head", "patch_embed", "gate", "up", "down"}
_LAYERNORM_LEAVES = {"ln1", "ln2", "ln", "patch_ln", "post_ln"}


def _ocr_kernel_shape(module: str, weight: torch.Tensor,
                      cfg) -> Tuple[int, ...]:
    """The flax kernel shape of a torch Linear weight of the OCR tree."""
    out_f, in_f = weight.shape
    leaf = module.rsplit(".", 1)[-1]
    vis, txt = cfg.vision, cfg.text
    if module.startswith("vision."):
        hd = vis.d_model // vis.num_heads
        if leaf == "qkv":
            return (in_f, 3, vis.num_heads, hd)
        if leaf == "proj":
            return (vis.num_heads, hd, out_f)
        return (in_f, out_f)
    d = txt.d_model // txt.num_heads
    if leaf in ("q", "k", "v"):
        return (in_f, out_f // d, d)
    if leaf == "o":
        return (txt.num_heads, d, out_f)
    return (in_f, out_f)


def _kernel_shape(module: str, weight: torch.Tensor,
                  cfg: MarkushGrapherConfig) -> Tuple[int, ...]:
    """The flax kernel shape of a torch Linear weight [out, in]."""
    out_f, in_f = weight.shape
    leaf = module.rsplit(".", 1)[-1]
    stage = _SWIN_STAGE.search(module)
    if stage and leaf in ("qkv", "proj"):       # Swin window attention
        heads = cfg.swin.num_heads[int(stage.group(1))]
        if leaf == "qkv":
            return (in_f, 3, heads, out_f // (3 * heads))
        return (heads, in_f // heads, out_f)
    if _TWO_AXIS_IN.search(module):
        return (cfg.vtl.num_heads, cfg.vtl.d_kv, out_f)
    if leaf in ("q", "k", "v"):
        return (in_f, cfg.vtl.num_heads, cfg.vtl.d_kv)
    return (in_f, out_f)


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg) -> Dict:
    """Inverse of params_from_jax: state_dict -> {"params": nested numpy
    tree} in the flax layouts of `cfg`'s model (MarkushGrapherConfig or
    OCRConfig)."""
    ocr = hasattr(cfg, "vision") and hasattr(cfg, "text")
    root: Dict = {}
    for key, tensor in state_dict.items():
        arr = tensor.detach().to(torch.float32).cpu().numpy()
        module, _, name = key.rpartition(".")
        leaf = module.rsplit(".", 1)[-1]
        if name == "weight" and leaf in _LINEAR_LEAVES:
            shape = (_ocr_kernel_shape if ocr else _kernel_shape)(
                module, tensor, cfg)
            arr = arr.T.reshape(shape)
            name = "kernel"
        elif name == "bias" and leaf == "qkv":
            heads = (cfg.vision.num_heads if ocr else cfg.swin.num_heads[int(
                _SWIN_STAGE.search(module).group(1))])
            arr = arr.reshape(3, heads, -1)
        elif name == "weight" and (leaf in _LAYERNORM_LEAVES or (
                leaf == "final_ln" and module.startswith("molscribe"))):
            name = "scale"
        node = root
        for part in (module.split(".") if module else []):
            node = node.setdefault(part, {})
        node[name] = arr
    return {"params": root}

"""Quantised decode projections: the CUDA kernel `csrc/wq_linear.cu`, its
wrapper and plain version, and the weight and activation quantisers.

The JAX package quantises every decode-step weight per output channel
(`markushgrapher_tpu/models/t5.py` `_quantize_w`) and reads it in one of
three forms, all outside any Pallas kernel (XLA fuses the convert into the
dot on the TPU):
  - int8 weights: codes in [-127, 127], the dot in the compute dtype over the
    dequantised codes, then the float32 per-channel scale (`_deq`);
  - int4 weights (`weight_bits=4`): codes in [-7, 7], the same path;
  - W8A8 (`act_quant=True`, int8 weights only): each activation row is
    quantised to int8 on the fly (`_act_q8`: scale amax / 127 + 1e-12,
    round half to even), an s8 x s8 dot sums in int32, and the result is
    scaled by the activation scale, then by the weight scale (`_dot8`).

Weights are torch Linear weights [out, in]. At int4 the codes are packed two
per byte along the input axis: byte j of a row holds code 2j in its low
nibble and code 2j + 1 in its high nibble, each a two's-complement nibble
(`pack_w4` / `unpack_w4`). That is the pair a dequantise into a bf16x2
register wants; the KV rings' `mxu_decode.pack_int4` splits columns
instead, a layout of the attention kernels.

`wq_linear` sends CUDA tensors to the kernel (bf16 activations; a build or
launch failure raises) and CPU tensors to `wq_linear_plain`. The plain
version rounds where the kernel does: the weight-only forms sum in
float32 and round the product to the activations' dtype before the scale,
as `_deq`'s dot does; W8A8 sums the integer products exactly (in float64,
which holds them: 127 * 127 * K < 2^53) and scales in float32 in JAX's
order. So W8A8 is bit for bit the kernel's, and the weight-only forms
differ from it only in the order of the float32 sum.

The quantisers divide by a tensor, never by a Python number: on a CUDA
tensor PyTorch turns division by a Python scalar into a multiplication by
its reciprocal, which is not the IEEE quotient the kernel and the JAX
package (outside jit) compute.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from markushgrapher_torch.ops import _build

# modes of the kernel's C entry
_MODES = {(8, False): 0, (4, False): 1, (8, True): 2}


def _lim(bits: int, like: torch.Tensor) -> torch.Tensor:
    if bits not in (4, 8):
        raise ValueError(f"quantised weights take 4 or 8 bits, got {bits}")
    return torch.tensor(7.0 if bits == 4 else 127.0, dtype=torch.float32,
                        device=like.device)


def pack_w4(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes [N, K] (int8 values in [-8, 7], K even) -> uint8 [N, K/2]:
    byte j = code 2j in the low nibble, code 2j + 1 in the high nibble."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_w4: odd input width {codes.shape[-1]}")
    c = codes.to(torch.int16) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [N, K/2] of `pack_w4` -> int8 codes [N, K]."""
    b = packed.to(torch.int16)
    nib = torch.stack([b & 0xF, b >> 4], dim=-1).flatten(-2)
    return ((nib ^ 8) - 8).to(torch.int8)


def quantize_w(w: torch.Tensor, bits: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantisation of a Linear weight [out,
    in] (JAX's `_quantize_w`): scale max|w| / lim + 1e-12 (lim 127, or 7 at
    bits=4), codes round(w / scale) (half to even) clipped to [-lim, lim].
    Returns (int8 codes [out, in], or at bits=4 `pack_w4`'s uint8 [out,
    in/2]; float32 scales [out])."""
    lim = _lim(bits, w)
    wf = w.to(torch.float32)
    s = wf.abs().amax(dim=1, keepdim=True) / lim + 1e-12
    q = torch.round(wf / s).clamp(-lim, lim).to(torch.int8)
    return (pack_w4(q) if bits == 4 else q), s[:, 0]


def quantize_act8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of x [..., K] over its last axis (JAX's
    `_act_q8`): float32 scale s = max|x| / 127 + 1e-12, codes round(x / s)
    (half to even). Returns (int8 [..., K], float32 s [...])."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1, keepdim=True) / _lim(8, x) + 1e-12
    return torch.round(xf / s).to(torch.int8), s[..., 0]


def _check(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
           bits: int, act: bool) -> None:
    if (bits, act) not in _MODES:
        raise ValueError(f"wq_linear: bits={bits}, act={act}; W8A8 needs "
                         "int8 weights")
    width = x.shape[-1] // 2 if bits == 4 else x.shape[-1]
    if w_q.dim() != 2 or w_q.shape[1] != width or w_s.shape != (
            w_q.shape[0],):
        raise ValueError(f"wq_linear: weight {tuple(w_q.shape)} / scales "
                         f"{tuple(w_s.shape)} do not fit activations "
                         f"{tuple(x.shape)} at {bits} bits")


def wq_linear_plain(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    bits: int = 8, act: bool = False) -> torch.Tensor:
    """Plain version of `wq_linear`, on any device: x [..., K] @ dequant(
    w_q).T scaled per output channel, in x's dtype (module docstring)."""
    _check(x, w_q, w_s, bits, act)
    if act:
        xq, sx = quantize_act8(x)
        acc = F.linear(xq.to(torch.float64), w_q.to(torch.float64))
        return (acc.to(torch.float32) * sx[..., None] * w_s).to(x.dtype)
    # the products of x and the codes are exact in float32, and the sum is
    # float32 on any device and dtype (cuBLAS may otherwise reduce bf16
    # partial sums in bf16): then rounded to x's dtype, as the dot in x's
    # dtype rounds
    ct = torch.promote_types(x.dtype, torch.float32)
    codes = unpack_w4(w_q) if bits == 4 else w_q
    y = F.linear(x.to(ct), codes.to(ct)).to(x.dtype)
    return (y.to(torch.float32) * w_s).to(x.dtype)


def wq_linear(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
              bits: int = 8, act: bool = False) -> torch.Tensor:
    """x [..., K] against a quantised weight (`quantize_w`'s codes w_q and
    float32 scales w_s [N]) -> [..., N] in x's dtype: int8 or int4
    weights, or with act W8A8 (int8 weights, x quantised per row). A CPU
    tensor takes the plain version; a CUDA tensor takes the kernel, which
    wants bf16 x, K a multiple of 64 and contiguous weights. Under act its
    C entry launches the row quantiser, then the product: one call,
    counted once."""
    if x.device.type == "cpu":
        return wq_linear_plain(x, w_q, w_s, bits, act)
    _check(x, w_q, w_s, bits, act)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"wq_linear: the kernel takes bf16 activations, got "
                         f"{x.dtype}")
    k = x.shape[-1]
    if k % 64:
        raise ValueError(f"wq_linear: input width {k} is not a multiple of "
                         "64")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    rows, n = x2.shape[0], w_q.shape[0]
    w_s = w_s.to(torch.float32)
    out = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
    if act:
        xq = torch.empty((rows, k), dtype=torch.int8, device=x.device)
        sx = torch.empty((rows,), dtype=torch.float32, device=x.device)
    else:
        xq = sx = out                          # not read
    _build.require_cuda("wq_linear", x2, w_q, w_s, out)
    if rows == 0 or n == 0:
        return out.reshape(*lead, n)
    rc = _build.lib().mg_wq_linear(
        x2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), rows, k, n,
        _MODES[(bits, act)], xq.data_ptr(), sx.data_ptr(), out.data_ptr(),
        _build.stream(out))
    _build.check(rc, "wq_linear")
    _build.LAUNCHES["wq_linear"] += 1
    return out.reshape(*lead, n)

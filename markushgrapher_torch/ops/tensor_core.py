"""How the plain versions model a Hopper tensor-core sum (mma.sync with a
float32 accumulator), in float64 on any device.

A step adds 16 products into the accumulator and rounds the sum toward
zero. Where every term of a step is exact in a float32 sum (the megastep's
bf16 x int8 GEMVs and ring scores, `ops.megastep`), the step is the exact
sum rounded toward zero (`tc_steps`). Where the terms span more than a
float32 mantissa (the decode kernels' scores at head dim 32 / 64,
`ops.mxu_decode._scores`), the card aligns them to the largest first: each
keeps TC_ALIGN bits below the largest term's float32 ulp (`tc_step`;
`decode_bench.py --tc-model` holds this model to the card's sums).
"""

from __future__ import annotations

import torch

# the bits below the float32 ulp of a tensor-core step's largest term that
# its other terms keep (`tc_step`)
TC_ALIGN = 2


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero, back in float64."""
    f = x.to(torch.float32)
    over = f.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)),
                       f).to(torch.float64)


def tc_steps(acc: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Add exact step sums [R, ...] into a float32 accumulator, each
    rounded toward zero, as tensor-core steps do."""
    for r in range(sums.shape[0]):
        acc = rz32(acc + sums[r])
    return acc


def tc_step(terms: torch.Tensor) -> torch.Tensor:
    """The float32 sum one tensor-core step (mma.sync m16n8k16, float32
    accumulator) takes of its exact terms [..., 17], the accumulator and 16
    products, in float64: each term cut toward zero to TC_ALIGN bits below
    the float32 ulp of the largest, the sum rounded toward zero."""
    _, e = torch.frexp(terms.abs().amax(dim=-1, keepdim=True))
    quantum = torch.exp2((e - 24 - TC_ALIGN).to(torch.float64))
    return rz32((torch.trunc(terms / quantum) * quantum).sum(dim=-1))

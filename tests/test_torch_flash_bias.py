"""The float-bias flash attention of the port (`ops.flash_attention`) on the
CPU, where every step takes its kernel's plain version:

- `plain_bias` against the JAX package's `flash_attention_bias` Pallas
  kernel run in interpret mode (float32, a masked key tail, a batch-1 bias);
- `FlashAttentionBias` (forward, the dK/dV and dQ/d(bias) plain versions)
  against `jax.vjp` of the JAX dense attention with bias (t5.py:401-407, the
  stock trainable Pallas flash has no interpret mode): out, dq, dk, dv and
  dbias, float32, 1e-5 of each tensor's largest magnitude;
- `torch.autograd.gradcheck` of the op in float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from markushgrapher_tpu.ops.flash_attention import (
    flash_attention_bias as jax_flash_attention_bias)
from markushgrapher_torch.ops import flash_attention as tfa

B, H, L, D = 2, 2, 256, 16
TOL = 1e-5


def _inputs(seed, bias_batch, n_valid=(200, 160)):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, L, H, D).astype(np.float32) * s
                   for s in (0.5, 0.5, 1.0, 1.0))
    bias = rng.randn(bias_batch, H, L, L).astype(np.float32)
    for b in range(bias_batch):
        bias[b, :, :, n_valid[b]:] = -1e9          # masked key tail
    return q, k, v, bias, do


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("bias_batch", [B, 1])
def test_plain_bias_matches_jax_interpret(bias_batch):
    q, k, v, bias, _ = _inputs(0, bias_batch)
    want = jax_flash_attention_bias(*map(jnp.asarray, (q, k, v, bias)),
                                    block_q=128, block_k=128, interpret=True)
    got = tfa.plain_bias(*map(torch.from_numpy, (q, k, v, bias)))
    assert _rel(got.numpy(), want) < TOL
    # the serving wrapper takes the plain version on a CPU tensor
    got2 = tfa.flash_attention_bias(*map(torch.from_numpy, (q, k, v, bias)))
    assert torch.equal(got, got2)


def _jax_dense(q, k, v, bias):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                   preferred_element_type=jnp.float32) + bias
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("bias_batch", [B, 1])
def test_flash_attention_bias_grads_match_jax_vjp(bias_batch):
    q, k, v, bias, do = _inputs(1, bias_batch)
    out_j, vjp = jax.vjp(_jax_dense, *map(jnp.asarray, (q, k, v, bias)))
    grads_j = vjp(jnp.asarray(do))

    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, bias))
    out_t = tfa.flash_attention_train(tq, tk, tv, tb)
    out_t.backward(torch.from_numpy(do))
    assert _rel(out_t.detach().numpy(), out_j) < TOL
    for name, t, g in zip(("dq", "dk", "dv", "dbias"), (tq, tk, tv, tb),
                          grads_j):
        assert t.grad.shape == t.shape, name
        assert _rel(t.grad.numpy(), g) < TOL, name


def test_lse_and_bias_dtype():
    """The forward's log-sum-exp is float32 [B, H, L]; d(bias) comes back in
    the bias dtype (bf16 here) and the plain pieces agree with autograd of
    the dense softmax."""
    q, k, v, bias, do = _inputs(2, B)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tb = torch.from_numpy(bias).to(torch.bfloat16)
    out, lse = tfa.plain_fwd(tq, tk, tv, tb)
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) + tb.float()
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-4, rtol=1e-6)
    tb.requires_grad_()
    tfa.flash_attention_train(tq, tk, tv, tb).backward(torch.from_numpy(do))
    assert tb.grad.dtype == torch.bfloat16


def test_gradcheck_float64():
    rng = np.random.RandomState(3)
    shape = (2, 6, 2, 4)
    q, k, v = (torch.tensor(rng.randn(*shape), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    bias = torch.tensor(rng.randn(1, 2, 6, 6), dtype=torch.float64,
                        requires_grad=True)
    assert torch.autograd.gradcheck(tfa.flash_attention_train,
                                    (q, k, v, bias))

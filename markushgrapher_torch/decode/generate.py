"""Batched greedy generation (port of `markushgrapher_tpu.decode.generate`).

The encoder runs once per batch; decoding is a Python loop over steps
against preallocated int4 KV caches, with early exit once every row has
finished. Beam search is not ported yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from markushgrapher_torch.ops.relbias import mask_bias


def pack_encoder_for_cross(enc: torch.Tensor, enc_mask: torch.Tensor,
                           packed_len: int):
    """Move each row's valid encoder positions to a contiguous prefix (stable,
    so their order is kept) and truncate to `packed_len`, which must bound
    every row's valid count. Cross-attention is a softmax over a set of keys,
    so only float summation order changes."""
    order = torch.argsort((enc_mask <= 0).to(torch.int32), dim=1,
                          stable=True)
    enc_p = torch.gather(enc, 1, order[..., None].expand(-1, -1,
                                                         enc.shape[-1]))
    mask_p = torch.gather(enc_mask, 1, order)
    return enc_p[:, :packed_len], mask_p[:, :packed_len]


@torch.no_grad()
def greedy_generate(model, enc: torch.Tensor, enc_mask: torch.Tensor,
                    max_length: int, eos_id: int = 1, pad_id: int = 0,
                    start_id: int = 0,
                    cross_pack_len: Optional[int] = None,
                    row_budgets: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Returns generated ids [B, max_length] (pad after EOS).

    Serves int4 KV caches with int8 weights (the reference's
    quant_cross_kv + quant_weights + int4_cross path; the other KV layouts
    are ROADMAP queue 2). row_budgets ([B] ints, optional) caps each row's
    tokens; positions past a row's budget are pad, and a budget of 0 emits
    only pad."""
    batch = enc.shape[0]
    dev = enc.device
    if cross_pack_len is not None and cross_pack_len < enc.shape[1]:
        enc, enc_mask = pack_encoder_for_cross(enc, enc_mask, cross_pack_len)
    caches = model.init_cache(enc, max_length)
    qw = model.quantize_weights()
    bias_full = model.full_decoder_bias(max_length)
    kp = caches[0]["cross_k_q4"].shape[1]
    cross_bias = F.pad(mask_bias(enc_mask)[:, :1, 0, :],
                       (0, kp - enc_mask.shape[1]), value=-1e9)
    budgets = None if row_budgets is None else torch.as_tensor(
        row_budgets, device=dev)

    tok = torch.full((batch, 1), start_id, dtype=torch.long, device=dev)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    if budgets is not None:
        finished |= budgets <= 0
    out = torch.full((batch, max_length), pad_id, dtype=torch.long,
                     device=dev)
    for step in range(max_length):
        if bool(finished.all()):
            break
        logits = model.decode_step(tok, caches, step, bias_full, cross_bias,
                                   qw)
        next_tok = logits[:, -1].argmax(dim=-1)
        next_tok = torch.where(finished, pad_id, next_tok)
        finished = finished | (next_tok == eos_id)
        if budgets is not None:
            finished = finished | (step + 1 >= budgets)
        out[:, step] = next_tok
        tok = next_tok[:, None]
    return out


@torch.no_grad()
def generate(model, batch: Dict[str, torch.Tensor], max_length: int = 512,
             num_beams: int = 1, eos_id: int = 1, pad_id: int = 0,
             start_id: int = 0,
             cross_pack_len: Optional[int] = None) -> torch.Tensor:
    """Encode + greedy decode. `batch` holds input_ids / bbox /
    attention_mask and the pixel inputs the architecture variant needs."""
    if num_beams > 1:
        raise NotImplementedError(
            "beam search is not ported yet: ROADMAP queue 1 item 6")
    enc, enc_mask = model.encode(
        batch["input_ids"], batch["bbox"], batch["attention_mask"],
        batch.get("pixel_values"), batch.get("ocsr_pixel_values"))
    return greedy_generate(model, enc, enc_mask, max_length, eos_id, pad_id,
                           start_id, cross_pack_len=cross_pack_len)

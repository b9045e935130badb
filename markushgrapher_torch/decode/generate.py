"""Batched greedy and beam-search generation (port of
`markushgrapher_tpu.decode.generate`).

The encoder runs once per batch; decoding is a Python loop over steps
against preallocated KV caches, with early exit once every row has finished
(greedy) or the beam search halts. As in the reference, `quant_cross_kv`
picks quantised caches (the model's `int4_cross` scheme, int4 or int8) over
float caches in the model's dtype, and `quant_weights` quantised decode
weights over the model's own: int8, or int4 at `weight_bits=4`, or W8A8
dots (`act_quant`, int8 weights only).

The quantised beam keeps its self rings as copy-on-write segments (the
reference's TPU serving default, `pick_self_seg`): after each step only the
segment the next step writes is reordered by parent beam, and a row map
says where each beam's earlier segments live; the decode kernels read
through it, or with the lattice only the live segments.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from markushgrapher_torch.models.t5 import reorder_self_rings
from markushgrapher_torch.ops.fusion import pack_valid_first
from markushgrapher_torch.ops.relbias import mask_bias

NEG_INF = -1e9


def pack_encoder_for_cross(enc: torch.Tensor, enc_mask: torch.Tensor,
                           packed_len: int):
    """Move each row's valid encoder positions to a contiguous prefix (stable,
    so their order is kept) and truncate to `packed_len`, which must bound
    every row's valid count. Cross-attention is a softmax over a set of keys,
    so only float summation order changes."""
    _, mask_p, enc_p = pack_valid_first(enc_mask, packed_len, enc)
    return enc_p, mask_p


def pick_self_seg(max_len: int, self_seg: Optional[int] = None,
                  lattice: Optional[bool] = None) -> Tuple[int, bool]:
    """(segment size, lattice) of the quantised beam's copy-on-write self
    rings (segment 0: the whole-ring reorder), the reference's TPU choice
    (`decode/generate.py` `_pick_self_seg`). Explicit arguments override
    the environment: BEAM_LATTICE=1 reads int4 rings segment by segment
    (`ops.mxu_decode.lattice_self_int4`) over segments of 128 when max_len
    is a 128-multiple; BEAM_SELF_SEG, a 128-multiple dividing max_len,
    sets the segment; otherwise one segment of 512 at a 512-multiple, 128
    at a 128-multiple, else 0. An explicit self_seg may be any divisor of
    max_len."""
    if lattice is None:
        lattice = os.environ.get("BEAM_LATTICE", "0") == "1"
    if self_seg is not None:
        if self_seg < 0 or (self_seg and max_len % self_seg):
            raise ValueError(f"self_seg={self_seg} must divide "
                             f"max_len={max_len}")
        return int(self_seg), lattice
    if lattice and max_len % 128 == 0:
        return 128, lattice
    env = os.environ.get("BEAM_SELF_SEG")
    if env is None:
        if max_len % 512 == 0:
            return 512, lattice
        return (128 if max_len % 128 == 0 else 0), lattice
    seg = int(env)
    if seg % 128 or (seg and max_len % seg):
        raise ValueError(f"BEAM_SELF_SEG={seg} must be a 128-multiple "
                         f"dividing max_len={max_len}")
    return seg, lattice


def _tile_beams(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, ...] -> [B*K, ...], each row repeated K times."""
    return x.repeat_interleave(k, dim=0)


def _prepare(model, enc, enc_mask, max_length, self_rows, quant_cross_kv,
             quant_weights, weight_bits, act_quant):
    """The caches (cross K/V of enc's rows, `self_rows` self caches), the
    quantised decode weights (or None), the causal decoder bias and the
    cross mask bias [B, 1, K] (padding of a quantised slab's key axis at
    -1e9)."""
    caches = model.init_cache(enc, max_length, quant_cross_kv,
                              self_rows=self_rows)
    qw = (model.quantize_weights(weight_bits, act_quant) if quant_weights
          else None)
    bias_full = model.full_decoder_bias(max_length)
    cross_bias = mask_bias(enc_mask)[:, :1, 0, :]
    if quant_cross_kv:
        kp = caches[0]["cross_k_s"].shape[-1]
        cross_bias = F.pad(cross_bias, (0, kp - enc_mask.shape[1]),
                           value=NEG_INF)
    return caches, qw, bias_full, cross_bias


@torch.no_grad()
def greedy_generate(model, enc: torch.Tensor, enc_mask: torch.Tensor,
                    max_length: int, eos_id: int = 1, pad_id: int = 0,
                    start_id: int = 0, quant_cross_kv: bool = False,
                    quant_weights: bool = False, weight_bits: int = 8,
                    act_quant: bool = False,
                    cross_pack_len: Optional[int] = None,
                    row_budgets: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Returns generated ids [B, max_length] (pad after EOS).

    quant_cross_kv serves the model's quantised KV scheme (int4 or int8 by
    its `int4_cross`), else float caches; quant_weights the quantised
    decode weights at weight_bits (8 or 4), act_quant W8A8 dots (int8
    weights only). row_budgets ([B] ints, optional) caps each row's tokens;
    positions past a row's budget are pad, and a budget of 0 emits only
    pad."""
    batch = enc.shape[0]
    dev = enc.device
    if cross_pack_len is not None and cross_pack_len < enc.shape[1]:
        enc, enc_mask = pack_encoder_for_cross(enc, enc_mask, cross_pack_len)
    caches, qw, bias_full, cross_bias = _prepare(
        model, enc, enc_mask, max_length, None, quant_cross_kv,
        quant_weights, weight_bits, act_quant)
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


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index (the order
    `jax.lax.top_k` gives; `torch.topk` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along axis 1: x [B, N, ...], idx [B, M] -> [B, M, ...]."""
    return torch.gather(x, 1, idx.reshape(
        idx.shape + (1,) * (x.ndim - 2)).expand(idx.shape + x.shape[2:]))


@torch.no_grad()
def beam_generate(model, enc: torch.Tensor, enc_mask: torch.Tensor,
                  max_length: int, num_beams: int = 5, eos_id: int = 1,
                  pad_id: int = 0, start_id: int = 0,
                  length_penalty: float = 1.0, early_stopping: bool = False,
                  quant_cross_kv: bool = False, quant_weights: bool = False,
                  weight_bits: int = 8, act_quant: bool = False,
                  cross_pack_len: Optional[int] = None,
                  self_seg: Optional[int] = None,
                  lattice: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with HF `_beam_search` semantics, step for step as the
    reference's `beam_generate`: per step the top 2K of the K*V
    continuations are taken; continuations that hit a stopping criterion
    (EOS or max length) and rank in the top K merge into a running finished
    set of K hypotheses (scores normalised by generated_len **
    length_penalty); the best K non-finished continuations carry the live
    search. The loop stops when no live beam can beat the worst finished
    hypothesis (the HF early-stop heuristic), every candidate hits a
    stopping criterion, or (early_stopping=True) every finished slot is
    filled. Returns (ids [B, max_length], scores [B]) of the best finished
    hypothesis.

    With quant_cross_kv the quantised cross slabs keep one row per sample
    (the beams share it) and the self rings B*K rows, kept as copy-on-write
    segments of `pick_self_seg(max_length, self_seg, lattice)`: after each
    step only the segment the next step writes is reordered by parent beam
    (with one segment, the rings' live prefix) and the row map follows the
    parents. Float caches tile the encoder states and mask per beam, as the
    reference's, and reorder their live prefix."""
    batch = enc.shape[0]
    dev = enc.device
    k = num_beams
    if cross_pack_len is not None and cross_pack_len < enc.shape[1]:
        enc, enc_mask = pack_encoder_for_cross(enc, enc_mask, cross_pack_len)
    if not quant_cross_kv:
        enc, enc_mask = _tile_beams(enc, k), _tile_beams(enc_mask, k)
    caches, qw, bias_full, cross_bias = _prepare(
        model, enc, enc_mask, max_length, batch * k, quant_cross_kv,
        quant_weights, weight_bits, act_quant)

    f32 = dict(dtype=torch.float32, device=dev)
    # beam 0 active, the others muted at step 0 so all beams start identical
    run_scores = torch.full((batch, k), NEG_INF, **f32)
    run_scores[:, 0] = 0.0
    run_seqs = torch.full((batch, k, max_length), pad_id, dtype=torch.long,
                          device=dev)
    fin_scores = torch.full((batch, k), NEG_INF, **f32)
    fin_seqs = run_seqs.clone()
    fin_flags = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    heur_unsat = torch.ones(batch, dtype=torch.bool, device=dev)
    # ranks 0..K-1 of the 2K sorted candidates are eligible to finish
    top_k_mask = (torch.arange(2 * k, device=dev) < k)[None]
    row0 = torch.arange(batch, device=dev)[:, None] * k
    tok = torch.full((batch * k, 1), start_id, dtype=torch.long, device=dev)
    # copy-on-write self rings (quantised caches): segment s of row b lives
    # in row rowmap[b, s]; with one segment the map is always the identity
    # and the kernels read the rings directly
    seg, lattice = (pick_self_seg(max_length, self_seg, lattice)
                    if quant_cross_kv else (0, False))
    n_seg = max_length // seg if seg else 0
    rows = torch.arange(batch * k, dtype=torch.int32, device=dev)
    rowmap = rows[:, None].repeat(1, n_seg)
    seg_ids = torch.arange(n_seg, device=dev)[None]

    for step in range(max_length):
        logits = model.decode_step(tok, caches, step, bias_full, cross_bias,
                                   qw, rowmap if n_seg > 1 else None,
                                   lattice)
        logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
        vocab = logp.shape[-1]
        acc = run_scores[..., None] + logp.reshape(batch, k, vocab)
        top2k, idx = _top_k(acc.reshape(batch, k * vocab), 2 * k)
        cand_beam = idx // vocab                              # [B, 2K]
        cand_tok = idx % vocab
        cand_seqs = _take(run_seqs, cand_beam)                # [B, 2K, L]
        cand_seqs[:, :, step] = cand_tok
        hits = (cand_tok == eos_id) | (step + 1 >= max_length)

        # live beams for the next step: the best K non-finished
        # continuations (finished ones muted by -1e9, kept in the score)
        live_scores, live_idx = _top_k(top2k + hits.to(torch.float32)
                                       * NEG_INF, k)
        run_seqs = _take(cand_seqs, live_idx)
        tok = _take(cand_tok, live_idx).reshape(-1, 1)
        parent = (_take(cand_beam, live_idx) + row0).reshape(-1)
        if n_seg > 1:
            # the segment the next step writes (the last one at the last
            # step, as the reference's clamped slice) moves with its parent;
            # earlier segments follow the parent's map, later ones are
            # still unwritten
            cs = (step + 1) // seg
            reorder_self_rings(caches, parent, min(cs * seg,
                                                   max_length - seg), seg)
            rowmap = torch.where(seg_ids >= cs, rows[:, None],
                                 rowmap[parent])
        else:
            reorder_self_rings(caches, parent, 0, step + 1)

        # finished-set update: only top-K-ranked candidates that hit a
        # stopping criterion finish; scores normalised by generated length
        length = torch.tensor(step + 1, **f32) ** length_penalty
        did_finish = hits & top_k_mask
        norm = top2k / length + (~did_finish).to(torch.float32) * NEG_INF
        if early_stopping:
            norm = norm + fin_flags.all(dim=-1, keepdim=True).to(
                torch.float32) * NEG_INF
        norm = norm + (~heur_unsat)[:, None].to(torch.float32) * NEG_INF
        m_scores = torch.cat([fin_scores, norm], dim=1)       # [B, 3K]
        fin_scores, m_idx = _top_k(m_scores, k)
        fin_seqs = _take(torch.cat([fin_seqs, cand_seqs], dim=1), m_idx)
        fin_flags = _take(torch.cat([fin_flags, did_finish], dim=1), m_idx)
        run_scores = live_scores

        # HF early-stop heuristic (early_stopping=False branch): can the
        # best live beam still beat the worst finished hypothesis?
        best_possible = run_scores[:, :1] / length
        worst_fin = torch.where(
            fin_flags, fin_scores.min(dim=1, keepdim=True).values,
            torch.tensor(NEG_INF, **f32))
        heur_unsat = heur_unsat & (best_possible > worst_fin).any(dim=-1)
        open_beam = not (early_stopping and bool(fin_flags.all()))
        if not (bool(heur_unsat.any()) and open_beam
                and not bool(hits.all())):
            break
    # the merged top K keeps descending score order: slot 0 is the best
    return fin_seqs[:, 0], fin_scores[:, 0]


@torch.no_grad()
def generate(model, batch: Dict[str, torch.Tensor], max_length: int = 512,
             num_beams: int = 1, eos_id: int = 1, pad_id: int = 0,
             start_id: int = 0, quant_cross_kv: bool = False,
             quant_weights: bool = False, weight_bits: int = 8,
             act_quant: bool = False,
             cross_pack_len: Optional[int] = None,
             self_seg: Optional[int] = None,
             lattice: Optional[bool] = None) -> torch.Tensor:
    """Encode + decode (greedy, or beam search for num_beams > 1, with its
    self_seg / lattice). `batch` holds input_ids / bbox / attention_mask and
    the pixel inputs the architecture variant needs."""
    enc, enc_mask = model.encode(
        batch["input_ids"], batch["bbox"], batch["attention_mask"],
        batch.get("pixel_values"), batch.get("ocsr_pixel_values"))
    kw = dict(quant_cross_kv=quant_cross_kv, quant_weights=quant_weights,
              weight_bits=weight_bits, act_quant=act_quant,
              cross_pack_len=cross_pack_len)
    if num_beams <= 1:
        return greedy_generate(model, enc, enc_mask, max_length, eos_id,
                               pad_id, start_id, **kw)
    ids, _ = beam_generate(model, enc, enc_mask, max_length, num_beams,
                           eos_id, pad_id, start_id, self_seg=self_seg,
                           lattice=lattice, **kw)
    return ids

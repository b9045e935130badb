"""`markushgrapher_torch.trace_paths` on the CPU at a tiny size: a decode
window runs exactly its steps through the model's decode_step and puts the
method back, under greedy and beam search; the summaries of a profile and
the interval union are right. (The device numbers themselves come only
from a run on the card.)"""

import pytest
import torch

from markushgrapher_torch import trace_paths as tp
from markushgrapher_torch.config import (MarkushGrapherConfig, SwinConfig,
                                         VTLConfig)
from markushgrapher_torch.data.markush_tokenizer import MarkushTokenizer
from markushgrapher_torch.data.synthetic import page_batch
from markushgrapher_torch.eval_pipeline import MODEL_INPUTS
from markushgrapher_torch.models.markushgrapher import (MarkushGrapherModel,
                                                        encoder_valid_max)


@pytest.fixture(scope="module")
def encoded():
    cfg = MarkushGrapherConfig(
        vtl=VTLConfig(d_model=32, d_kv=4, d_ff=64, num_layers=1,
                      num_decoder_layers=2, num_heads=8, image_size=64,
                      patch_size=16, dropout_rate=0.0),
        swin=SwinConfig(image_size=16, patch_size=2, embed_dim=8,
                        depths=(1,), num_heads=(2,), window_size=4),
        architecture_variant="none", max_seq_length=240,
        max_seq_length_decoder=16)
    model = MarkushGrapherModel(cfg).init_weights(0).eval()
    host = page_batch(cfg, 2, 0, MarkushTokenizer())
    args = [torch.as_tensor(host[k]) for k in MODEL_INPUTS]
    pack = -(-encoder_valid_max(cfg, args[1], args[2]) // 256) * 256
    with torch.no_grad():
        enc, mask = model.encode(*args)
    return model, enc, mask, pack


@pytest.mark.parametrize("beams,traced", [(1, False), (5, True)])
def test_decode_window_runs_its_steps(encoded, monkeypatch, beams, traced):
    model, enc, mask, pack = encoded
    monkeypatch.setattr(tp, "SKIP", 3)
    monkeypatch.setattr(tp, "STEPS", 4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    steps = []
    inner = model.decode_step

    def counted(tok, caches, step, *args, **kw):
        steps.append(step)
        return inner(tok, caches, step, *args, **kw)

    monkeypatch.setattr(model, "decode_step", counted)
    wall, prof = tp.decode_window(model, enc, mask, pack, beams, traced)
    assert steps == list(range(7))          # SKIP + STEPS, then stops
    assert model.decode_step is counted     # the window's wrapper is gone
    assert wall > 0 and (prof is not None) == traced
    if traced:
        res = tp.summarise(prof, wall, 4)
        assert res["kernels_per_step"] == 0 and res["busy_share"] == 0
        assert res["traced_ms_per_step"] == pytest.approx(wall * 1e3 / 4)


def test_union_and_kinds():
    assert tp._union_us([(5, 6), (0, 2), (1, 3), (5.5, 5.7)]) == 4.0
    assert tp.kind_of("decode_cluster_kernel<(anonymous namespace)::Int8, "
                      "5, true>(...)") == "decode attention"
    assert tp.kind_of("nvjet_tst_64x8_64x16_4x1_v_bz_TNT") == "GEMM"
    assert tp.kind_of("vectorized_elementwise_kernel<4>") == \
        "elementwise / other"


@pytest.mark.parametrize("opts", [dict(self_seg=4), dict(lattice=True),
                                  dict(block_skip=True)])
def test_decode_window_takes_the_ring_options(encoded, monkeypatch, opts):
    """The copy-on-write, lattice and block_skip windows: the beam's
    self_seg / lattice reach beam_generate (a row map from step 0, at
    four segments of 4), block_skip the model, and the window runs from
    its own first step."""
    model, enc, mask, pack = encoded
    monkeypatch.setattr(tp, "STEPS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    opts = dict(opts)
    scheme = model.clone(block_skip=opts.pop("block_skip", False))
    if "lattice" in opts:
        opts["self_seg"] = 4
    seen = []
    inner = scheme.decode_step

    def counted(tok, caches, step, *args, **kw):
        seen.append((step, args[3] is not None if len(args) > 3 else None))
        return inner(tok, caches, step, *args, **kw)

    monkeypatch.setattr(scheme, "decode_step", counted)
    beams = 1 if scheme.block_skip else 5
    wall, _ = tp.decode_window(scheme, enc, mask, pack, beams, False,
                               skip=5, **opts)
    assert [s for s, _ in seen] == list(range(7)) and wall > 0
    if beams == 5:
        assert all(mapped for _, mapped in seen)


def test_select_paths_cuts_labels_and_batches():
    """--paths keeps every window of a label (early and late), --batches
    the batch sizes; an unknown label is refused."""
    got = tp.select_paths("beam-5 int4 lattice,greedy int4", "8")
    assert {p[0] for p in got} == {"beam-5 int4 lattice", "greedy int4"}
    assert all(p[3] == (8,) for p in got)
    assert sorted(p[4].get("skip", tp.SKIP) for p in got
                  if p[0] == "greedy int4") == [tp.SKIP, 300]
    assert tp.select_paths() == tp.PATHS
    with pytest.raises(ValueError, match="not a label"):
        tp.select_paths("greedy int5")

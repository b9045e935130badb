"""The port's own copies of the host modules (tokenizer, CXSMILES parser,
chemistry scoring, dataset encoding and collator, OCR grammar) give the same
results as the JAX package's originals on the same synthetic samples, OCR
strings and valid-count lists. Neither side needs
rdkit or nltk: where those are installed both copies use them, where not
both take the same pure-Python fallbacks."""

import dataclasses

import numpy as np
import pytest

from markushgrapher_tpu.chem import cxsmiles as j_cx
from markushgrapher_tpu.chem import evaluation as j_eval
from markushgrapher_tpu.data import collator as j_coll
from markushgrapher_tpu.data import dataset as j_ds
from markushgrapher_tpu.data import markush_tokenizer as j_mt
from markushgrapher_tpu.data import synthetic as j_syn
from markushgrapher_tpu.ocr import grammar as j_gram
from markushgrapher_torch.chem import cxsmiles as t_cx
from markushgrapher_torch.chem import evaluation as t_eval
from markushgrapher_torch.data import collator as t_coll
from markushgrapher_torch.data import dataset as t_ds
from markushgrapher_torch.data import markush_tokenizer as t_mt
from markushgrapher_torch.data import synthetic as t_syn
from markushgrapher_torch.ocr import grammar as t_gram

N = 4
T, DEC = 128, 64


@pytest.fixture(scope="module")
def sides():
    """Per side: tokenizer, dataset over the same synthetic pages, and the
    pages themselves (made by the JAX package's generator; the port's copy
    must make the same)."""
    source = j_syn.generate_dataset(N + 1, seed=3, image_size=64)
    out = {}
    for name, mt_mod, ds_mod in (("jax", j_mt, j_ds), ("torch", t_mt, t_ds)):
        mt = mt_mod.MarkushTokenizer()
        ds = ds_mod.MDUDataset(source=source, markush_tokenizer=mt,
                               image_size=64, ocsr_image_size=16,
                               max_seq_length=T, max_seq_length_decoder=DEC)
        out[name] = (mt, ds)
    return source, out


@pytest.mark.parametrize("idx", range(N))
def test_host_copy_matches_jax(sides, idx):
    source, side = sides
    (jmt, jds), (tmt, tds) = side["jax"], side["torch"]
    sample, other = source[idx], source[idx + 1]

    # the port's synthetic generator makes the same page annotation
    assert t_syn.generate_dataset(N + 1, seed=3, image_size=64)[idx][
        "annotation"] == sample["annotation"]

    # MarkushTokenizer: ids, decoded text, parsed table
    ids = jmt.encode(sample["annotation"])
    assert tmt.encode(sample["annotation"]) == ids
    assert tmt.decode(ids) == jmt.decode(ids)
    assert tmt.get_stable(sample["annotation"]) == \
        jmt.get_stable(sample["annotation"])

    # CXSMILES conversion and parse
    out_j = j_cx.convert_opt_to_out(sample["cxsmiles_opt"])
    assert t_cx.convert_opt_to_out(sample["cxsmiles_opt"]) == out_j
    assert dataclasses.asdict(t_cx.parse_cxsmiles(out_j)) == \
        dataclasses.asdict(j_cx.parse_cxsmiles(out_j))

    # score_sample: an exact prediction and another page's annotation
    gt_stable = jmt.get_stable(sample["annotation"])
    for pred in (sample["annotation"], other["annotation"]):
        want = j_eval.score_sample(pred, sample["cxsmiles_opt"], gt_stable,
                                   jmt)
        got = t_eval.score_sample(pred, sample["cxsmiles_opt"], gt_stable,
                                  tmt)
        assert got == want

    # dataset encoding + DataCollator output
    items = [[{k: v for k, v in ds[i].items() if k != "id"}
              for i in (idx, idx + 1)] for ds in (jds, tds)]
    want = j_coll.DataCollator(max_length=T, max_length_decoder=DEC)(
        items[0])
    got = t_coll.DataCollator(max_length=T, max_length_decoder=DEC)(
        items[1])
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


OCR_STRINGS = [
    "noise<ocr><loc_0><loc_0><loc_500><loc_500><loc_10><loc_20><loc_110>"
    "<loc_45>R1\n<loc_200><loc_300><loc_400><loc_350>halogen</ocr>tail",
    "<ocr>0>0>500>500>10>20>110>45>R1\n200>300>400>350>halogen</ocr>",
    "<ocr>12>40>88>61>OMe\nbroken line\n1>2>3>x</ocr>",
    "no boxes here at all", "",
]


@pytest.mark.parametrize("text", OCR_STRINGS)
def test_ocr_grammar_copy_matches_jax(text):
    """The port's copy of ocr/grammar.py: same cleaned text, parse, cells
    and rendered targets (both formats)."""
    assert t_gram.clean_ocr_text(text) == j_gram.clean_ocr_text(text)
    assert t_gram.parse_ocr_string(text) == j_gram.parse_ocr_string(text)
    cells = j_gram.cells_from_prediction(text)
    assert t_gram.cells_from_prediction(text) == cells
    for fmt in ("loc", "gt"):
        assert t_gram.render_ocr_target(cells, fmt) == \
            j_gram.render_ocr_target(cells, fmt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_copy_matches_jax(seed):
    """data/augment.py: the same seed gives the same augmented page and
    cells (image noise, geometric warp where cv2 is installed) and the same
    OCR text noise."""
    from markushgrapher_tpu.data import augment as j_aug
    from markushgrapher_torch.data import augment as t_aug

    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    cells = [{"bbox": [0.1, 0.2, 0.5, 0.3], "text": "R1 = OMe, Cl or 5-Br"},
             {"bbox": [0.6, 0.6, 0.9, 0.8], "text": "S0l8B"}]
    kw = dict(p_geometric=1.0, p_lines=1.0, p_pepper=1.0, p_blur=1.0,
              seed=seed)
    img_j, cells_j = j_aug.Augmenter(**kw)(image, cells)
    img_t, cells_t = t_aug.Augmenter(**kw)(image, cells)
    np.testing.assert_array_equal(img_t, img_j)
    assert cells_t == cells_j
    okw = dict(p_char_sub=0.5, p_insert=0.2, p_delete=0.2, p_transpose=0.2,
               p_case=0.3, seed=seed)
    assert t_aug.OCRAugmenter(**okw)(cells) == j_aug.OCRAugmenter(**okw)(cells)


def test_tracker_copy_matches_jax(tmp_path):
    """utils/tracker.py: the same backends for each `report_to`, and the
    JSONL tracker writes the same stream."""
    from markushgrapher_tpu.utils import tracker as j_tr
    from markushgrapher_torch.utils import tracker as t_tr

    for name in ("none", "", "jsonl", "clearml", "wandb"):
        j = j_tr.make_tracker(name, output_dir=str(tmp_path / "j" / name))
        t = t_tr.make_tracker(name, output_dir=str(tmp_path / "t" / name))
        assert type(t).__name__ == type(j).__name__, name
        for tracker in (j, t):
            tracker.connect({"lr": 1e-3, "shape": (2, 3), "name": "x"})
            tracker.log_scalars(5, {"loss": 0.25, "step": 5})
            tracker.close()
        if name == "jsonl":
            assert (tmp_path / "t" / name / "tracker.jsonl").read_text() == \
                (tmp_path / "j" / name / "tracker.jsonl").read_text()


@pytest.mark.parametrize("n_buckets,round_to,margin,cap", [
    (2, 256, 64, None), (3, 64, 0, 1280), (4, 32, 16, None)])
def test_bucketing_copy_matches_jax(n_buckets, round_to, margin, cap):
    """data/bucketing.py: the same buckets, sample order and per-bucket
    counts for seeded valid counts, and the same refusals."""
    from markushgrapher_tpu.data import bucketing as j_b
    from markushgrapher_torch.data import bucketing as t_b

    counts = np.random.RandomState(n_buckets).randint(200, 1536, size=40)
    args = (counts, n_buckets, round_to, margin, cap)
    want, got = j_b.bucket_pack_lengths(*args), t_b.bucket_pack_lengths(*args)
    assert [ln for ln, _ in got] == [ln for ln, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    order_w, lens_w = j_b.order_and_lengths(*args)
    order_g, lens_g = t_b.order_and_lengths(*args)
    np.testing.assert_array_equal(order_g, order_w)
    assert lens_g == lens_w
    for bad in (([], 2), (counts, 0)):
        with pytest.raises(ValueError):
            j_b.bucket_pack_lengths(*bad)
        with pytest.raises(ValueError):
            t_b.bucket_pack_lengths(*bad)

"""The port's copy of the pure-Python sentencepiece substrate
(`markushgrapher_torch.data.spm`) and the Markush tokenizer over a
checkpoint-style spm base against the JAX package's originals: the same
unigram segmentation, ModelProto bytes, checkpoint loading and Markush ids on
the same seeded inventories and labels. The checkpoint fixture reserves the
base vocabulary's NUM_OTHER `<other_N>` ids, which the vendored Markush
inventory needs."""

import json
import random
import string

import pytest

from markushgrapher_tpu.data import markush_tokenizer as j_mt
from markushgrapher_tpu.data import spm as j_spm
from markushgrapher_tpu.data import vocab as j_vocab
from markushgrapher_torch.data import markush_tokenizer as t_mt
from markushgrapher_torch.data import spm as t_spm
from markushgrapher_torch.data import vocab as t_vocab

ALPHABET = string.ascii_lowercase + string.digits + "()[]=#+-@/\\.%:|,<>"
LABELS = [
    "<markush><cxsmi>CC([1*])C |m:2:3.4|</cxsmi><stable>R1:C<n>N</stable>"
    "</markush>",
    "<markush><cxsmi>CC(C)c1ccc(<r>R1</r>)cc1N* |m:9:5.6.7,Sg:n:2:m:ht|"
    "</cxsmi><stable>R1:halogen<n>OH<ns>m:1-3</stable></markush>",
    "<cxsmi>CC[1*] |m:1:2|</cxsmi>",
]


def _unigram_pieces(seed, n_pieces=400):
    """A seeded unigram inventory over ASCII with ▁-prefixed variants."""
    rng = random.Random(seed)
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
              (t_spm.SP_SPACE, -rng.uniform(1.0, 12.0))]
    seen = {p for p, _ in pieces}
    for c in ALPHABET:
        for p in (c, t_spm.SP_SPACE + c):
            seen.add(p)
            pieces.append((p, -rng.uniform(1.0, 12.0)))
    while len(pieces) < n_pieces:
        body = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(2, 6)))
        p = (t_spm.SP_SPACE + body) if rng.random() < 0.4 else body
        if p not in seen:
            seen.add(p)
            pieces.append((p, -rng.uniform(1.0, 12.0)))
    texts = ["CC(=O)Oc1ccccc1C(=O)O", "c1ccccc1 hello world 12 345",
             "[1*]c1ccc([2*])cc1 |m:2:5.6,Sg:n:3,4:n:ht|", "aéæa 銀行"]
    for _ in range(100):
        texts.append(" ".join(
            "".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 12)))
            for _ in range(rng.randint(1, 5))))
    return pieces, texts


@pytest.mark.parametrize("seed", [0, 1])
def test_unigram_matches_jax(seed):
    pieces, texts = _unigram_pieces(seed)
    toks = [mod.SPMTokenizer(pieces, unk_id=2, pad_id=0, eos_id=1)
            for mod in (j_spm, t_spm)]
    for text in texts:
        want, got = (t.encode(text) for t in toks)
        assert got == want, text
        assert toks[1].tokenize(text) == toks[0].tokenize(text)
        assert toks[1].decode(got) == toks[0].decode(want)


def _proto_pieces(mod):
    chars = string.ascii_letters + string.digits + "()[]=#+-@/\\.%:|,*$"
    pieces = [("<pad>", 0.0, mod.PIECE_CONTROL),
              ("</s>", 0.0, mod.PIECE_CONTROL),
              ("<unk>", 0.0, mod.PIECE_UNKNOWN),
              (mod.SP_SPACE, -4.0, mod.PIECE_NORMAL)]
    pieces += [(p, -2.0, mod.PIECE_NORMAL) for c in chars
               for p in (c, mod.SP_SPACE + c)]
    pieces += [(str(n), -3.0, mod.PIECE_NORMAL) for n in range(10, 40)]
    return pieces


def test_model_proto_matches_jax():
    blobs = [mod.write_model_proto(_proto_pieces(mod))
             for mod in (j_spm, t_spm)]
    assert blobs[1] == blobs[0]
    assert t_spm.parse_model_proto(blobs[0]) == \
        j_spm.parse_model_proto(blobs[0])


@pytest.fixture()
def checkpoint(tmp_path):
    """A checkpoint-style tokenizer directory: spiece.model, then the base
    vocabulary's NUM_OTHER <other_N> and NUM_LOC <loc_N> added tokens."""
    pieces = _proto_pieces(t_spm)
    (tmp_path / "spiece.model").write_bytes(t_spm.write_model_proto(pieces))
    base = len(pieces)
    other, loc = t_vocab.NUM_OTHER, t_vocab.NUM_LOC
    assert (other, loc) == (j_vocab.NUM_OTHER, j_vocab.NUM_LOC)
    added = {f"<other_{i}>": base + i for i in range(other)}
    added.update({f"<loc_{n}>": base + other + n for n in range(loc)})
    (tmp_path / "added_tokens.json").write_text(json.dumps(added))
    return tmp_path


def test_markush_tokenizer_over_spm_base_matches_jax(checkpoint):
    """Loaded through both packages' `MGTokenizer.load_pretrained`, the
    Markush layer over the spm base gives the same ids and decodes."""
    sides = []
    for vocab_mod, mt_mod in ((j_vocab, j_mt), (t_vocab, t_mt)):
        tok = vocab_mod.MGTokenizer.load_pretrained(str(checkpoint))
        sides.append((tok, mt_mod.MarkushTokenizer(tokenizer=tok)))
    (jtok, jmt), (ttok, tmt) = sides
    assert ttok.vocab == jtok.vocab
    assert tmt.vocabulary == jmt.vocabulary
    for label in LABELS:
        ids = tmt.encode(label)
        assert ids == jmt.encode(label), label
        assert ids[0] == ttok.vocab[tmt.vocabulary[label[:label.index(">")
                                                         + 1]]]
        decoded = tmt.decode(ids)
        assert decoded == jmt.decode(ids)
        assert "<cxsmi>" in decoded.replace(" ", "")


def test_hf_tokenizer_json_matches_jax(tmp_path):
    """A byte-level BPE tokenizer.json (the OCR stage's layout) loads
    through both copies' wrapper with the same ids."""
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token=None))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<|endoftext|>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["CC(=O)Oc1ccccc1", "perform ocr on this image",
                             "<loc_12> hello world"], trainer)
    tok.add_special_tokens(["<loc_12>", "<other_0>", "<other_1>"])
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    sides = [mod.load_pretrained(str(tmp_path)) for mod in (j_spm, t_spm)]
    text = "CC(=O)Oc1ccccc1 <loc_12> <other_1>"
    assert sides[1].encode(text, add_eos=False) == \
        sides[0].encode(text, add_eos=False) == tok.encode(text).ids
    ids = sides[0].encode(text)
    assert sides[1].decode(ids) == sides[0].decode(ids)
    assert sides[1].piece_to_id("<loc_12>") == tok.token_to_id("<loc_12>")

"""Sentencepiece-fidelity base tokenizer.

The published MarkushGrapher-2 checkpoint rides on the fork's UDOP/T5
sentencepiece tokenizer plus added special tokens (`<loc_N>`, `<other_N>`,
`<extra_id_N>`); all domain encoding goes through its piece table
(DS4SD/MarkushGrapher:markushgrapher/core/common/markush_tokenizer.py:160-285 and
the `tokenizer._convert_token_to_id` call sites :307-518). Byte-matching that
tokenizer is a hard requirement for running published weights (SURVEY.md §7
"Tokenizer fidelity").

This module loads real checkpoint tokenizers WITHOUT the sentencepiece or
transformers libraries (absent in this environment):

 - a protobuf wire-format reader for sentencepiece `.model` files
   (`parse_model_proto`) — ModelProto is a plain proto2 message; we decode
   the pieces, trainer spec and normalizer spec fields we need,
 - a Unigram Viterbi encoder (`UnigramModel`) matching HF
   `tokenizers.models.Unigram` semantics (validated against it in
   tests/test_spm.py): max-logprob segmentation, single-char unknown
   fallback at `min_score - 10`, consecutive unknowns fused into one piece,
 - an HF `tokenizer.json` importer (Unigram models),
 - `SPMTokenizer` — drop-in for `vocab.MGTokenizer` (same API surface the
   Markush layer uses) with added-token splitting before sentencepiece
   segmentation, exactly like HF slow/fast tokenizers.

Normalization: when the `.model` ships a precompiled nmt_nfkc charsmap
(NormalizerSpec field 2) it is applied verbatim via a darts-clone
double-array reader (`PrecompiledCharsmap`) — checkpoint-exact off-ASCII.
Without one, NFKC + whitespace collapse approximates it (ASCII-identical).
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SP_SPACE = "▁"  # ▁

# sentencepiece ModelProto.SentencePiece.Type values
PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6

_UNK_PENALTY = 10.0


# ---------------------------------------------------------------------------
# protobuf wire-format reader (proto2, no dependency)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes, start: int, end: int):
    """Yield (field_number, wire_type, value) triples.

    value is an int for varint/fixed fields and a bytes slice for
    length-delimited fields.
    """
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x07
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # fixed64
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
            yield field, wire, val
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            yield field, wire, val
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_model_proto(data: bytes) -> dict:
    """Decode a sentencepiece ModelProto.

    Returns {"pieces": [(piece, score, type)], "trainer": {...},
    "normalizer": {...}}.
    """
    pieces: List[Tuple[str, float, int]] = []
    trainer: Dict[str, object] = {}
    normalizer: Dict[str, object] = {}

    for field, wire, val in _iter_fields(data, 0, len(data)):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, PIECE_NORMAL
            for f2, w2, v2 in _iter_fields(val, 0, len(val)):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2.to_bytes(4, "little"))[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val, 0, len(val)):
                if f2 == 3 and w2 == 0:
                    trainer["model_type"] = v2  # 1=unigram 2=bpe
                elif f2 == 40 and w2 == 0:
                    trainer["unk_id"] = v2
                elif f2 == 41 and w2 == 0:
                    trainer["bos_id"] = v2
                elif f2 == 42 and w2 == 0:
                    trainer["eos_id"] = v2
                elif f2 == 43 and w2 == 0:
                    trainer["pad_id"] = v2
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val, 0, len(val)):
                if f2 == 1 and w2 == 2:
                    normalizer["name"] = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    normalizer["precompiled_charsmap"] = v2
                elif f2 == 3 and w2 == 0:
                    normalizer["add_dummy_prefix"] = bool(v2)
                elif f2 == 4 and w2 == 0:
                    normalizer["remove_extra_whitespaces"] = bool(v2)
                elif f2 == 5 and w2 == 0:
                    normalizer["escape_whitespaces"] = bool(v2)
    return {"pieces": pieces, "trainer": trainer, "normalizer": normalizer}


def write_model_proto(
    pieces: Sequence[Tuple[str, float, int]],
    model_type: int = 1,
    unk_id: int = 2,
    add_dummy_prefix: bool = True,
    charsmap: Optional[bytes] = None,
    remove_extra_whitespaces: bool = True,
) -> bytes:
    """Serialize a minimal ModelProto (testing + vocab-export utility)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    def vi(field: int, v: int) -> bytes:
        return varint(field << 3) + varint(v)

    out = b""
    for piece, score, ptype in pieces:
        body = ld(1, piece.encode("utf-8"))
        body += varint((2 << 3) | 5) + struct.pack("<f", score)
        body += vi(3, ptype)
        out += ld(1, body)
    out += ld(2, vi(3, model_type) + vi(40, unk_id))
    norm = ld(1, b"nmt_nfkc")
    if charsmap is not None:
        norm += ld(2, charsmap)
    out += ld(3, norm + vi(3, int(add_dummy_prefix))
              + vi(4, int(remove_extra_whitespaces)) + vi(5, 1))
    return out


# ---------------------------------------------------------------------------
# Precompiled charsmap (nmt_nfkc normalization, checkpoint fidelity)
# ---------------------------------------------------------------------------


class PrecompiledCharsmap:
    """Sentencepiece precompiled normalization map (NormalizerSpec field 2).

    Published checkpoints ship their full nmt_nfkc rule set as a
    darts-clone double-array trie over UTF-8 prefixes plus a blob of
    NUL-terminated replacement strings; applying it verbatim reproduces the
    checkpoint tokenizer's normalization exactly — including the off-ASCII
    cases the NFKC approximation in `SPMTokenizer._normalize` can miss.
    Blob layout (sentencepiece normalizer.cc DecodePrecompiledCharsMap):
    [uint32 trie_size][trie units, uint32 each][replacement blob].
    """

    def __init__(self, blob: bytes):
        (n,) = struct.unpack("<I", blob[:4])
        if n % 4 or 4 + n > len(blob):
            raise ValueError("malformed precompiled_charsmap blob")
        self._units = struct.unpack(f"<{n // 4}I", blob[4:4 + n])
        self._norm = blob[4 + n:]

    @staticmethod
    def _offset(unit: int) -> int:
        # darts-clone DoubleArrayUnit::offset()
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def _longest_match(self, data: bytes, start: int) -> Tuple[int, int]:
        """Longest trie match at data[start:]: (value, length) or (-1, 0).

        darts-clone commonPrefixSearch with XOR addressing; sentencepiece's
        NormalizePrefix keeps the longest reported rule.
        """
        units = self._units
        node_pos = self._offset(units[0])
        best_val, best_len = -1, 0
        for i in range(start, len(data)):
            c = data[i]
            node_pos ^= c
            if node_pos >= len(units):
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:  # label() mismatch (bit31 = leaf)
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:  # has_leaf
                if node_pos >= len(units):  # truncated blob, not a miss
                    raise ValueError(
                        "malformed precompiled_charsmap blob: leaf value "
                        f"position {node_pos} out of range")
                best_val = units[node_pos] & 0x7FFFFFFF
                best_len = i - start + 1
        return best_val, best_len

    def normalize(self, text: str) -> str:
        """Transduce text through the rule trie (unmatched chars copy)."""
        data = text.encode("utf-8")
        out = bytearray()
        i, n = 0, len(data)
        while i < n:
            val, ln = self._longest_match(data, i)
            if ln:
                end = self._norm.find(b"\0", val)
                if val >= len(self._norm) or end < 0:
                    raise ValueError(
                        "malformed precompiled_charsmap blob: replacement "
                        f"at {val} missing NUL terminator")
                out += self._norm[val:end]
                i += ln
            else:
                # copy one UTF-8 char unchanged (inputs are python str, so
                # the byte stream is always valid UTF-8)
                b0 = data[i]
                step = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else \
                    3 if b0 < 0xF0 else 4
                out += data[i:i + step]
                i += step
        return out.decode("utf-8")


# ---------------------------------------------------------------------------
# Unigram Viterbi
# ---------------------------------------------------------------------------

class UnigramModel:
    """Unigram segmentation over a scored piece inventory.

    Matches HF `tokenizers.models.Unigram` (validated in tests/test_spm.py):
    maximize the sum of piece log-probs; characters not covered by any piece
    become unknown pieces scored `min_score - 10`; consecutive unknown chars
    fuse into one unk token.
    """

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int):
        self.pieces: Dict[str, Tuple[int, float]] = {}
        self.unk_id = unk_id
        min_score = 0.0
        self.max_len = 1
        for i, (piece, score) in enumerate(pieces):
            self.pieces[piece] = (i, score)
            if len(piece) > self.max_len:
                self.max_len = len(piece)
            if score < min_score:
                min_score = score
        self.unk_score = min_score - _UNK_PENALTY

    def viterbi(self, text: str) -> List[Tuple[str, int]]:
        """Segment `text` (already normalized, ▁-marked) into (piece, id)."""
        n = len(text)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self.max_len)
            matched_single = False
            for j in range(i + 1, hi + 1):
                sub = text[i:j]
                hit = self.pieces.get(sub)
                if hit is None:
                    continue
                if j == i + 1:
                    matched_single = True
                pid, score = hit
                cand = best[i] + score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, sub, pid)
            if not matched_single:
                # unknown single char fallback
                cand = best[i] + self.unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, text[i:i + 1], self.unk_id)
        # reconstruct
        out: List[Tuple[str, int]] = []
        j = n
        while j > 0:
            step = back[j]
            if step is None:  # unreachable given the unk fallback
                raise RuntimeError("viterbi dead end")
            i, sub, pid = step
            out.append((sub, pid))
            j = i
        out.reverse()
        # fuse consecutive unknowns
        fused: List[Tuple[str, int]] = []
        for piece, pid in out:
            if fused and pid == self.unk_id and fused[-1][1] == self.unk_id:
                fused[-1] = (fused[-1][0] + piece, self.unk_id)
            else:
                fused.append((piece, pid))
        return fused


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

class SPMTokenizer:
    """Checkpoint-fidelity base tokenizer.

    Same API surface as `vocab.MGTokenizer` (the contract the Markush layer
    consumes): `tokenize`, `encode`, `piece_to_id`, `_convert_token_to_id`,
    `convert_ids_to_tokens`, `decode`, `vocab`, pad/eos/unk ids.

    Added (special) tokens are split out of the text by longest-match before
    sentencepiece segmentation — HF added-token semantics.
    """

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float]],
        added_tokens: Optional[Dict[str, int]] = None,
        unk_id: int = 2,
        pad_id: int = 0,
        eos_id: int = 1,
        add_dummy_prefix: bool = True,
        charsmap: Optional[bytes] = None,
        remove_extra_whitespaces: bool = True,
    ):
        # real nmt_nfkc rules when the checkpoint ships them; the NFKC
        # approximation below otherwise (ASCII-identical either way)
        self.charsmap = PrecompiledCharsmap(charsmap) if charsmap else None
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.sp_pieces = list(pieces)
        self.model = UnigramModel(self.sp_pieces, unk_id=unk_id)
        self.added_tokens = dict(added_tokens or {})
        self.vocab: Dict[str, int] = {p: i for i, (p, _) in enumerate(self.sp_pieces)}
        self.vocab.update(self.added_tokens)
        self.ids_to_pieces = {i: p for p, i in self.vocab.items()}
        self.pad_token_id = pad_id
        self.eos_token_id = eos_id
        self.unk_token_id = unk_id
        self.add_dummy_prefix = add_dummy_prefix
        self.vocab_size = max(self.ids_to_pieces) + 1 if self.ids_to_pieces else 0
        self.num_other = sum(
            1 for t in self.added_tokens if t.startswith("<other_")
        )
        self._added_re = (
            re.compile(
                "(" + "|".join(
                    re.escape(t) for t in sorted(self.added_tokens, key=len, reverse=True)
                ) + ")"
            )
            if self.added_tokens
            else None
        )

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.charsmap is not None:
            # checkpoint-exact: transduce through the shipped rule trie,
            # then remove_extra_whitespaces (collapse + strip)
            text = self.charsmap.normalize(text)
        else:
            # nmt_nfkc approximation: NFKC + control strip + ws collapse
            text = unicodedata.normalize("NFKC", text)
            text = "".join(
                " " if (c in "\t\n\r\v\f") else c
                for c in text
                if unicodedata.category(c) != "Cc" or c in "\t\n\r"
            )
        if self.remove_extra_whitespaces:  # NormalizerSpec field 4
            text = re.sub(r" +", " ", text).strip(" ")
        return text

    # -- core ---------------------------------------------------------------

    def _sp_tokenize(self, text: str) -> List[Tuple[str, int]]:
        text = self._normalize(text)
        if not text:
            return []
        out: List[Tuple[str, int]] = []
        # Metaspace(prepend_scheme=always) semantics: each whitespace-separated
        # word is ▁-prefixed and segmented independently.
        for word in text.split(" "):
            marked = (SP_SPACE + word) if self.add_dummy_prefix else word
            out.extend(self.model.viterbi(marked))
        return out

    def tokenize(self, text: str) -> List[str]:
        return [p for p, _ in self._tokenize_with_ids(text)]

    def _tokenize_with_ids(self, text: str) -> List[Tuple[str, int]]:
        if self._added_re is None:
            return self._sp_tokenize(text)
        out: List[Tuple[str, int]] = []
        for part in self._added_re.split(text):
            if not part:
                continue
            if part in self.added_tokens:
                out.append((part, self.added_tokens[part]))
            else:
                out.extend(self._sp_tokenize(part))
        return out

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = [i for _, i in self._tokenize_with_ids(text)]
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, self.unk_token_id)

    def _convert_token_to_id(self, token: str) -> int:
        if token in self.vocab:
            return self.vocab[token]
        marked = SP_SPACE + token
        if marked in self.vocab:
            return self.vocab[marked]
        return self.unk_token_id

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_pieces.get(int(i), "<unk>") for i in ids]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        parts: List[str] = []
        for i in ids:
            p = self.ids_to_pieces.get(int(i), "<unk>")
            if skip_special_tokens and p in ("<pad>", "</s>"):
                continue
            parts.append(p)
        return "".join(parts).replace(SP_SPACE, " ").strip()


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def load_sentencepiece_model(
    path: str, added_tokens: Optional[Dict[str, int]] = None
) -> SPMTokenizer:
    """Load a sentencepiece `.model` file (Unigram only)."""
    with open(path, "rb") as f:
        proto = parse_model_proto(f.read())
    trainer = proto["trainer"]
    if trainer.get("model_type", 1) != 1:
        raise ValueError("only Unigram sentencepiece models are supported")
    pieces = [(p, s) for p, s, _ in proto["pieces"]]
    ptypes = {p: t for p, _, t in proto["pieces"]}
    unk_id = trainer.get("unk_id", 2)
    # T5 convention: pad=0(<pad>), eos=1(</s>), unk=2(<unk>)
    ids = {p: i for i, (p, _, _) in enumerate(proto["pieces"])}
    pad_id = trainer.get("pad_id", ids.get("<pad>", 0))
    eos_id = trainer.get("eos_id", ids.get("</s>", 1))
    tok = SPMTokenizer(
        pieces,
        added_tokens=added_tokens,
        unk_id=unk_id,
        pad_id=pad_id if pad_id >= 0 else 0,
        eos_id=eos_id if eos_id >= 0 else 1,
        add_dummy_prefix=proto["normalizer"].get("add_dummy_prefix", True),
        charsmap=proto["normalizer"].get("precompiled_charsmap"),
        remove_extra_whitespaces=proto["normalizer"].get(
            "remove_extra_whitespaces", True),
    )
    # control pieces (<pad>, </s>, ...) never match text segments
    for p, t in ptypes.items():
        if t in (PIECE_CONTROL, PIECE_UNUSED) and p in tok.model.pieces:
            del tok.model.pieces[p]
    return tok


class HFTokenizerWrapper:
    """`tokenizers`-library adapter exposing the same API surface as
    SPMTokenizer, for non-Unigram checkpoint tokenizers (e.g. the
    ChemicalOCR stage's SmolLM2-family byte-level BPE). Pure-python
    substrate covers Unigram/T5; BPE checkpoints ride the Rust library
    when it is installed."""

    def __init__(self, tok, pad_id: int = 0, eos_id: int = 1,
                 unk_id: int = 0):
        self._tok = tok
        self.vocab: Dict[str, int] = tok.get_vocab(with_added_tokens=True)
        self.ids_to_pieces = {i: p for p, i in self.vocab.items()}
        self.vocab_size = tok.get_vocab_size(with_added_tokens=True)
        self.pad_token_id = pad_id
        self.eos_token_id = eos_id
        self.unk_token_id = unk_id
        self.num_other = sum(1 for t in self.vocab if t.startswith("<other_"))

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizerWrapper":
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(path)
        vocab = tok.get_vocab(with_added_tokens=True)
        ids = {n: vocab[n] for n in ("<pad>", "</s>", "<unk>",
                                     "<|endoftext|>") if n in vocab}
        return cls(tok,
                   pad_id=ids.get("<pad>", 0),
                   eos_id=ids.get("</s>", ids.get("<|endoftext|>", 1)),
                   unk_id=ids.get("<unk>", 0))

    def tokenize(self, text: str) -> List[str]:
        return self._tok.encode(text, add_special_tokens=False).tokens

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, self.unk_token_id)

    def _convert_token_to_id(self, token: str) -> int:
        if token in self.vocab:
            return self.vocab[token]
        for marked in (SP_SPACE + token, "Ġ" + token):  # ▁ / Ġ
            if marked in self.vocab:
                return self.vocab[marked]
        return self.unk_token_id

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_pieces.get(int(i), "<unk>") for i in ids]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)


def load_hf_tokenizer_json(path: str) -> SPMTokenizer:
    """Load an HF fast-tokenizer `tokenizer.json`.

    Unigram models use the pure-python substrate (exact, no deps);
    other model types (BPE, WordPiece) fall back to the `tokenizers`
    library via HFTokenizerWrapper."""
    with open(path) as f:
        spec = json.load(f)
    model = spec.get("model", {})
    if model.get("type") != "Unigram":
        return HFTokenizerWrapper.from_file(path)
    pieces = [(v[0], float(v[1])) for v in model["vocab"]]
    unk_id = int(model.get("unk_id", 2))
    added: Dict[str, int] = {}
    for at in spec.get("added_tokens", []):
        added[at["content"]] = int(at["id"])
    ids = {p: i for i, (p, _) in enumerate(pieces)}
    ids.update(added)
    pre = spec.get("pre_tokenizer") or {}
    prepends = [pre] + list(pre.get("pretokenizers", []))
    add_prefix = any(
        p.get("type") == "Metaspace" and p.get("prepend_scheme", "always") != "never"
        for p in prepends
    )
    # checkpoint-exact normalization: HF serializes the sentencepiece
    # precompiled_charsmap as base64 in a Precompiled normalizer (possibly
    # inside a Sequence) — the primary published-checkpoint path must use
    # the real rule trie, not the NFKC approximation
    charsmap = None
    norm = spec.get("normalizer") or {}
    for n in [norm] + list(norm.get("normalizers", [])):
        if n.get("type") == "Precompiled" and n.get("precompiled_charsmap"):
            charsmap = base64.b64decode(n["precompiled_charsmap"])
            break
    return SPMTokenizer(
        pieces,
        added_tokens=added,
        unk_id=unk_id,
        pad_id=ids.get("<pad>", 0),
        eos_id=ids.get("</s>", 1),
        add_dummy_prefix=add_prefix or not prepends[0],
        charsmap=charsmap,
    )


def load_pretrained(path: str) -> SPMTokenizer:
    """Load a checkpoint tokenizer directory (HF layout).

    Prefers `tokenizer.json`; falls back to `spiece.model` +
    `added_tokens.json`. This is the entry that reproduces the published
    MarkushGrapher-2 fork tokenizer id layout exactly.
    """
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        return load_hf_tokenizer_json(tj)
    spm = os.path.join(path, "spiece.model")
    if not os.path.exists(spm):
        raise FileNotFoundError(f"no tokenizer.json or spiece.model under {path}")
    added: Dict[str, int] = {}
    aj = os.path.join(path, "added_tokens.json")
    if os.path.exists(aj):
        with open(aj) as f:
            added = {k: int(v) for k, v in json.load(f).items()}
    return load_sentencepiece_model(spm, added_tokens=added)

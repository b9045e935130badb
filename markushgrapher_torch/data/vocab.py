"""Self-contained base tokenizer with a UDOP-compatible id layout.

The reference model rides on a T5 sentencepiece tokenizer extended with
`<loc_N>` and `<other_N>` special tokens (fork tokenizer; usage surface at
DS4SD/MarkushGrapher:markushgrapher/core/common/markush_tokenizer.py). The fork's
sentencepiece model is not redistributable, so this framework defines its own
deterministic vocabulary with the *same contract*:

 - total vocab size 33201 (UDOP default, configuration_udop.py),
 - `<loc_0>` .. `<loc_500>` pinned to ids 32500..33000 (the reference trainer
   computes loc-token MAE on exactly that id range,
   curriculumTrainer.py:676-687),
 - reserved `<other_N>` ids for the Markush domain vocabulary,
 - sentencepiece-style `▁` word-start marker semantics so the Markush
   tokenizer's `encode(c)[:-1]` / `tokenize(word)` call patterns behave the
   same way.

Tokenization is character-level with whole-piece digits/numbers (the Markush
grammar emits atom indices and ring indices as single tokens,
markush_tokenizer.py:414-417, 486-512). Hot-path batch encoding can be routed
through the optional C++ extension (csrc/).
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence

SP_SPACE = "▁"  # sentencepiece word-start marker

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2

LOC_BASE_ID = 32500
NUM_LOC = 501  # <loc_0> .. <loc_500>
VOCAB_TOTAL = 33201

NUM_EXTRA_IDS = 100
NUM_OTHER = 2048
MAX_WHOLE_NUMBER = 1023  # "10".."1023" as whole pieces


def _printable_chars() -> List[str]:
    return [chr(c) for c in range(33, 127)]


def build_base_vocab() -> Dict[str, int]:
    """Deterministically construct the piece->id table."""
    pieces: List[str] = ["<pad>", "</s>", "<unk>"]
    pieces.append(SP_SPACE)
    chars = _printable_chars()
    pieces.extend(chars)  # bare chars (mid-word continuation)
    pieces.extend(SP_SPACE + c for c in chars)  # word-initial chars
    # whole-number pieces (multi-digit); single digits already covered by chars
    pieces.extend(str(n) for n in range(10, MAX_WHOLE_NUMBER + 1))
    pieces.extend(SP_SPACE + str(n) for n in range(10, MAX_WHOLE_NUMBER + 1))
    # T5-style sentinel tokens
    pieces.extend(f"<extra_id_{i}>" for i in range(NUM_EXTRA_IDS))
    # reserved domain tokens
    pieces.extend(f"<other_{i}>" for i in range(NUM_OTHER))

    vocab: Dict[str, int] = {}
    for p in pieces:
        if p in vocab:
            raise ValueError(f"duplicate piece {p!r}")
        vocab[p] = len(vocab)
    if len(vocab) > LOC_BASE_ID:
        raise ValueError("base vocabulary overflows into the <loc_*> id range")
    # filler up to the pinned loc range
    i = 0
    while len(vocab) < LOC_BASE_ID:
        vocab[f"<unused_{i}>"] = len(vocab)
        i += 1
    for n in range(NUM_LOC):
        vocab[f"<loc_{n}>"] = LOC_BASE_ID + n
    while len(vocab) < VOCAB_TOTAL:
        vocab[f"<unused_{i}>"] = len(vocab)
        i += 1
    return vocab


@lru_cache(maxsize=1)
def _default_vocab() -> Dict[str, int]:
    return build_base_vocab()


class MGTokenizer:
    """Base tokenizer exposing the (small) API surface the Markush layer uses:
    `tokenize`, `encode`, `_convert_token_to_id`, `convert_ids_to_tokens`,
    `decode`. Sentencepiece-like: each word starts with a `▁`-prefixed piece.
    """

    def __init__(self, vocab: Dict[str, int] | None = None):
        self.vocab = dict(vocab) if vocab is not None else _default_vocab()
        self.ids_to_pieces = {i: p for p, i in self.vocab.items()}
        self.pad_token_id = PAD_ID
        self.eos_token_id = EOS_ID
        self.unk_token_id = UNK_ID
        self.vocab_size = len(self.vocab)
        self.num_other = NUM_OTHER

    # -- core ------------------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in text.split():
            pieces.extend(self._tokenize_word(word))
        return pieces

    def _tokenize_word(self, word: str) -> List[str]:
        # whole-word number piece
        marked = SP_SPACE + word
        if marked in self.vocab:
            return [marked]
        out: List[str] = []
        for j, ch in enumerate(word):
            if j == 0:
                piece = SP_SPACE + ch
                if piece not in self.vocab:
                    out.append(SP_SPACE)
                    piece = ch
            else:
                piece = ch
            out.append(piece if piece in self.vocab else "<unk>")
        return out

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = [self.piece_to_id(p) for p in self.tokenize(text)]
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, UNK_ID)

    # reference-compatible aliases (markush_tokenizer.py call sites)
    def _convert_token_to_id(self, token: str) -> int:
        """Convert a single token; bare tokens resolve to their word-initial
        piece if the bare piece is absent (sentencepiece lookup order)."""
        if token in self.vocab:
            return self.vocab[token]
        marked = SP_SPACE + token
        if marked in self.vocab:
            return self.vocab[marked]
        return UNK_ID

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

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.vocab, f)

    @classmethod
    def load(cls, path: str) -> "MGTokenizer":
        with open(path) as f:
            return cls(json.load(f))

    @staticmethod
    def load_pretrained(path: str):
        """Load a published-checkpoint tokenizer directory (HF layout:
        tokenizer.json or spiece.model + added_tokens.json). Returns an
        `SPMTokenizer` with the exact checkpoint id layout — use this instead
        of the self-contained vocab when running converted fork weights."""
        from markushgrapher_torch.data import spm

        return spm.load_pretrained(path)


def loc_token_id(n: int) -> int:
    if not 0 <= n < NUM_LOC:
        raise ValueError(f"loc index {n} out of range")
    return LOC_BASE_ID + n

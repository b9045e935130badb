"""Atom-wise SMILES tokenization.

Equivalent of SmilesPE's `atomwise_tokenizer` which the reference uses to
split (CX)SMILES into chemically meaningful tokens before mapping them to
`<other_N>` ids (DS4SD/MarkushGrapher:markushgrapher/core/common/markush_tokenizer.py:307,396).
Implemented with the standard SMILES lexical grammar.
"""

from __future__ import annotations

import re
from typing import List

# Bracket atoms are single tokens; two-letter organic-subset elements (Cl, Br)
# take precedence over their one-letter prefixes; %NN is a two-digit ring bond.
_SMILES_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]"
    r"|Br|Cl"
    r"|[BCNOPSFI]"
    r"|[bcnops]"
    r"|%\d{2}"
    r"|[0-9()=#\-+\\/:~@?*$.]"
    r"|>>?"
    r")"
)


_native_tokenize = None


def _get_native():
    global _native_tokenize
    if _native_tokenize is None:
        try:
            from markushgrapher_torch.utils import native

            _native_tokenize = native.atomwise_tokenize if native.available() \
                else False
        except Exception:
            _native_tokenize = False
    return _native_tokenize


def atomwise_tokenizer(smiles: str) -> List[str]:
    """Split a SMILES string into atom/bond/ring/branch tokens.

    Characters that do not match the SMILES grammar are passed through as
    single-character tokens (the reference feeds arbitrary text fragments —
    e.g. condensed R-labels — through the same splitter). Routed through the
    C++ extension when available (csrc/markush_native.cpp).
    """
    fast = _get_native()
    if fast:
        out = fast(smiles)
        if out is not None:
            return out
    tokens: List[str] = []
    pos = 0
    n = len(smiles)
    while pos < n:
        m = _SMILES_TOKEN_RE.match(smiles, pos)
        if m:
            tokens.append(m.group(0))
            pos = m.end()
        else:
            tokens.append(smiles[pos])
            pos += 1
    return tokens


_ATOM_TOKEN_RE = re.compile(r"^(\[[^\]]+\]|Br|Cl|[BCNOPSFI]|[bcnops])$")


def is_atom_token(token: str) -> bool:
    return bool(_ATOM_TOKEN_RE.match(token)) or token == "*"

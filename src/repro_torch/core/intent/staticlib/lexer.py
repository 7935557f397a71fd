"""Tokenizer for the C-like I/O kernel dialect.

Produces a flat token stream with source lines attached (provenance call
sites are ``func:line``).  Comments and preprocessor lines are skipped —
this is the load-bearing difference from the regex extractor, which can
be fooled by the word "shared" or a call name inside a comment.

A copy of ``repro.core.intent.staticlib.lexer``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

# multi-char operators, longest first so maximal munch works
_OPERATORS = (
    "<<=", ">>=", "->", "++", "--", "<<", ">>", "<=", ">=", "==", "!=",
    "&&", "||", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
)
_SINGLE = "+-*/%<>=!&|^~?:;,.(){}[]"


@dataclass(frozen=True)
class Token:
    """One lexical token: ``kind`` is ident/num/str/char/punct/eof."""
    kind: str
    text: str
    line: int


class LexError(ValueError):
    """Raised on bytes the C-like lexer cannot tokenize."""


def tokenize(src: str) -> List[Token]:
    """Lex ``src`` into tokens, dropping comments and ``#`` lines."""
    toks: List[Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise LexError(f"unterminated comment at line {line}")
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if src.startswith("//", i):
            i = src.find("\n", i)
            i = n if i < 0 else i
            continue
        if c == "#" and (not toks or toks[-1].line != line):
            # preprocessor directive: skip to end of line
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == '"' or c == "'":
            quote, j = c, i + 1
            while j < n and src[j] != quote:
                j += 2 if src[j] == "\\" else 1
            if j >= n:
                raise LexError(f"unterminated literal at line {line}")
            toks.append(Token("str" if quote == '"' else "char",
                              src[i + 1:j], line))
            i = j + 1
            continue
        if c.isdigit():
            j = i
            while j < n and (src[j].isalnum() or src[j] in "._xX"):
                j += 1
            toks.append(Token("num", src[i:j], line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(Token("ident", src[i:j], line))
            i = j
            continue
        matched = False
        for op in _OPERATORS:
            if src.startswith(op, i):
                toks.append(Token("punct", op, line))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in _SINGLE:
            toks.append(Token("punct", c, line))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at line {line}")
    toks.append(Token("eof", "", line))
    return toks

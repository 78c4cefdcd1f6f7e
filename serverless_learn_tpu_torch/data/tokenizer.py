"""Vocab-file BPE and sequence packing, the port of
``serverless_learn_tpu/data/tokenizer.py``: :class:`BPETokenizer` (the
GPT-2 family's byte-level BPE from ``vocab.json`` + ``merges.txt``),
:func:`pack_token_docs`, :func:`packing_efficiency` and
:func:`load_text_corpus`.

The reference's pre-tokenizer is a pattern of the third-party ``regex``
module (``\\p{L}``, ``\\p{N}``); the port keeps no such dependency and
builds the same pattern for the standard ``re`` with the letter and
number classes read from :mod:`unicodedata` and ``\\s`` as Unicode's
White_Space. Where the ``regex`` module knows a newer Unicode version
than the interpreter (Python 3.12: Unicode 15.0), characters assigned
since then split differently.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from serverless_learn_tpu_torch.data.raw import (BOS_ID, EOS_ID,
                                                 open_maybe_gz,
                                                 tokenize_bytes)

# Unicode's White_Space property (what ``regex``'s \s matches).
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def _class(ranges) -> str:
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


def _category_ranges(major: str) -> List[Tuple[int, int]]:
    out, start = [], None
    for c in range(0x110000):
        if unicodedata.category(chr(c))[0] == major:
            if start is None:
                start = c
        elif start is not None:
            out.append((start, c - 1))
            start = None
    if start is not None:
        out.append((start, 0x10FFFF))
    return out


@lru_cache(maxsize=1)
def _gpt2_split() -> "re.Pattern":
    """GPT-2's pre-tokenizer: contractions, letter runs, number runs,
    symbol runs (each optionally space-prefixed), then whitespace."""
    L = _class(_category_ranges("L"))
    N = _class(_category_ranges("N"))
    S = _class(_WHITE_SPACE)
    return re.compile(rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+|"
                      rf" ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+")


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table: the 188
    printable latin-1 bytes map to themselves, the rest shift past 0x100."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer:
    """GPT-2-format byte-level BPE from (vocab.json, merges.txt)."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 eos_token: Optional[str] = None):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self._b2u = _bytes_to_unicode()
        self._u2b = {c: b for b, c in self._b2u.items()}
        self._pat = _gpt2_split()
        self._cache: Dict[str, List[str]] = {}
        self.eos_id = (self.vocab[eos_token] if eos_token else
                       self.vocab.get("<|endoftext|>",
                                      self.vocab.get("</s>")))
        self.unk_id = next((self.vocab[t] for t in ("<unk>", "<UNK>", "[UNK]")
                            if t in self.vocab), None)

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: Optional[str] = None,
                   **kw) -> "BPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        if merges_path:
            with open(merges_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
        return cls(vocab, merges, **kw)

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    def _bpe(self, token: str) -> List[str]:
        """Greedy lowest-rank merging of one pre-token's symbols."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        if len(self._cache) < 65536:
            self._cache[token] = word
        return word

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for pre in self._pat.findall(text):
            mapped = "".join(self._b2u[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                i = self.vocab.get(piece)
                if i is not None:
                    ids.append(i)
                    continue
                # A merge product the vocab lacks: its byte symbols; a
                # missing byte symbol becomes <unk>, or is dropped
                # without one.
                for c in piece:
                    j = self.vocab.get(c, self.unk_id)
                    if j is not None:
                        ids.append(j)
        return np.asarray(ids, np.int32)

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.inv_vocab[int(i)] for i in ids
                       if int(i) in self.inv_vocab)
        data = bytes(self._u2b[c] for c in text if c in self._u2b)
        return data.decode("utf-8", errors="replace")


def pack_token_docs(docs: Sequence[np.ndarray], seq_len: int,
                    bos_id: int = BOS_ID, eos_id: int = EOS_ID,
                    ) -> Dict[str, np.ndarray]:
    """Ragged token documents packed into dense ``[N, seq_len]`` rows:
    each row starts with BOS, documents lie end to end separated by EOS
    across row boundaries, the final partial row is dropped. Returns
    ``{"input_ids": rows}``."""
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2, got {seq_len}")
    stream: List[np.ndarray] = []
    for d in docs:
        d = np.asarray(d, np.int32).ravel()
        if len(d) == 0:
            continue
        stream.append(d)
        stream.append(np.asarray([eos_id], np.int32))
    if not stream:
        raise ValueError("no non-empty documents to pack")
    flat = np.concatenate(stream)
    body = seq_len - 1  # BOS heads every row
    n = len(flat) // body
    if n == 0:
        raise ValueError(
            f"corpus has {len(flat)} tokens (incl. separators), fewer "
            f"than one {seq_len}-token packed row")
    rows = flat[:n * body].reshape(n, body)
    bos = np.full((n, 1), bos_id, np.int32)
    return {"input_ids": np.concatenate([bos, rows], axis=1)}


def packing_efficiency(docs: Sequence[np.ndarray], seq_len: int) -> dict:
    """Packed rows against one-document-per-row padding: row counts and
    the pad fraction each layout would ship."""
    lens = [len(np.asarray(d).ravel()) for d in docs if len(d)]
    packed = pack_token_docs(docs, seq_len)["input_ids"]
    naive_rows = sum(-(-max(n + 2, seq_len) // seq_len) for n in lens)
    naive_pad = 1.0 - sum(min(n + 2, naive_rows * seq_len) for n in lens) \
        / max(naive_rows * seq_len, 1)
    return {
        "packed_rows": int(packed.shape[0]),
        "naive_rows": int(naive_rows),
        "packed_pad_fraction": 0.0,
        "naive_pad_fraction": round(float(naive_pad), 4),
        "wire_bytes_saved_fraction": round(
            1.0 - packed.shape[0] / max(naive_rows, 1), 4),
    }


def load_text_corpus(path: str, seq_len: int,
                     vocab_file: Optional[str] = None,
                     merges_file: Optional[str] = None,
                     doc_sep: str = "\n\n") -> Dict[str, np.ndarray]:
    """A text file as packed ``{"input_ids": [N, seq_len]}`` records:
    documents split on ``doc_sep``, tokenized with the GPT-2-format BPE of
    ``vocab_file`` (+ ``merges_file``) or else byte by byte, then packed.
    A GPT-2 vocab has no distinct BOS: its end-of-text token heads rows
    and separates documents."""
    with open_maybe_gz(path) as f:
        text = f.read().decode("utf-8", errors="replace")
    raw_docs = [d for d in text.split(doc_sep) if d.strip()]
    if vocab_file:
        tok = BPETokenizer.from_files(vocab_file, merges_file)
        docs = [tok.encode(d) for d in raw_docs]
        eos = tok.eos_id if tok.eos_id is not None else EOS_ID
        return pack_token_docs(docs, seq_len, bos_id=eos, eos_id=eos)
    docs = [tokenize_bytes(d.encode("utf-8")) for d in raw_docs]
    return pack_token_docs(docs, seq_len)

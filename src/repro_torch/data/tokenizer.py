"""Deterministic byte-level tokenizer.

Offline container -> no pretrained BPE; a byte tokenizer is exact,
reversible, and enough for the rule-based math rewards the paper uses
(GSM8K-style answer extraction)."""
from __future__ import annotations


class Tokenizer:
    PAD = 0
    BOS = 1
    EOS = 2
    _SPECIALS = 3

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 256 + self._SPECIALS, "byte tokenizer needs >= 259"
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        ids = [b + self._SPECIALS for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        # ids >= 256 + _SPECIALS can occur when models sample from an
        # inflated vocab (configs keep the source model's vocab size);
        # they decode to nothing, like specials.
        bs = bytes(b for b in (int(i) - self._SPECIALS for i in ids)
                   if 0 <= b < 256)
        return bs.decode("utf-8", errors="replace")

"""Bit-packing of TLA+ message records into non-negative int32 words.

Counterpart of ``raft_tpu/ops/packing.py``: the same field layout, so a
record packed here is bit-identical to the reference's. Words are 30-bit,
so every word stays non-negative in an int32 lane and the EMPTY sentinel
(1 << 30) sorts after every real key. Works on plain ints and on torch
integer tensors (pure arithmetic).
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 30
EMPTY = 1 << WORD_BITS  # sentinel word for unused message slots


class WidePacker:
    """Packs a fixed schema of small unsigned fields into an n_words
    tuple: fields low-bit-first in declaration order, a field that would
    straddle a 30-bit word boundary bumped to the next word."""

    def __init__(self, fields: list[tuple[str, int]], n_words: int):
        self.n_words = n_words
        self.fields: dict[str, tuple[int, int]] = {}  # name -> (offset, bits)
        off = 0
        for name, bits in fields:
            if bits <= 0:
                raise ValueError(f"field {name} has non-positive width")
            word, in_word = divmod(off, WORD_BITS)
            if in_word + bits > WORD_BITS:  # would straddle: bump to next word
                off = (word + 1) * WORD_BITS
            if off + bits > n_words * WORD_BITS:
                raise ValueError(
                    f"message schema exceeds {n_words * WORD_BITS} bits"
                )
            self.fields[name] = (off, bits)
            off += bits
        self.total_bits = off

    def locate(self, name: str) -> tuple[int, int, int]:
        """(word index, shift within the word, bit mask) of a field."""
        off, bits = self.fields[name]
        word, in_word = divmod(off, WORD_BITS)
        return word, in_word, (1 << bits) - 1

    def pack(self, **vals) -> tuple:
        """Pack named field values into an n_words tuple (missing = 0)."""
        unknown = set(vals) - set(self.fields)
        if unknown:
            raise KeyError(f"unknown message fields {unknown}")
        words = [0] * self.n_words
        for name, v in vals.items():
            off, bits = self.fields[name]
            if isinstance(v, (int, np.integer)):
                if v < 0 or v >= (1 << bits):
                    raise ValueError(f"{name}={v} out of range for {bits} bits")
                v = int(v)
            word, in_word = divmod(off, WORD_BITS)
            words[word] = words[word] + (v << in_word)
        return tuple(words)

    def unpack(self, words, name: str):
        word, in_word, mask = self.locate(name)
        return (words[word] >> in_word) & mask

    def unpack_all(self, words) -> dict:
        return {name: self.unpack(words, name) for name in self.fields}

    def replace(self, words, name: str, value) -> tuple:
        word, in_word, mask = self.locate(name)
        out = list(words)
        out[word] = (out[word] & ~(mask << in_word)) | (value << in_word)
        return tuple(out)


class BitPacker:
    """Two-word packer behind the (hi, lo) API: a ``WidePacker(fields,
    2)`` whose word 0 is ``lo`` and word 1 is ``hi``."""

    def __init__(self, fields: list[tuple[str, int]]):
        self._w = WidePacker(fields, 2)
        self.fields = self._w.fields
        self.total_bits = self._w.total_bits

    def locate(self, name: str) -> tuple[int, int, int]:
        """(word, shift, mask) with word 0 = lo and 1 = hi."""
        return self._w.locate(name)

    def pack(self, **vals):
        lo, hi = self._w.pack(**vals)
        return hi, lo

    def unpack(self, hi, lo, name: str):
        return self._w.unpack((lo, hi), name)

    def unpack_all(self, hi, lo) -> dict:
        return self._w.unpack_all((lo, hi))

    def replace(self, hi, lo, name: str, value):
        lo2, hi2 = self._w.replace((lo, hi), name, value)
        return hi2, lo2


def bits_for(max_value: int) -> int:
    """Width needed to store values in [0, max_value]."""
    return max(1, int(max_value).bit_length())

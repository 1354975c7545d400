"""Tokenizers.

A copy of ``vietnamese_qa_system_tpu/data/tokenizer.py``, carried into the
port so that nothing here imports the JAX package; the parity tests hold
the token ids bit-identical to it.  ``batch_encode`` runs in Python, with
the truncation rule of the JAX package's native byte codec.

Capability of the reference's `AutoTokenizer.from_pretrained` + special-token
setup (reference src/data/dataloader.py:176-194).  Two implementations:

- ``ByteTokenizer`` — self-contained UTF-8 byte-level tokenizer with special
  tokens; fully deterministic, no downloads (the environment has no network
  egress), and handles Vietnamese diacritics exactly since it never splits
  meaning across normalization.  Default everywhere in-repo.
- ``HFTokenizer`` — thin adapter around a locally available `transformers`
  tokenizer directory for users who have one on disk.

Both expose the same minimal protocol: ``encode``, ``decode``, ``vocab_size``,
``pad_id``, ``eos_id``, ``bos_id``.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted by the number of special tokens.

    ids: 0=pad, 1=bos, 2=eos, 3=unk(unused), bytes at 4..259.
    """

    N_SPECIAL = 4

    def __init__(self):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.unk_id = 3
        self.vocab_size = 256 + self.N_SPECIAL

    def encode(self, text: str, *, add_bos: bool = False, add_eos: bool = False):
        ids = [b + self.N_SPECIAL for b in text.encode("utf-8")]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside the byte range (e.g. from a model whose vocab is
        # padded beyond 260) are dropped rather than crashing the decode
        data = bytes(
            i - self.N_SPECIAL
            for i in ids
            if self.N_SPECIAL <= i < self.vocab_size
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Adapter for a transformers tokenizer loaded from a LOCAL path."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # host-side, lazy

        self._tok = AutoTokenizer.from_pretrained(path)
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.eos_token
        self.vocab_size = len(self._tok)

        def _id(value, fallback):
            # explicit None check: id 0 is a legitimate special token
            # (pythia/GPT-NeoX put <|endoftext|> at 0) and `or` would
            # silently replace it with the fallback
            return fallback if value is None else value

        self.pad_id = _id(self._tok.pad_token_id, 0)
        self.bos_id = _id(self._tok.bos_token_id, self.pad_id)
        self.eos_id = _id(self._tok.eos_token_id, self.pad_id)

    def encode(self, text: str, *, add_bos: bool = False, add_eos: bool = False):
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids):
        return self._tok.decode([i for i in ids if i != self.pad_id])


def batch_encode(
    tok,
    texts: Sequence[str],
    max_len: int,
    *,
    pad_side: str = "right",
    add_eos: bool = False,
):
    """Encode + truncate + pad to a fixed (len(texts), max_len) int32 batch.

    Static shapes by construction — the TPU-side replacement for the
    reference's dynamic per-batch padding (reference
    src/data/dataloader.py:366-412).  Returns (ids, attention_mask) numpy.
    """
    import numpy as np

    ids = np.full((len(texts), max_len), tok.pad_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    for r, text in enumerate(texts):
        if add_eos and isinstance(tok, ByteTokenizer):
            # the JAX package encodes bytes in its native codec, which keeps
            # the EOS slot when it truncates (native/byte_codec.cpp)
            seq = tok.encode(text)[: max_len - 1] + [tok.eos_id]
        else:
            seq = tok.encode(text, add_eos=add_eos)[:max_len]
        if pad_side == "right":
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
        else:
            ids[r, max_len - len(seq):] = seq
            mask[r, max_len - len(seq):] = 1
    return ids, mask

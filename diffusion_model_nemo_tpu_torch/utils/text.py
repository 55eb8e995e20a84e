"""Byte-level tokenizer for text conditioning.

Counterpart of ``diffusion_model_nemo_tpu/utils/text.py``: no downloaded
vocabulary; a token is a UTF-8 byte plus 1, so id 0 is PAD (``vocab_size``
257). The DiT embeds these ids; its attention mask is ``tokens != 0`` with
position 0 always set, so an all-PAD row attends to the PAD embedding alone,
the classifier-free "null context" (``models/text_conditional_ddpm.py``).
``encode`` cuts at ``max_len`` bytes, which can split a multi-byte
character; ``decode`` then replaces the broken tail (``errors="replace"``).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """UTF-8 bytes + 1; id 0 = PAD. ``vocab_size`` = 257."""

    PAD = 0
    vocab_size = 257

    def __init__(self, max_len: int = 32):
        self.max_len = int(max_len)

    def encode(self, text: str) -> np.ndarray:
        """One string → ``[max_len]`` int32 (cut at ``max_len`` bytes, PAD-padded)."""
        ids = np.frombuffer(str(text).encode("utf-8"), dtype=np.uint8)[: self.max_len]
        out = np.zeros((self.max_len,), np.int32)
        out[: ids.size] = ids.astype(np.int32) + 1
        return out

    def encode_batch(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """Strings (or one string) → ``[N, max_len]`` int32."""
        if isinstance(texts, str):
            texts = [texts]
        return np.stack([self.encode(t) for t in texts])

    def decode(self, tokens) -> str:
        ids = np.asarray(tokens).reshape(-1)
        return bytes(int(i) - 1 for i in ids if int(i) > 0).decode("utf-8", errors="replace")

    def null(self, batch_size: int = 1) -> np.ndarray:
        """All-PAD rows ``[batch_size, max_len]``: the null context of guidance."""
        return np.zeros((batch_size, self.max_len), np.int32)

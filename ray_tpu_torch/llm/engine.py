"""Generation settings and the byte tokenizer.

Port of ``GenerationConfig`` and ``ByteTokenizer`` from
``ray_tpu/llm/engine.py``. The dense-cache ``LLMEngine`` waits for a later
slice; ``llm/continuous.py`` serves the model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = no top-k filter
    seed: int = 0
    eos_token: Optional[int] = None


class ByteTokenizer:
    """Self-contained byte-level tokenizer (no external vocab files)."""

    vocab_size = 256 + 2
    bos = 256
    eos = 257

    def encode(self, text: str) -> List[int]:
        return [self.bos] + list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")

"""Batch inference processor: rows with a "prompt" column through
``LLMEngine``.

Port of ``ray_tpu/llm/processor.py``. ``process`` maps a
``ray_tpu_torch.data.Dataset`` through ``map_batches``: each batch is a
dict of numpy columns, and the result gains a "generated_text" column (a
dict result becomes an Arrow block, so this path needs pyarrow, as the
reference's does). The engine is built on first use in the process that
runs the batches, on ``device`` there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from .._device import DeviceLike
from .engine import GenerationConfig, LLMEngine


@dataclass
class LLMProcessor:
    model_config: Any                       # models.transformer.ModelConfig
    params: Optional[Any] = None
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    batch_size: int = 16
    max_len: int = 256
    device: DeviceLike = None

    def process(self, dataset):
        """dataset rows: {"prompt": str, ...} -> adds "generated_text"."""
        cfg, params, gen = self.model_config, self.params, self.generation
        max_len, device = self.max_len, self.device
        engine_holder: Dict[str, LLMEngine] = {}

        def infer(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            # one engine per process, reused across blocks
            if "engine" not in engine_holder:
                engine_holder["engine"] = LLMEngine(cfg, params, max_len=max_len,
                                                    device=device)
            prompts = [str(p) for p in batch["prompt"]]
            out = dict(batch)
            out["generated_text"] = np.array(engine_holder["engine"].generate(prompts, gen),
                                             dtype=object)
            return out

        return dataset.map_batches(infer, batch_size=self.batch_size)

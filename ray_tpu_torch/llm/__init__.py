"""LLM batch inference and serving engines (port of ``ray_tpu/llm/``):
the KV-cache engines on the flagship model, batch inference as a
processor stage, and serving as a Serve deployment
(``build_llm_deployment``)."""
from .continuous import ContinuousBatchingEngine, PagedKVPool  # noqa: F401
from .engine import GenerationConfig, LLMEngine  # noqa: F401
from .processor import LLMProcessor  # noqa: F401
from .serving import build_llm_deployment  # noqa: F401

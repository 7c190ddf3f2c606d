"""LLM batch inference and serving engines (port of ``ray_tpu/llm/``).

``build_llm_deployment`` (``llm/serving.py``) waits for the port's
``serve/`` deployments and router.
"""
from .continuous import ContinuousBatchingEngine, PagedKVPool  # noqa: F401
from .engine import GenerationConfig, LLMEngine  # noqa: F401
from .processor import LLMProcessor  # noqa: F401

"""LLM serving (port of ``ray_tpu/llm/``)."""

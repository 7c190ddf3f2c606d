"""The local runtime (port of ``ray_tpu/core/``): tasks, actors, objects and
placement groups in one process, every placement made by the batched
scheduler programs on the card."""

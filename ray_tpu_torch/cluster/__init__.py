"""The cluster runtime's shared modules (port of ``ray_tpu/cluster/``).

Only what the local runtime calls is ported so far: ``common.py``
(``new_id``, ``stream_item_id``) and ``pip_env.py`` (``has_env``). The
head, agents, workers, client and transport wait for the cluster runtime.
"""

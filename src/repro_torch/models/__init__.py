"""The LLM host workloads the sketches ride in (port of ``repro/models``).

Every family: attention (dense, vlm, audio: ``attention``), MoE
(``moe``), the RG-LRU hybrid (``rglru`` with local attention) and RWKV6
(``rwkv6``), on ``common``, ``transformer`` and ``registry``.
"""

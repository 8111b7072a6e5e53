"""The LLM host workloads the sketches ride in (port of ``repro/models``).

The attention families (dense, vlm, audio: ``attention``) and the RWKV6
family (``rwkv6``), on ``common``, ``transformer`` and ``registry``.  MoE
and RG-LRU come with ROADMAP A.12.1's next slice.
"""

"""The LLM host workloads the sketches ride in (port of ``repro/models``).

So far the RWKV6 family: ``common``, ``rwkv6``, ``transformer`` and
``registry``.  Attention, MoE and RG-LRU come with ROADMAP A.12's next
slices.
"""

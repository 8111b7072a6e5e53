"""Serving (port of ``repro/serve``): the prefill/decode engine, the int8
KV cache (``kvquant``), continuous batching (``scheduler``) and the
coalescing ingest path."""

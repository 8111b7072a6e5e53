"""Serving (port of ``repro/serve``): the prefill/decode engine and the
coalescing ingest path."""

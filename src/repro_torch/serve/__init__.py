"""Serving (port of ``repro/serve``): so far the prefill/decode engine."""

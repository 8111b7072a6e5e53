"""The bytes a call's work needs, one module a system: ``<system>.py``'s ``call_bytes(config, traffic)``."""

"""Per-layer metric readers, found by name: metric ``<family>.<part>`` is read by ``<family>.py``."""

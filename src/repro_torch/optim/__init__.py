"""AdamW, its schedule, clipping and int8 error feedback (port of ``repro/optim``)."""

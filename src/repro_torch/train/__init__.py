"""Training: state, the eager step, the watchdog and the restartable loop (port of ``repro/train``)."""

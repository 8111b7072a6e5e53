"""Launchers (port of ``repro/launch``): so far the serve driver."""

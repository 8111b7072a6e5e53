"""Launchers (port of ``repro/launch``): the serve driver and the device meshes."""

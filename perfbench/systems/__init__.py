"""Drivers of the systems under test, one module a system, found by the configuration's ``system``."""

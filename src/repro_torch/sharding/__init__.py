"""Partition rules: FSDP/TP/EP/sequence-parallel specs."""

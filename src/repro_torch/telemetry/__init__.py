"""First-class streaming-statistics layer (the paper's sketch on the datapath).

Port of ``repro/telemetry``: ``StreamSketch``, the telemetry board.
"""

from repro_torch.telemetry.sketchboard import StreamSketch  # noqa: F401

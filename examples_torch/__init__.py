"""The repo's five examples on the PyTorch/CUDA port, one file per file of
``examples/``: ``quickstart``, ``stream_cardinality``, ``serve_lm``,
``train_lm`` and ``elastic_rescale``.  Each runs on the card by default and
on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples_torch/stream_cardinality.py [--device cpu]

Each ``main(argv)`` prints the reference example's lines and returns what
it printed, with the state behind it.
"""

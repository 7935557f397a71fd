"""Runnable examples of the port, twins of the JAX package's
``examples/quickstart.py`` and ``examples/proteus_layout_demo.py``:
``python -m repro_torch.examples.quickstart`` (tables on the card;
``--device cpu`` for the plain path)."""

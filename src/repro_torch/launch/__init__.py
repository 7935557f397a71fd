"""Entry points of the port (twin of ``repro.launch``)."""

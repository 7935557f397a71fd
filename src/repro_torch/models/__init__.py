"""Models of the port (twins of ``repro.models``): the dense decoder LM."""

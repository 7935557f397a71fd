"""The port's burst-buffer core: routing, policy, exchange planner, engine
and the ``BBClient`` facade (twins of the modules of ``repro.core``)."""

"""Training substrate of the port (twin of ``repro.train``): AdamW, the
train step and the fault-tolerant loop with Proteus checkpoints."""

"""Training of the port (port of ``repro/training``): the synthetic Markov
data stream, AdamW with its schedule, ``.npz`` checkpoints, and the loss,
train step and host loop."""

"""Training-side pieces of the port: so far the checkpoint layer (``train.checkpoint``)."""

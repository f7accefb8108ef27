"""Training-side pieces of the port: the checkpoint layer (``train.checkpoint``) and
the elastic planners (``train.elastic``)."""

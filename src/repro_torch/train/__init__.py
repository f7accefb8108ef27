"""Training side of the port: the train loop (``train.loop.train``), the
checkpoint layer (``train.checkpoint``) and the elastic planners
(``train.elastic``)."""

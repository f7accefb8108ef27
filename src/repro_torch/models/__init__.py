"""The port's models: the dense decoder's building blocks (``layers``), its
attention (``attention``), the decoder itself (``transformer``) and the
registry (``registry.build_model``).  Parameters are the reference's nested
dicts of tensors, with the decoder's layers stacked on a leading
``n_layers`` axis.  MoE, MLA, SSM, RWKV, hybrid and encoder-decoder models,
prefill and decode wait for ROADMAP A9."""

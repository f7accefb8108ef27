"""The port's models: building blocks (``layers``), attention with its KV
cache (``attention``), MLA (``mla``), MoE (``moe``), Mamba2 (``ssm``), the
decoder (``transformer``: dense, VLM, MoE and MLA configs), the Zamba2 hybrid
(``hybrid``), RWKV-6 (``rwkv`` blocks, ``rwkv_model``), the Whisper-style
encoder-decoder (``encdec``) and the registry (``registry.build_model``),
each with its train path, prefill and decode.  Parameters are the
reference's nested dicts of tensors, with the layers stacked on leading
axes."""

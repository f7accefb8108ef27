"""The port's optimizers: AdamW (``adamw``), the warmup-cosine schedule
(``schedule``), and the paper's technique as optimizer features: the
streaming-SVD gradient tracker (``spectral``), spectral-Adam
(``spectral_adam``) and the low-rank compressed all-reduce
(``compression``)."""

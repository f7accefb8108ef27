"""``repro_torch``: the rank-1 SVD update system in PyTorch, with hand-written
CUDA kernels for an H100 (``sm_90a``).

It mirrors the JAX package ``repro`` (the reference) module by module and
imports none of it.  ``api.update`` / ``api.update_many`` (rank-1 events) and
``api.apply`` / ``api.apply_many`` (structured updates, ``updates``) run where
the state lives; the state constructors default to ``device="cuda"``.
``serve.SvdService`` is the streaming service over them, with ``obs``
(metrics, spans, health probes), ``dist`` (the device mesh, the merge and
the collectives) and ``train.checkpoint`` (the snapshots' on-disk layout)
beneath it; ``fleet.SvdFleet`` partitions a population of streams over many
services.
"""

from repro_torch import api, convert, updates  # noqa: F401

__all__ = ["api", "convert", "updates"]

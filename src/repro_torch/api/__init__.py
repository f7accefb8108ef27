"""``repro_torch.api``: the port's public surface.

    from repro_torch import api

    state  = api.SvdState.from_dense(a_mat)           # on the card by default
    state  = api.update(state, a, b)                  # SVD of A + a b^T
    states = api.update_many(states, A_vecs, B_vecs)  # grouped and batched
    state  = api.apply(state, op)                     # structured update (repro_torch.updates)
    states = api.apply_many(states, ops)              # same-plan groups batched
    api.warmup(policy, m=512, n=768, rank=16, batch=16)   # ready a route before traffic

The same calls on the CPU, where every route runs its plain PyTorch version:

>>> import numpy as np
>>> from repro_torch import api
>>> rng = np.random.default_rng(0)
>>> x = rng.normal(size=(5, 7))
>>> state = api.SvdState.from_dense(x, rank=3, device="cpu")
>>> a, b = rng.normal(size=5), rng.normal(size=7)
>>> out = api.update(state, a, b, api.UpdatePolicy(method="direct"))
>>> out.shape, out.rank, str(out.device)
((5, 7), 3, 'cpu')

Docstrings on this surface carry runnable ``>>>`` examples;
``tests/test_torch_docs.py`` runs them.
"""

from repro_torch.api.cache import compilation_cache_entries, enable_compilation_cache

from repro_torch.api.policy import METHODS, UpdatePolicy
from repro_torch.api.state import SvdState, as_state
from repro_torch.api.update import (
    apply,
    apply_many,
    engine_for,
    update,
    update_many,
    update_rank_k,
    warmup,
)

__all__ = [
    "METHODS",
    "SvdState",
    "UpdatePolicy",
    "apply",
    "apply_many",
    "as_state",
    "compilation_cache_entries",
    "enable_compilation_cache",
    "engine_for",
    "update",
    "update_many",
    "update_rank_k",
    "warmup",
]

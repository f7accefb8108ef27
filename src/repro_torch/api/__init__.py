"""``repro_torch.api``: the port's public surface.

    from repro_torch import api

    state  = api.SvdState.from_dense(a_mat)           # on the card by default
    state  = api.update(state, a, b)                  # SVD of A + a b^T
    states = api.update_many(states, A_vecs, B_vecs)  # grouped and batched
"""

from repro_torch.api.policy import METHODS, UpdatePolicy
from repro_torch.api.state import SvdState, as_state
from repro_torch.api.update import (
    apply,
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
    "as_state",
    "engine_for",
    "update",
    "update_many",
    "update_rank_k",
    "warmup",
]

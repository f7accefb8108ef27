"""The plain rank-1 truncated SVD update (Brand's augmentation with a dense
SVD of the small core) and a stream's replay of its events.

For a rank-r SVD ``U diag(s) V^T`` and a pair (a, b), the updated state is
the best rank-r approximation of ``U diag(s) V^T + a b^T``: with
p = U^T a, a_perp = a - U p, P = a_perp / |a_perp| (and likewise q, Q for b),
the matrix is ``[U P] K [V Q]^T`` with the (r+1) x (r+1) core
``K = diag(s, 0) + [p; |a_perp|] [q; |b_perp|]^T``; its SVD ``K = G S H^T``
gives ``[U P] G[:, :r]``, ``S[:r]``, ``[V Q] H[:, :r]``.  The core's SVD is
LAPACK's (``torch.linalg.svd``), not the secular equation the port solves.
"""

from __future__ import annotations

import torch

# a residual at or below this norm adds no direction (the port's rule)
RESIDUAL_FLOOR = 1e-12


def _residual(basis, x):
    p = torch.einsum("bmr,bm->br", basis, x)
    perp = x - torch.einsum("bmr,br->bm", basis, p)
    nrm = torch.linalg.vector_norm(perp, dim=1)
    ok = nrm > RESIDUAL_FLOOR
    unit = torch.where(ok[:, None], perp / torch.where(ok, nrm, 1.0)[:, None], 0.0)
    return p, unit, torch.where(ok, nrm, 0.0)


def truncated_update(u, s, v, a, b, core_dtype=None):
    """One update of B stacked states: ``u (B, m, r)``, ``s (B, r)``,
    ``v (B, n, r)``, ``a (B, m)``, ``b (B, n)``; the core's SVD runs in
    ``core_dtype`` (the states' dtype by default)."""
    r = s.shape[1]
    p, pu, ra = _residual(u, a)
    q, qu, rb = _residual(v, b)
    cd = core_dtype or u.dtype
    x = torch.cat([p, ra[:, None]], dim=1).to(cd)
    y = torch.cat([q, rb[:, None]], dim=1).to(cd)
    k = torch.diag_embed(torch.cat([s.to(cd), torch.zeros_like(s[:, :1], dtype=cd)], dim=1))
    k = k + x[:, :, None] * y[:, None, :]
    g, sk, ht = torch.linalg.svd(k)
    g, sk, h = g[:, :, :r].to(u.dtype), sk[:, :r].to(u.dtype), ht.mT[:, :, :r].to(u.dtype)
    return (torch.cat([u, pu[:, :, None]], dim=2) @ g, sk,
            torch.cat([v, qu[:, :, None]], dim=2) @ h)


def replay(u, s, v, pool_a, pool_b, indices, dtype=None):
    """Each of B streams' states after its events, in order: stream ``i``
    applies ``(pool_a[j], pool_b[j])`` for ``j`` in ``indices[i]`` (lists may
    differ in length).  Computed in ``dtype`` (the states' by default)."""
    dt = dtype or u.dtype
    u, s, v = u.to(dt).clone(), s.to(dt).clone(), v.to(dt).clone()
    pool_a, pool_b = pool_a.to(dt), pool_b.to(dt)
    longest = max(len(ix) for ix in indices)
    for j in range(longest):
        live = [i for i, ix in enumerate(indices) if j < len(ix)]
        sel = torch.tensor(live, device=u.device)
        idx = torch.tensor([int(indices[i][j]) for i in live], device=u.device)
        nu, ns, nv = truncated_update(u[sel], s[sel], v[sel], pool_a[idx], pool_b[idx])
        u[sel], s[sel], v[sel] = nu, ns, nv
    return u, s, v


def gaps(got, want) -> dict:
    """Over B states, each against its reference: the largest entry of
    ``U diag(s) V^T`` off by most, and the largest singular value off by
    most, both over the reference's largest singular value; the worst state.
    Computed in float64."""
    (gu, gs, gv), (wu, ws, wv) = ([x.double() for x in t] for t in (got, want))
    scale = ws[:, 0]
    recon = ((gu * gs[:, None, :]) @ gv.mT - (wu * ws[:, None, :]) @ wv.mT).abs().amax(dim=(1, 2))
    sigma = (gs - ws).abs().amax(dim=1)
    return {"recon": float((recon / scale).max()), "sigma": float((sigma / scale).max())}

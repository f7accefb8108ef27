"""``repro_torch.dist.collectives`` and ``distributed_merge`` on
``torch.distributed``, in gloo worlds of 2 and 4 CPU processes.

Each world is started once per module (``torch.multiprocessing``, spawn)
through a file store under the test's tmp dir: TCP ports collide when test
workers run in parallel, a file store does not.  Every rank runs all the
checks once (``_torch_dist_worker.run``) and each join has its own timeout.
The reference's collectives need a ``shard_map`` over a device mesh; its
``merge_tree`` over the same shards is the oracle of the merge.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax.numpy as jnp

import _torch_dist_worker as W
from _torch_helpers import ref
from repro_torch.api import SvdState
from repro_torch.core.svd_update import TruncatedSvd
from repro_torch.dist import all_gather_tsvd, distributed_merge, merge_tree, pmean_factor, psum_factor

RMERGE = ref("dist.merge")
RTSVD = ref("core.svd_update").TruncatedSvd

JOIN_TIMEOUT_S = 120


def _world(tmp_path_factory, world: int) -> list[dict]:
    out = tmp_path_factory.mktemp(f"gloo{world}")
    init = f"file://{out / 'store'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, world, init, str(out))) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(timeout=10)
    assert not alive, f"{len(alive)} of {world} gloo ranks did not finish in {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    results = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(params=[2, 4])
def results(request):
    return request.getfixturevalue(f"world{request.param}")


def test_pmean_and_psum_are_the_mean_and_sum(results):
    stacked = np.stack([W.factor(r) for r in range(len(results))])
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["pmean"], stacked.mean(0), rtol=0, atol=1e-15)
        np.testing.assert_allclose(res["psum"], stacked.sum(0), rtol=0, atol=1e-14)
        np.testing.assert_array_equal(res["x_after"], W.factor(r))   # the input is untouched
    for res in results[1:]:
        np.testing.assert_array_equal(res["psum"], results[0]["psum"])
        np.testing.assert_array_equal(res["pmean"], results[0]["pmean"])


def test_all_gather_tsvd_stacks_workers_in_rank_order(results):
    world = len(results)
    for res in results:
        assert str(res["gather_type"]) == "SvdState"
        for i, f in enumerate(("u", "s", "v")):
            got = res[f"gathered_{f}"]
            assert got.shape[0] == world
            np.testing.assert_array_equal(got, np.stack([W.shard(r)[i] for r in range(world)]))


def test_distributed_merge_same_bits_everywhere_and_matches_merge_tree(results):
    """Every rank ends with the same bits, those of the port's merge_tree
    over the gathered shards, within 1e-10 of the reference's merge_tree."""
    world = len(results)
    shards = [TruncatedSvd(*(torch.as_tensor(x) for x in W.shard(r))) for r in range(world)]
    local = merge_tree(shards, rank=W.R)
    want = RMERGE.merge_tree([RTSVD(*(jnp.asarray(x) for x in W.shard(r))) for r in range(world)],
                             rank=W.R)
    for res in results:
        assert str(res["merged_type"]) == "TruncatedSvd"
        for f in ("u", "s", "v"):
            np.testing.assert_array_equal(res[f"merged_{f}"], results[0][f"merged_{f}"])
            np.testing.assert_array_equal(res[f"merged_{f}"], getattr(local, f).numpy())
    got = results[0]
    recon = lambda u, s, v: np.asarray(u) * np.asarray(s) @ np.asarray(v).T  # noqa: E731
    np.testing.assert_allclose(got["merged_s"], np.asarray(want.s), rtol=0, atol=1e-10)
    np.testing.assert_allclose(recon(got["merged_u"], got["merged_s"], got["merged_v"]),
                               recon(want.u, want.s, want.v), rtol=0, atol=1e-10)


def test_no_group_is_the_single_worker():
    x = torch.as_tensor(W.factor(0))
    assert pmean_factor(x, None) is x and psum_factor(x, None) is x
    local = SvdState(*(torch.as_tensor(a) for a in W.shard(0)))
    g = all_gather_tsvd(local, None)
    assert isinstance(g, SvdState) and tuple(g.u.shape) == (1, W.M, W.R)
    assert torch.equal(g.s[0], local.s)
    merged = distributed_merge(local, None)
    for f in ("u", "s", "v"):
        assert torch.equal(getattr(merged, f), getattr(local, f))

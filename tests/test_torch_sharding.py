"""The model side of sharding in the port against the reference: the
shape-only init, ``param_pspecs``, ``cache_pspecs``, ``gather_for_compute``,
``train.elastic.reshard``, ``train(mesh=)`` and MoE's shard constraints.

* ``api.init(None, device="meta")`` equals ``jax.eval_shape(api.init, key)``
  leaf for leaf (path, shape, dtype) for all ten configs at full size, and
  the parameter specs equal the reference's ``PartitionSpec``s as tuples,
  every sharded axis divisible by the production axis sizes.
* The cache specs equal the reference's on every decode shape's cache from
  ``input_specs``, under both ``multi_pod`` values and ``long_context`` with
  and without ``seq_shard_fallback``.
* ``gather_for_compute`` equals the reference's outside a mesh, to the bit.
* ``reshard`` after a checkpoint round trip gives the parameters to the bit,
  and refuses a mesh whose axis sizes do not divide a sharded axis.
* ``train(mesh=make_host_mesh(4, 2, device="cpu"))`` against the reference's
  ``train`` under a mesh of one device (its GSPMD step keeps the unsharded
  math; on jax 0.9 its mesh of more than one device fails: ROADMAP queue C)
  from one init, a dense and an MoE smoke config, at the reference's own
  limits (tests/test_dist.py: 1e-5 on the loss, 1e-4 on the parameters).
  ``spectral_rank > 0`` with a mesh raises the reference's ``ValueError`` in
  both; an uneven batch and MoE groups a slice cannot hold whole raise in
  the port (the reference's jit raises the first).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch import convert
from repro_torch._tree import flatten_up_to, tree_flatten_with_names, tree_leaves
from repro_torch.configs.base import OptimizerConfig, RunConfig
from repro_torch.dist import AXIS_SIZES, cache_pspecs, gather_for_compute, make_host_mesh
from repro_torch.dist import param_pspecs
from repro_torch.models import moe as PMOE
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as PCK
from repro_torch.train import loop as PLOOP
from repro_torch.train.elastic import plan_mesh, reshard

RCFG = ref("configs")
RBASE = ref("configs.base")
RCK = ref("train.checkpoint")
RLOOP = ref("train.loop")
RREG = ref("models.registry")
RMOE = ref("models.moe")
ROPT = ref("optim.adamw")
RSH = ref("dist.sharding")

ARCHS = PCFG.ARCH_IDS
DECODE_SHAPES = [n for n, s in PCFG.SHAPES.items() if s.kind == "decode"]


def _tuples(spec_tree):
    """The reference's spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.fixture(scope="module")
def shapes():
    """Per arch: the port's meta tree and the reference's ``eval_shape``."""
    out = {}
    for arch in ARCHS:
        port = build_model(PCFG.get(arch)).init(None, device="meta")
        refs = jax.eval_shape(RREG.build_model(RCFG.get(arch)).init, jax.random.PRNGKey(0))
        out[arch] = (port, refs)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_eval_shape(shapes, arch):
    port, refs = shapes[arch]
    names, leaves = tree_flatten_with_names(port)
    rflat = jax.tree_util.tree_flatten_with_path(refs)[0]
    assert names == [jax.tree_util.keystr(p) for p, _ in rflat]
    for name, leaf, (_, r) in zip(names, leaves, rflat):
        assert leaf.device.type == "meta", name
        assert tuple(leaf.shape) == tuple(r.shape), name
        assert _dtype_name(leaf.dtype) == str(r.dtype), name


def test_shape_only_init_refusals():
    api = build_model(PCFG.get_smoke("granite-34b"))
    with pytest.raises(ValueError, match="gen=None builds shapes only, on device='meta'"):
        api.init(None, device="cpu")
    with pytest.raises(ValueError, match="pass gen=None with device='meta'"):
        api.init(torch.Generator(), device="meta")
    drawn = api.init(torch.Generator().manual_seed(0), device="cpu")
    meta = api.init(device="meta")
    assert [(x.shape, x.dtype) for x in tree_leaves(drawn)] == \
        [(x.shape, x.dtype) for x in tree_leaves(meta)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(shapes, arch):
    port, refs = shapes[arch]
    p_specs = param_pspecs(port)
    assert p_specs == _tuples(RSH.param_pspecs(refs))
    for name, leaf, spec in zip(tree_flatten_with_names(port)[0], tree_leaves(port),
                                flatten_up_to(port, p_specs)):
        for dim, ax in zip(leaf.shape, spec):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                assert dim % int(np.prod([AXIS_SIZES[a] for a in axes])) == 0, (name, spec)
    assert any(spec for spec in flatten_up_to(port, p_specs))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_reference(arch):
    p_api, r_api = build_model(PCFG.get(arch)), RREG.build_model(RCFG.get(arch))
    for shape_name in DECODE_SHAPES:
        p_cache = p_api.input_specs(PCFG.SHAPES[shape_name])["cache"]
        r_cache = r_api.input_specs(RBASE.SHAPES[shape_name])["cache"]
        for multi_pod in (False, True):
            for long_context, fallback in ((False, True), (True, True), (True, False)):
                kw = dict(multi_pod=multi_pod, long_context=long_context,
                          seq_shard_fallback=fallback)
                assert cache_pspecs(p_cache, **kw) == _tuples(RSH.cache_pspecs(r_cache, **kw)), \
                    (shape_name, kw)


def _smoke_arrays(arch, seed):
    """A smoke config's parameters as numpy arrays, from one seed."""
    refs = jax.eval_shape(RREG.build_model(RCFG.get_smoke(arch)).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), refs)


def test_gather_for_compute_equals_reference_to_the_bit():
    arrays = _smoke_arrays("deepseek-v2-lite-16b", 0)
    arrays["step"] = np.int32(7)
    got = gather_for_compute(convert.params_from_reference(arrays, device="cpu"), "bfloat16")
    want = RSH.gather_for_compute(jax.tree.map(jnp.asarray, arrays), "bfloat16")
    for name, x, (_, w) in zip(tree_flatten_with_names(got)[0], tree_leaves(got),
                               jax.tree_util.tree_flatten_with_path(want)[0]):
        w = np.asarray(w)
        assert _dtype_name(x.dtype) == str(w.dtype), name
        if x.dtype == torch.bfloat16:
            assert np.array_equal(x.view(torch.int16).numpy(), w.view(np.int16)), name
        else:
            assert np.array_equal(x.numpy(), w), name


def test_reshard_after_a_checkpoint_round_trip_is_bitwise(tmp_path):
    """The counterpart of tests/test_serve_system.py::test_elastic_remesh_roundtrip."""
    api = build_model(PCFG.get_smoke("qwen1.5-32b"))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    PCK.save(tmp_path, 1, params)
    _, restored = PCK.restore(tmp_path, params)
    for mesh in (plan_mesh(max_model=1, device="cpu"), make_host_mesh(4, 2, device="cpu")):
        placed = reshard(restored, mesh)
        for a, b in zip(tree_leaves(params), tree_leaves(placed)):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
    with pytest.raises(ValueError, match="does not evenly divide the dimension size 512"):
        reshard(restored, make_host_mesh(3, 1, device="cpu"))


# -- train(mesh=) ---------------------------------------------------------------

BATCH, SEQ, STEPS = 8, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MOE_GROUP = 32     # 128 tokens: 4 groups, one whole group a slice of a 4-entry data axis


def _cfgs(arch):
    p, r = PCFG.get_smoke(arch), RCFG.get_smoke(arch)
    if p.moe is not None:
        p = p.replace(moe=p.moe.__class__(**{**p.moe.__dict__, "group_size": MOE_GROUP}))
        r = r.replace(moe=r.moe.__class__(**{**r.moe.__dict__, "group_size": MOE_GROUP}))
    return p, r


def _runs(arch, directory, steps=STEPS, spectral_rank=0):
    p_cfg, r_cfg = _cfgs(arch)
    common = dict(steps=steps, log_every=1, checkpoint_every=100, checkpoint_dir=str(directory),
                  seed=0)
    return (RBASE.RunConfig(model=r_cfg, optimizer=RBASE.OptimizerConfig(
                spectral_rank=spectral_rank, **OPT), **common),
            RunConfig(model=p_cfg, optimizer=OptimizerConfig(spectral_rank=spectral_rank, **OPT),
                      **common))


def _init_dir(arch, d):
    """The reference's init (params, AdamW state) as a step-0 checkpoint."""
    params = RREG.build_model(_cfgs(arch)[1]).init(jax.random.PRNGKey(0))
    RCK.save(d, 0, (params, ROPT.adamw_init(params)))
    return d


def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-moe-16b"])
def test_train_under_a_mesh_matches_reference(arch, tmp_path):
    init = _init_dir(arch, tmp_path / "init")
    rd, pd, ld = (tmp_path / n for n in ("ref", "port", "local"))
    for d in (rd, pd, ld):
        shutil.copytree(init, d)
    r_run, _ = _runs(arch, rd)
    _, p_run = _runs(arch, pd)
    _, l_run = _runs(arch, ld)
    r_res = RLOOP.train(r_run, batch_size=BATCH, seq_len=SEQ, mesh=_ref_mesh())
    p_res = PLOOP.train(p_run, batch_size=BATCH, seq_len=SEQ, device="cpu",
                        mesh=make_host_mesh(4, 2, device="cpu"))
    l_res = PLOOP.train(l_run, batch_size=BATCH, seq_len=SEQ, device="cpu")
    losses = lambda res: np.array([v for _, v in res.losses])  # noqa: E731
    assert p_res.final_step == r_res.final_step == STEPS
    assert np.abs(losses(p_res) - losses(r_res)).max() < 1e-5
    assert np.abs(losses(p_res) - losses(l_res)).max() < 1e-5
    (_, got), (_, want), (_, local) = (PCK.restore(d, None) for d in (pd, rd, ld))
    assert len(got) == len(want) == len(local)
    for g, w, l_ in zip(got, want, local):
        assert g.shape == w.shape
        if not np.issubdtype(w.dtype, np.floating):
            assert np.array_equal(g, w)
            continue
        # the mesh against the mesh-less step: the reference's own limit
        assert np.abs(g - l_).max() < 1e-4
        # against the reference: that limit over the mesh-less port's own
        # distance, which is 0 on the dense config and 2.4e-4 on one entry of
        # the MoE config's embedding, whose gradient is ~1e-9 (Adam's update
        # g / (|g| + eps) there depends on float32 rounding; ROADMAP queue C)
        assert np.abs(g - w).max() < np.abs(l_ - w).max() + 1e-4
        if arch == "granite-34b":
            assert np.abs(g - w).max() < 1e-4


def test_spectral_with_a_mesh_raises_in_both(tmp_path):
    r_run, _ = _runs("granite-34b", tmp_path / "ref", steps=1, spectral_rank=4)
    _, p_run = _runs("granite-34b", tmp_path / "port", steps=1, spectral_rank=4)
    with pytest.raises(ValueError, match="pytree structure error"):
        RLOOP.train(r_run, batch_size=BATCH, seq_len=SEQ, mesh=_ref_mesh())
    with pytest.raises(ValueError, match="pytree structure error"):
        PLOOP.train(p_run, batch_size=BATCH, seq_len=SEQ, device="cpu",
                    mesh=make_host_mesh(4, 2, device="cpu"))


def test_an_uneven_batch_raises(tmp_path):
    _, p_run = _runs("granite-34b", tmp_path, steps=1)
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 6"):
        PLOOP.train(p_run, batch_size=6, seq_len=SEQ, device="cpu",
                    mesh=make_host_mesh(4, 1, device="cpu"))
    assert not list(tmp_path.glob("*")) or PCK.latest_step(tmp_path) is None


def test_moe_groups_a_slice_cannot_hold_raise(tmp_path):
    """At the smoke config's group_size (1024) the batch's 128 tokens make one
    group, which four slices of 32 would split into other groups."""
    run = RunConfig(model=PCFG.get_smoke("deepseek-moe-16b"), optimizer=OptimizerConfig(**OPT),
                    steps=1, log_every=1, checkpoint_every=100, checkpoint_dir=str(tmp_path),
                    seed=0)
    with pytest.raises(ValueError, match="do not fit whole in a slice of 32 tokens"):
        PLOOP.train(run, batch_size=BATCH, seq_len=SEQ, device="cpu",
                    mesh=make_host_mesh(4, 2, device="cpu"))
    # two slices of 64 tokens still split the one group of 128
    with pytest.raises(ValueError, match="slice of 64 tokens"):
        PLOOP.train(run, batch_size=BATCH, seq_len=SEQ, device="cpu",
                    mesh=make_host_mesh(2, 1, device="cpu"))


@pytest.mark.parametrize("constraints", [False, True])
def test_moe_shard_constraints_leave_the_values(constraints):
    arch = "deepseek-moe-16b"
    r_cfg = RCFG.get_smoke(arch).replace(moe_shard_constraints=constraints,
                                         compute_dtype="float32")
    p_cfg = PCFG.get_smoke(arch).replace(moe_shard_constraints=constraints,
                                         compute_dtype="float32")
    arrays = _smoke_arrays(arch, 1)
    lp = jax.tree.map(lambda x: x[0], arrays["layers"]["moe"])
    x = np.random.default_rng(2).normal(size=(2, 16, p_cfg.d_model)).astype(np.float32)
    want = np.asarray(RMOE.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), r_cfg))
    got = PMOE.moe_apply(torch.as_tensor(x), convert.params_from_reference(lp, device="cpu"),
                         p_cfg)[0]
    plain = PMOE.moe_apply(torch.as_tensor(x), convert.params_from_reference(lp, device="cpu"),
                           p_cfg.replace(moe_shard_constraints=False))[0]
    assert torch.equal(got, plain)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()

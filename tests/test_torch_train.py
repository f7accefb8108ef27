"""``repro_torch.train.loop.train`` against the reference's ``train``.

Both packages train granite-34b's smoke config (3 layers, d 64, float32) on
the same token stream.  They start from one init: the reference's, written
as a step-0 checkpoint in the shared layout, from which each ``train``
auto-resumes (``jax.random`` and ``torch.Generator`` draw different bits);
the spectral-Adam trackers, which ``train`` builds after the restore, are
the reference's carried over by ``convert``.  Limits: the losses at 1e-5
relative, the final parameters and optimizer states at 1e-5 of each array's
largest entry (float32; XLA and PyTorch sum in other orders).

A checkpoint either package's ``train`` wrote resumes in the other and
continues with the uninterrupted run's losses; resuming a spectral-Adam run
raises the same ``ValueError`` in both (the reference restores AdamW's
layout first: ROADMAP queue C).
"""

import shutil

import numpy as np
import pytest
import torch

import jax

from _torch_helpers import ref
from repro_torch import configs as PCFG
from repro_torch import convert
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import OptimizerConfig, RunConfig
from repro_torch.train import checkpoint as PCK
from repro_torch.train import loop as PLOOP

RCFG = ref("configs")
RBASE = ref("configs.base")
RCK = ref("train.checkpoint")
RLOOP = ref("train.loop")
RREG = ref("models.registry")
ROPT = ref("optim.adamw")
RSA = ref("optim.spectral_adam")

ARCH = "granite-34b"
BATCH, SEQ, STEPS = 2, 16, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
REL = 1e-5


def _runs(directory, steps, spectral_rank=0):
    """The reference's and the port's RunConfig of one run."""
    common = dict(steps=steps, log_every=1, checkpoint_every=100, checkpoint_dir=str(directory),
                  seed=0)
    return (RBASE.RunConfig(model=RCFG.get_smoke(ARCH),
                            optimizer=RBASE.OptimizerConfig(spectral_rank=spectral_rank, **OPT),
                            **common),
            RunConfig(model=PCFG.get_smoke(ARCH),
                      optimizer=OptimizerConfig(spectral_rank=spectral_rank, **OPT), **common))


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    """The reference's init (params, AdamW state) as a step-0 checkpoint."""
    d = tmp_path_factory.mktemp("init")
    params = RREG.build_model(RCFG.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    RCK.save(d, 0, (params, ROPT.adamw_init(params)))
    return d


def _from_init(init_dir, tmp_path_factory, name):
    d = tmp_path_factory.mktemp(name)
    shutil.copytree(init_dir, d, dirs_exist_ok=True)
    return d


def _ported_spectral_init(monkeypatch):
    """Make the port's ``train`` build the reference's spectral state."""
    def init(gen, params, *, rank, device):
        r_params = jax.tree.map(lambda x: x.numpy(), params)
        st = RSA.spectral_adam_init(jax.random.PRNGKey(0 + 1), r_params, rank=rank)
        return convert.spectral_adam_state_from_reference(jax.tree.map(np.asarray, st),
                                                          device=device)

    monkeypatch.setattr(PLOOP, "spectral_adam_init", init)


def _final(directory):
    return PCK.restore(directory, None)


def _losses(res):
    return np.array([l for _, l in res.losses])


@pytest.fixture(scope="module")
def adamw_runs(init_dir, tmp_path_factory):
    """The 4-step AdamW run in each package, from the shared init."""
    rd, pd = (_from_init(init_dir, tmp_path_factory, n) for n in ("ref4", "port4"))
    r_run, _ = _runs(rd, STEPS)
    _, p_run = _runs(pd, STEPS)
    return (RLOOP.train(r_run, batch_size=BATCH, seq_len=SEQ), rd,
            PLOOP.train(p_run, batch_size=BATCH, seq_len=SEQ, device="cpu"), pd)


@pytest.fixture(scope="module")
def spectral_runs(init_dir, tmp_path_factory):
    rd, pd = (_from_init(init_dir, tmp_path_factory, n) for n in ("sref4", "sport4"))
    r_run, _ = _runs(rd, STEPS, spectral_rank=4)
    _, p_run = _runs(pd, STEPS, spectral_rank=4)
    r_res = RLOOP.train(r_run, batch_size=BATCH, seq_len=SEQ)
    with pytest.MonkeyPatch.context() as mp:
        _ported_spectral_init(mp)
        p_res = PLOOP.train(p_run, batch_size=BATCH, seq_len=SEQ, device="cpu")
    return r_res, rd, p_res, pd


def _assert_same_run(r_res, rd, p_res, pd):
    assert [s for s, _ in p_res.losses] == [s for s, _ in r_res.losses] == list(range(STEPS))
    np.testing.assert_allclose(_losses(p_res), _losses(r_res), rtol=REL, atol=0)
    np.testing.assert_allclose([g for _, g in p_res.grad_norms],
                               [g for _, g in r_res.grad_norms], rtol=REL, atol=0)
    assert p_res.final_step == r_res.final_step == STEPS
    (rs, r_leaves), (ps, p_leaves) = _final(rd), _final(pd)
    assert rs == ps == STEPS and len(r_leaves) == len(p_leaves)
    for a, b in zip(p_leaves, r_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a.astype(np.float64) - b).max()) <= REL * scale


def test_train_adamw_matches_reference(adamw_runs):
    _assert_same_run(*adamw_runs)
    assert adamw_runs[2].resumed_from == 0


def test_train_spectral_adam_matches_reference(spectral_runs):
    _assert_same_run(*spectral_runs)


def test_reference_checkpoint_resumes_in_the_port(init_dir, tmp_path_factory, adamw_runs):
    d = _from_init(init_dir, tmp_path_factory, "r2p")
    RLOOP.train(_runs(d, 2)[0], batch_size=BATCH, seq_len=SEQ)
    res = PLOOP.train(_runs(d, STEPS)[1], batch_size=BATCH, seq_len=SEQ, device="cpu")
    assert res.resumed_from == 2
    np.testing.assert_allclose(_losses(res), _losses(adamw_runs[0])[2:], rtol=REL, atol=0)


def test_port_checkpoint_resumes_in_the_reference(init_dir, tmp_path_factory, adamw_runs):
    d = _from_init(init_dir, tmp_path_factory, "p2r")
    _, p_run = _runs(d, 2)
    PLOOP.train(p_run, batch_size=BATCH, seq_len=SEQ, device="cpu")
    res = RLOOP.train(_runs(d, STEPS)[0], batch_size=BATCH, seq_len=SEQ)
    assert res.resumed_from == 2
    np.testing.assert_allclose(_losses(res), _losses(adamw_runs[2])[2:], rtol=REL, atol=0)


def test_port_resume_is_exact(init_dir, tmp_path_factory, adamw_runs):
    """Saved at step 2 and resumed: the same bits as the uninterrupted run."""
    d = _from_init(init_dir, tmp_path_factory, "p2p")
    PLOOP.train(_runs(d, 2)[1], batch_size=BATCH, seq_len=SEQ, device="cpu")
    res = PLOOP.train(_runs(d, STEPS)[1], batch_size=BATCH, seq_len=SEQ, device="cpu")
    np.testing.assert_array_equal(_losses(res), _losses(adamw_runs[2])[2:])
    for a, b in zip(_final(d)[1], _final(adamw_runs[3])[1]):
        np.testing.assert_array_equal(a, b)


def test_spectral_resume_raises_in_both(spectral_runs):
    """The reference restores into AdamW's layout before it builds the
    spectral state, so a spectral-Adam checkpoint does not fit: both raise
    the same error."""
    _, rd, _, pd = spectral_runs
    msgs = []
    for loop, run, kw in ((RLOOP, _runs(rd, STEPS + 2, 4)[0], {}),
                          (PLOOP, _runs(pd, STEPS + 2, 4)[1], {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"checkpoint has \d+ leaves; target structure has \d+") as e:
            loop.train(run, batch_size=BATCH, seq_len=SEQ, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_log_every_straggler_hook_and_refusals(tmp_path):
    events = []
    run = RunConfig(model=PCFG.get_smoke(ARCH), optimizer=OptimizerConfig(**OPT), steps=5,
                    log_every=2, checkpoint_every=0, checkpoint_dir=str(tmp_path / "c"))
    res = PLOOP.train(run, batch_size=1, seq_len=8, device="cpu", straggler_timeout_s=-1.0,
                      on_straggler=lambda step, dt: events.append(step))
    assert [s for s, _ in res.losses] == [0, 2, 4]
    assert events == [s for s, _ in res.straggler_events] == list(range(5))
    assert not (tmp_path / "c").exists()                     # checkpoint_every=0: no save
    first = res.losses[0][1]
    assert np.isfinite(first) and abs(first - np.log(run.model.vocab_size)) < 1.0
    with pytest.raises(TypeError, match="expected a repro_torch.dist.Mesh"):
        PLOOP.train(run, batch_size=1, seq_len=8, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PLOOP.train(run, batch_size=1, seq_len=8)


def _init_calls():
    from repro_torch.models import encdec as PED
    from repro_torch.models import registry as PREG
    from repro_torch.models import rwkv_model as PRM
    from repro_torch.models import transformer as PTR
    from repro_torch.optim import compression as PC
    from repro_torch.optim import spectral as PS
    from repro_torch.optim import spectral_adam as PSA

    cfg = PCFG.get_smoke(ARCH)
    params = {"w": torch.zeros((64, 48)), "b": torch.zeros((48,))}
    return {
        "ModelApi.init": lambda gen, **kw: PREG.build_model(cfg).init(gen, **kw),
        "decoder_init": lambda gen, **kw: PTR.decoder_init(gen, cfg, **kw),
        "rwkv_model_init": lambda gen, **kw: PRM.rwkv_model_init(
            gen, PCFG.get_smoke("rwkv6-1.6b"), **kw),
        "encdec_init": lambda gen, **kw: PED.encdec_init(gen, PCFG.get_smoke("whisper-base"), **kw),
        "spectral_init": lambda gen, **kw: PS.spectral_init(gen, 64, 48, 4, **kw),
        "spectral_adam_init": lambda gen, **kw: PSA.spectral_adam_init(gen, params, rank=4, **kw),
        "compression_init": lambda gen, **kw: PC.compression_init(gen, 64, 48, 4, **kw),
    }


@pytest.mark.parametrize("entry", sorted(_init_calls()))
def test_inits_build_on_the_card_unless_asked(entry):
    """Each init takes ``device=``, the card by default: a CPU generator
    without ``device="cpu"`` raises, naming it (no card here: the device
    check; with one: the generator's), and with it every tensor lies on the
    CPU."""
    call = _init_calls()[entry]
    with pytest.raises((RuntimeError, ValueError), match="device='cpu'"):
        call(torch.Generator().manual_seed(0))
    out = call(torch.Generator().manual_seed(0), device="cpu")
    tensors = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
    assert tensors and all(x.device.type == "cpu" for x in tensors)


def test_generator_on_another_device_is_refused():
    from repro_torch.api.state import generator_device

    class _CardGenerator:          # a generator's device, without a card
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="draws on cuda:0 but device='cpu'"):
        generator_device(_CardGenerator(), "cpu")
    assert generator_device(torch.Generator(), "cpu") == torch.device("cpu")

"""A run with its timed path broken underneath comes out as not correct: the
harness's look for a card skipped, the rest of a run driven at a test size
on the CPU, once for each fault a cell can have (a state returned
unchanged, half of the batch left out with the mean taken over the rest, an
answer or a token altered where it is produced; no cell spans chips, so no
exchange between them can be left out).  A sound run at the same size is
correct (``test_perfbench_reference``)."""

import pytest
import torch

import _cells
from _cells import GRANITE, SVD, small


def _refused(cell):
    out, line = _cells.run(cell)
    assert not line["correct"], line["checks"]
    return line


def test_training_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.train import loop

    real = loop.train_step

    def unchanged(api, opt, params, state, batch, step, **kw):
        _, _, loss, gnorm = real(api, opt, params, state, batch, step, **kw)
        return params, state, loss, gnorm

    monkeypatch.setattr(loop, "train_step", unchanged)
    line = _refused(small(GRANITE))
    assert line["checks"]["change"]["value"] == pytest.approx(1.0)


def test_training_loss_over_half_of_the_batch(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.decoder_train_loss

    def half(params, batch, cfg):
        s = batch["tokens"].shape[1] // 2
        return real(params, {k: v[:, :s] for k, v in batch.items()}, cfg)

    monkeypatch.setattr(transformer, "decoder_train_loss", half)
    line = _refused(small(GRANITE))
    assert line["checks"]["loss"]["value"] > line["checks"]["loss"]["limit"]


def _engine_fault(monkeypatch, keep):
    """The engine's depth-k update returns the input state for the members
    ``keep(batch)`` selects (their events dropped)."""
    from repro_torch.core import engine as E

    real = E.SvdEngine.update_truncated_rank_k_batch

    def faulty(self, tsvd, va, vb, **kw):
        out = real(self, tsvd, va, vb, **kw)
        sel = keep(tsvd.u.shape[0])
        return type(out)(*(torch.where(sel.view(-1, *[1] * (o.dim() - 1)), i, o)
                           for i, o in zip(tsvd, out)))

    monkeypatch.setattr(E.SvdEngine, "update_truncated_rank_k_batch", faulty)


def test_service_update_that_returns_the_state_unchanged(monkeypatch):
    _engine_fault(monkeypatch, lambda b: torch.ones(b, dtype=torch.bool))
    _refused(small(SVD))


def test_service_round_that_leaves_out_half_of_the_batch(monkeypatch):
    _engine_fault(monkeypatch, lambda b: torch.arange(b) >= b // 2)
    _refused(small(SVD))


def test_service_event_altered_where_it_is_queued(monkeypatch):
    from repro_torch.serve import svd_service as S

    real = S.SvdService.enqueue
    seen = {"n": 0}

    def altered(self, stream_id, a, b):
        seen["n"] += 1
        if seen["n"] == 5:
            a = a * 1.01
        return real(self, stream_id, a, b)

    monkeypatch.setattr(S.SvdService, "enqueue", altered)
    cell = small(SVD)
    cell.traffic["checked_streams"] = cell.config["streams"]
    _refused(cell)


def test_service_token_altered_where_it_is_made_visible(monkeypatch):
    from repro_torch.serve import svd_service as S

    real = S.SvdService.take_visible

    def altered(self):
        out = real(self)
        return [t + 1 if i == 0 else t for i, t in enumerate(out)]

    monkeypatch.setattr(S.SvdService, "take_visible", altered)
    line = _refused(small(SVD))
    assert line["checks"]["bad_tokens"]["value"] > 0 or line["checks"]["never_visible"]["value"] > 0

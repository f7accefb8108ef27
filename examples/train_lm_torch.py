"""End-to-end training driver of the PyTorch/CUDA port: a decoder LM on the
deterministic token stream.

The port's counterpart of ``examples/train_lm.py``, with its arguments and
configurations.  The default is a small model (repro-tiny) that trains in
seconds; ``--scale 100m`` selects the ~100M-parameter llama-style config (the
assignment driver) and ``--arch`` any assigned architecture's smoke config.

It shows the whole substrate: config -> model registry -> deterministic data
-> AdamW + schedule -> atomic checkpoints -> auto-resume (kill it midway and
rerun: it continues from the last complete checkpoint, bit-exact).  The
checkpoint directory defaults to the reference's name with ``_torch`` at the
end, so the two examples never resume from each other's runs.  No kernel of
A-F runs here: the models' products are ``torch.mm`` (as the reference leaves
them to XLA).

Run on the card:          python3 examples/train_lm_torch.py --steps 60
Run on the CPU (plain):   python3 examples/train_lm_torch.py --steps 60 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig, OptimizerConfig, RunConfig  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_train_lm_torch")


def model_for_scale(scale: str) -> ModelConfig:
    if scale == "100m":
        return ModelConfig(
            name="repro-100m", family="dense",
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
            d_ff=2048, vocab_size=32_000, vocab_pad_to=256,
            mlp_type="swiglu", norm_type="rmsnorm",
            compute_dtype="float32", remat=False,
        )
    return ModelConfig(
        name="repro-tiny", family="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        d_ff=704, vocab_size=2_048, vocab_pad_to=64,
        mlp_type="swiglu", norm_type="rmsnorm",
        compute_dtype="float32", remat=False,
    )


def run_config(args) -> RunConfig:
    """The run the reference's example builds from the same arguments."""
    cfg = configs.get_smoke(args.arch) if args.arch else model_for_scale(args.scale)
    return RunConfig(
        model=cfg,
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=max(args.steps, 100),
                                  spectral_rank=args.spectral_rank,
                                  basis_refresh_every=args.basis_refresh_every),
        steps=args.steps,
        log_every=10,
        checkpoint_every=25,
        checkpoint_dir=args.ckpt_dir,
        seed=0,
    )


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--scale", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--arch", default=None, help="assigned arch id (smoke config)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--spectral-rank", type=int, default=0,
                    help=">0: streaming-SVD low-rank moment projection")
    ap.add_argument("--basis-refresh-every", type=int, default=0,
                    help=">0: agree/re-factorize spectral bases every N steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the logged losses, the first and last, the final step
    and the step it resumed from."""
    args = parse(argv)
    run = run_config(args)
    print(f"model={run.model.name} device={torch.device(args.device)}")
    res = train(run, batch_size=args.batch, seq_len=args.seq, device=args.device)
    first, last = res.losses[0][1], res.losses[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} over {res.final_step} steps"
          + (f" (resumed from {res.resumed_from})" if res.resumed_from else ""))
    assert last < first, "loss did not decrease"
    print("OK")
    return {"model": run.model.name, "first_loss": first, "last_loss": last,
            "losses": list(res.losses), "final_step": res.final_step,
            "resumed_from": res.resumed_from}


if __name__ == "__main__":
    main()

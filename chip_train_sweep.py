#!/usr/bin/env python3
"""Four AdamW steps of granite-3-2b at full width and depth under several
learning-rate schedules, on one CUDA card.

    python3 chip_train_sweep.py

Each setting starts from the same seeded random weights (bf16, made on
the card) and takes ``chip_smoke.TRAIN_STEPS`` steps (``remat=True``) on
the same ``TokenPipeline`` batches of 8 × 1,024 as ``chip_smoke.py``'s
phase train.  One JSON line per setting: each step's loss, pre-clip
gradient norm and learning rate, then the loss of batches 0–4 at the
weights after the last update.  The settings are the reference's
``test_loss_decreases`` rate (3e-3), rates down to 1e-5 after a warmup of
2 steps, and the reference's ``AdamWConfig`` defaults (3e-4 after 100
warmup steps), which phase train runs.
"""
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SETTINGS = [*(dict(lr=lr, warmup_steps=2, total_steps=50)
              for lr in (3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5)),
            dict(lr=3e-4, warmup_steps=100, total_steps=10_000)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_train_sweep: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    card = smoke.nvidia_smi()
    _build.build()
    _build.load()
    dev = torch.device("cuda", 0)
    cfg = ARCHS[smoke.TRAIN_ARCH]
    batches = smoke.train_batches(cfg.vocab_size)
    for setting in SETTINGS:
        state = step_lib.init_train_state(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**setting))
        steps = []
        for batch in batches[:smoke.TRAIN_STEPS]:
            state, m = step(state, batch)
            steps.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
        with torch.no_grad():
            after = [float(T.loss_fn(cfg, state["params"], {
                k: torch.as_tensor(v, device=dev) for k, v in b.items()})[0])
                for b in batches[:smoke.TRAIN_STEPS + 1]]
        smoke.emit({"arch": smoke.TRAIN_ARCH, "optimizer": setting,
                    "steps": steps, "losses_after": after, "card": card})
        del state, step
        smoke.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())

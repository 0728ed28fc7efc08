"""Training (the reference's ``repro/train/``): AdamW with float32 master
weights and schedules, the train step, checkpoints, gradient
compression."""

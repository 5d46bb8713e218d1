from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint)

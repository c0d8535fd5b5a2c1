from repro_torch.ckpt.checkpoint import (
    CheckpointManager, latest_step, load_transport, restore_checkpoint,
    save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_transport",
           "restore_checkpoint", "save_checkpoint"]

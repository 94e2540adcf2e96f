from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint

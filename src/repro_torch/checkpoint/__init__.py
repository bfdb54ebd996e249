from repro_torch.checkpoint.io import latest_checkpoint, load_checkpoint, save_checkpoint

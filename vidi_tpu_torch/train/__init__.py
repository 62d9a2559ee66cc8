"""The finetune path of the port (vidi_tpu/train): loss, optimizer, the
training step, data, checkpoints and the `python -m
vidi_tpu_torch.train.train` CLI."""

"""Runnable examples: `python -m spleeterrt_tpu_torch.examples.train` and
`python -m spleeterrt_tpu_torch.examples.train_and_deploy`."""

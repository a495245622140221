from spleeterrt_tpu_torch.utils import timing  # noqa: F401

"""The benchmark of the PyTorch and CUDA port, `spleeterrt_tpu_torch`, on
NVIDIA H100s. `python3 -m portbench.run --help`; README.md says how it is
laid out and how a later change adds a configuration, a model family, a
driver, a traffic mix, a cell, a metric or a stage. Importing this package
loads nothing heavy: the load generator's child process imports it."""

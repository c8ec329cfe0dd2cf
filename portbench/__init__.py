"""The benchmark of the PyTorch and CUDA port (`nomad_tpu_torch`): its
server under a standing backlog, one cell a run. See README.md."""

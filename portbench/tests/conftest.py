"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the root of the repo, on the CPU; the card's with `-m cuda` on a machine
that has one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels)")

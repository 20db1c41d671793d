"""Two torch threads a test process: the tiny runs are many small ops,
and several workers with a thread a core each crowd out one another."""


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)

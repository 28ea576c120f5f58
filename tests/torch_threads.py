"""Torch's CPU threads in the port's tests (``tests/test_torch_*.py``).

Each of those files imports this module right after
``pytest.importorskip("torch")``. By default every process starts as many
intra-op threads as it sees cores; under pytest-xdist (``-n 6``) six
workers then run six such pools on the same cores, and a large-N port case
that takes seconds alone took minutes. So each worker takes its share of
the cores, one thread when there are as many workers as cores or more; a
serial run keeps them all. Nothing a test computes depends on the count:
the port's plain versions are integer tensor code.
"""
import os

import torch


def thread_share() -> int:
    """The cores this process may use over the xdist workers running."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


torch.set_num_threads(thread_share())

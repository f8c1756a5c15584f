"""Each torch test process uses its share of the cores.

The full test run uses pytest-xdist, one process a worker; torch defaults
to one intra-op thread per core in each of them, so six workers on eight
cores ask for 48 threads and spend most of their time waiting for one
another.  Every `tests/test_torch_*.py` imports this module
first: it sets torch's thread count to the cores over the worker count
(`PYTEST_XDIST_WORKER_COUNT`, 1 outside xdist), at least 1.
"""
import os

import torch


def share_of_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


torch.set_num_threads(share_of_cores())

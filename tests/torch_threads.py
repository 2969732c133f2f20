"""Each pytest-xdist worker's share of the cores for torch's CPU threads.

Under ``pytest -n N`` every worker process starts torch with as many
intra-op threads as the machine has cores, so N workers put N threads on
each core, and torch's OpenMP parallel regions wait for their preempted
threads at every barrier: a test that takes 3 s alone took 170 s beside
five busy workers. :func:`share_cores` gives each worker its share of
the cores (at least one thread) and exports it as ``OMP_NUM_THREADS`` /
``MKL_NUM_THREADS``, so the processes a test starts (gloo ranks, runners,
scaffolded projects) take the same count and compute the same bits as
the worker. Outside xdist it changes nothing.
"""

import os

import torch


def share_cores() -> int:
    """Size torch's intra-op pool to this worker's share of the cores;
    returns the thread count (torch's own outside xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 2:
        return torch.get_num_threads()
    threads = max(1, len(os.sched_getaffinity(0)) // workers)
    if torch.get_num_threads() != threads:
        torch.set_num_threads(threads)
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[name] = str(threads)
    return threads

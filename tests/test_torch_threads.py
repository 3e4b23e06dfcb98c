"""Torch's intra-op threads in the port's tests (ROADMAP "Test budget").

The tier-1 run gives the suite six pytest-xdist workers on eight cores,
and torch starts one intra-op thread a core in every worker: 48 OpenMP
threads on 8 cores, which spend most of their time waiting on one another.
Six of the heaviest port test files took 1,389 s of worker time under the
tier-1 flags (``-n 6 --dist loadfile``), and 281 s with one thread a
worker (``OMP_NUM_THREADS=1``, the same command).

Every port test module imports ``torch_threads_per_worker``, an autouse
fixture that shares the cores out among the workers (one thread a worker
under ``-n 6`` on eight cores) for the module's tests and gives torch its
count back after them; ``child_env`` gives the processes a test starts the
same share.  A run without xdist keeps torch's default.
"""
import os
import subprocess
import sys

import pytest
import torch


def threads_per_worker():
    """This machine's cores over the xdist workers, at least 1; None when
    the tests run without xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def child_env(env=None):
    """``env`` (default: this process's) with ``OMP_NUM_THREADS`` at a
    worker's share, for the processes a test starts."""
    env = dict(os.environ if env is None else env)
    n = threads_per_worker()
    if n is not None:
        env["OMP_NUM_THREADS"] = str(n)
    return env


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    n = threads_per_worker()
    if n is None:
        yield None
        return
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(old)


def test_workers_share_the_cores(torch_threads_per_worker):
    """Under xdist torch runs the worker's share of the cores, and so does
    a process started with ``child_env``; without xdist both keep their
    default."""
    n = torch_threads_per_worker
    code = "import torch; print(torch.get_num_threads())"
    out = subprocess.run([sys.executable, "-c", code], env=child_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if n is None:
        assert "OMP_NUM_THREADS" not in child_env({})
        return
    assert torch.get_num_threads() == n
    assert int(out.stdout.split()[-1]) == n

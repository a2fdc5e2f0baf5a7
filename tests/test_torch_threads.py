"""Pins torch's intra-op threads for the port's CPU tests.

Every ``tests/test_torch_*.py`` that runs torch imports this module first.
The suite runs under pytest-xdist with several workers on one host, and
each worker's torch would otherwise start a thread per core: six workers
on eight cores then run ~48 busy threads, and a test that takes 3 s alone
took 430-485 s.  One thread a worker keeps the workers from
oversubscribing the host: six concurrent runs of tests/test_torch_ppo.py
on an 8-core host were all cut at 900 s without it and took 66-68 s
with it.
"""
import torch

THREADS = 1
torch.set_num_threads(THREADS)


def test_torch_threads_are_pinned():
    assert torch.get_num_threads() == THREADS

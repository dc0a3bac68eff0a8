"""One intra-op thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module first.  The tests run
tiny shapes under pytest-xdist, several workers to the machine, and torch
otherwise starts one intra-op thread a core in each worker: the workers'
threads then outnumber the cores many times over and every step of every
engine waits on the others (the reliability files took 3-5 times as long
on 6 workers of 8 cores).  Rank processes the tests spawn set their own
(`tests/torch_hybrid_runner.py`).
"""
import torch

torch.set_num_threads(1)

"""One torch intra-op thread in every process of the port's CPU tests:
the test process (importing this module sets it) and the tool, CLI and
rank processes a test starts (`ONE_THREAD_ENV` in their environment).

The suite runs pytest-xdist's six workers on the machine's cores, and
torch's default of one intra-op thread a core in each worker, and in each
process a test starts, oversubscribes the cores many times over: on an
8-core machine, six concurrent runs of the engine's and the node
lookup's tree tests took 290.9 s of wall at the default and 128.6 s at one
thread (149.7 s at two)."""

import torch

#: the environment that gives a started process one torch thread
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}

torch.set_num_threads(1)

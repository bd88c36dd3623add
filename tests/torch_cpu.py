"""Torch's CPU settings for the port's tests; every ``test_torch_*.py``
imports this module before anything else.

The suite runs its files in parallel worker processes (``pytest -n 6
--dist loadfile``), and each worker would start torch's intra-op thread
pool as wide as the machine's cores, so six workers put six pools on the
same cores. The port's CPU tests run long loops of small ops, where the
pools contend for the cores and gain nothing, so each process keeps one
intra-op thread. Results do not depend on the thread count.
"""

import torch

torch.set_num_threads(1)

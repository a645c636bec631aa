"""Workloads built on the simulator: the benchmark circuits
(``circuits``), noise layers (``noise``), Hamiltonians
(``hamiltonians``), and the training models ``vqe`` and ``qaoa``."""

from . import qaoa, vqe  # noqa: F401

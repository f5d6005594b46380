"""The bench suite on the port: the JAX package's groups, row names and
checks, timed on the card (``python -m sparsematrix_tpu_torch.bench``)."""
from .harness import BenchFilter, BenchRegistry, Row, StepList

__all__ = ["BenchFilter", "BenchRegistry", "Row", "StepList"]

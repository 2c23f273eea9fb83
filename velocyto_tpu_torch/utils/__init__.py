"""Host utilities of the port (profiling, the R data reader)."""
from . import rds

__all__ = ["rds"]

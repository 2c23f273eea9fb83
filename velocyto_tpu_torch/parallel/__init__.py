from .mesh import (CELLS, GENES, make_mesh, single_device_mesh,
                   cells_sharding, replicated, pad_to_multiple,
                   initialize_distributed)
from .counts import merge_feeder_counts, merge_feeder_counts_np
from .feeders import count_distributed

__all__ = ["CELLS", "GENES", "make_mesh", "single_device_mesh",
           "cells_sharding", "replicated", "pad_to_multiple",
           "initialize_distributed", "merge_feeder_counts",
           "merge_feeder_counts_np", "count_distributed"]

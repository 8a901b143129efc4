"""Graph ingest: Matrix Market files, npz sidecar cache, RMAT and grids."""

from . import mmio
from . import cache
from . import rmat

"""Host utilities: CLI parsing, verification and profiling helpers
(counterpart of graphblast_tpu/utils)."""

from . import cli
from .verify import verify_list, verify_list_float

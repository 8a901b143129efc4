"""Per cent of the traced SSSP window in which the device ran nothing
(torch.profiler). Layer: device."""
from gbench.readers import idle_share


def read(run, st):
    return idle_share(run)

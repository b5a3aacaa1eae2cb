"""Percent of the traced window in which nothing ran on the card: 100 times
one less the union of its kernels, copies and fills (``torch.profiler``)."""


def read(run):
    if run.device is None:
        return None
    return 100.0 * (1.0 - run.device.busy_s() / run.window_s)

"""Kernel launches a million input bases: the port's ``*LAUNCHES`` counters
(``ops/*_cuda.py``, ``ops/winnow.py``) over the window, read before and after it."""


def read(run):
    launches = [v for k, v in run.counters.items() if "LAUNCHES" in k]
    if not launches or not run.bases:
        return None
    return sum(launches) / (run.bases / 1e6)

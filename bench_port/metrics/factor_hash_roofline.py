"""Percent of the factorization and hash kernels' roofline: the least time
the card could take to factorize and hash the window's shift windows (one
operation a letter on each strand, and MurmurHash3 of each window's factor
lengths as the reference's factorization counts them;
``harness/roofline.py``), over the device time of every kernel in the traced
window (``torch.profiler``)."""

from bench_port.harness import layers, roofline


def read(run):
    if run.config.get("reference") != "fingerprint" or run.device is None:
        return None
    kernel_s = run.device.kernel_s()
    stream, windows, chars = layers.shift_windows(run)
    if kernel_s <= 0 or not windows:
        return None
    factors = sum(w.factors for item in layers.item_indices(run)
                  for w in run.reference.entries(item))
    strands = 2 if run.traffic["expect"]["factorization"].endswith("_COMB") else 1
    work = roofline.window_work(stream, windows, chars, strands, factors)
    return 100.0 * roofline.bound_s(*work) / kernel_s

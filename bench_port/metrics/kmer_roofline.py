"""Percent of the k-mer hash kernels' roofline: the least time the card could
take to hash the window's k-mer positions (``harness/roofline.py``; work
counted from the inputs), over the device time of every kernel in the traced
window (``torch.profiler``)."""

from bench_port.harness import layers, roofline


def read(run):
    if run.config.get("reference") != "kmers" or run.device is None:
        return None
    kernel_s = run.device.kernel_s()
    k = run.config["kmer"]
    positions = layers.kmer_positions(run, k)
    if kernel_s <= 0 or not positions:
        return None
    return 100.0 * roofline.bound_s(*roofline.kmer_work(positions, k)) / kernel_s

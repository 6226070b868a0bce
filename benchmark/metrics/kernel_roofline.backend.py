"""kernel_roofline.backend: the share of its byte roofline that the
cell's kernel reached over the traced window, in %: the least time its
launches could take (their bytes, by the count that the configuration's
"kernel" names in benchmark/kernel_bytes/, over the card's 3.35 TB/s)
over their device time in the trace."""
from benchmark.roofline import HBM_BYTES_PER_S


def read(run):
    if run.trace is None or not run.trace["launches"]:
        return None
    return 100.0 * run.kernel_bytes / HBM_BYTES_PER_S / run.trace["kernel_s"]

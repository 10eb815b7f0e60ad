"""coarse_roofline: the prefilter's coarse pass (``coarse_counts_kernel``,
K7's launch a search) against its byte floor: the bytes each launch must
move at least (every subject's signature and the query's read once, one
int32 count a subject written) over the memory rate, summed over the
traced window's launches, as a share of the union of those launches'
intervals.  A launch of one query: n * 1,024 + 1,024 + 4 * n bytes."""

from swbench.peaks import HBM_BYTES_PER_S
from swbench.trace import kernel_label, merged

KERNEL = "coarse_counts_kernel"
SIGNATURE_BYTES = 1024  # a sequence's or a query's 3-mer signature: one byte a bucket
COUNT_BYTES = 4  # an int32 count a subject


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    lo, hi = trace.window()
    launches = [(a, b) for a, b, name, _ in trace.kernels if a >= lo and b <= hi and kernel_label(name) == KERNEL]
    busy_s = sum(b - a for a, b in merged(launches)) * 1e-6
    if busy_s <= 0:
        return None
    n = run["n_subjects"]
    floor_bytes = n * SIGNATURE_BYTES + SIGNATURE_BYTES + COUNT_BYTES * n
    return 100.0 * len(launches) * floor_bytes / HBM_BYTES_PER_S / busy_s

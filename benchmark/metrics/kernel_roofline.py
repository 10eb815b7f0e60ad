"""kernel_roofline: the least time the window's searches could take on the
card (swbench.peaks.least_seconds: their true cells' operations at the
packed integer peak, or their bytes at the memory rate, whichever is
larger), as a share of the time some kernel ran in the traced window (the
union of every kernel's interval, whatever its name)."""

from swbench.peaks import least_seconds


def read(run):
    trace = run["trace"]
    if trace is None or not run["search_lengths"]:
        return None
    lo, hi = trace.window()
    kernel_s = trace.busy(lo, hi, kernels_only=True) * 1e-6
    if kernel_s <= 0:
        return None
    least = sum(least_seconds(q, run["db_residues"], run["n_subjects"], run["gap_model"]) for q in run["search_lengths"])
    return 100.0 * least / kernel_s

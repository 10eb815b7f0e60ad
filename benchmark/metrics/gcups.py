"""gcups: true cells (query length x database residues) of every search the
window completed, over the window's wall seconds, from its start to the
last answer.  A batch counts whole, with all its queries."""


def read(run):
    if not run["search_lengths"] or run["window_s"] <= 0:
        return None
    return 1e-9 * sum(run["search_lengths"]) * run["db_residues"] / run["window_s"]

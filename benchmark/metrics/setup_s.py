"""setup_s: seconds from the start of the process to the window: imports,
the card's context, building or loading the kernels, making the database
and the queries, packing the database on the card, and the warm-up calls."""


def read(run):
    return run["setup_s"]

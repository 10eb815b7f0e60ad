"""reduce_ms: the mean, over the traced window's searches, of the time in
``swtpu.reduce`` spans: the host's scatter of a search's flat scores to
file order (and the rescore of saturated rows, where there are any)."""

from swbench import spans


def read(run):
    reduce = spans.window_spans(run["trace"], "reduce")
    if reduce is None:
        return None
    searches = spans.roots(spans.window_spans(run["trace"], "search"))
    return spans.per_root_ms(spans.held_us(reduce), searches)

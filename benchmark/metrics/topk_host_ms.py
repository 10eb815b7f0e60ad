"""topk_host_ms: the mean, over the traced window's searches, of the time
in ``swtpu.resolve``, ``swtpu.null`` and ``swtpu.evalues`` spans: the
host's candidate resolve, null statistics and E-value fit of a top-K
search."""

from swbench import spans


def read(run):
    host = spans.window_spans(run["trace"], "resolve", "null", "evalues")
    if host is None:
        return None
    searches = spans.roots(spans.window_spans(run["trace"], "search"))
    return spans.per_root_ms(spans.held_us(host), searches)

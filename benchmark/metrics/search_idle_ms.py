"""search_idle_ms: the mean, over the traced window's searches (top-level
``swtpu.search`` spans), of the time inside the union of the searches'
and the E-value fits' (``swtpu.evalues``) spans in which no device
operation ran: the engine's host path as the program itself marks it, the
in-program twin of ``engine_host_ms``."""

from swbench import spans


def read(run):
    held = spans.window_spans(run["trace"], "search", "evalues")
    if held is None:
        return None
    searches = spans.roots(spans.window_spans(run["trace"], "search"))
    return spans.per_root_ms(spans.idle_us(run["trace"], held), searches)

"""batch_idle_ms: the mean, over the traced window's ``search_many`` calls
(top-level ``swtpu.search_many`` spans), of the time inside them in which
no device operation ran: the batch's host path between and around its
pieces' launches."""

from swbench import spans


def read(run):
    batches = spans.window_spans(run["trace"], "search_many")
    if batches is None:
        return None
    batches = spans.roots(batches)
    return spans.per_root_ms(spans.idle_us(run["trace"], batches), batches)

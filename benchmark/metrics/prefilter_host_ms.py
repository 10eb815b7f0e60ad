"""prefilter_host_ms: the mean, over the traced window's searches, of the
time held by the ``swtpu.prefilter_merge``, ``swtpu.prefilter_pack``,
``swtpu.prefilter_null`` and ``swtpu.evalues`` spans: the host work of a
prefiltered search (the candidates' merge and union with the calibration
sample, the exact phase's profile and buckets, the sampled null, the
E-value fit).  A program that opens no ``swtpu.prefilter_merge`` span
reads nothing."""

from swbench import spans


def read(run):
    if not spans.window_spans(run["trace"], "prefilter_merge"):
        return None
    host = spans.window_spans(run["trace"], "prefilter_merge", "prefilter_pack", "prefilter_null", "evalues")
    searches = spans.roots(spans.window_spans(run["trace"], "search"))
    return spans.per_root_ms(spans.held_us(host), searches)

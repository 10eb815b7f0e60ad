"""One client in a closed loop: it sends the next request when the last one
has answered, and sends none once ``seconds`` have passed; the window ends
with the last answer."""

import contextlib
import time
import traceback

from swbench.drive import Record


def run(go, requests, seconds: float, span=None, done=None) -> dict:
    """``go(idx)`` answers a request; ``span(name)`` (a context manager, or
    None) marks the window and each request for a trace; ``done(record,
    answers)`` takes each request's answers as they arrive."""
    mark = span or (lambda name: contextlib.nullcontext())
    records = []
    with mark("bench.window"):
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            idx = next(requests)
            answers, error, device_s = None, None, 0.0
            with mark("bench.request"):
                try:
                    answers, device_s = go(idx)
                except Exception:  # a failed request counts, and the client goes on
                    error = traceback.format_exc(limit=8)
            rec = Record(t0, time.perf_counter(), idx, error, device_s)
            records.append(rec)
            if done is not None:
                done(len(records) - 1, rec, answers)
    end = records[-1].t1 if records else time.perf_counter()
    return dict(start=start, end=end, records=records)

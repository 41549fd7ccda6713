"""input_wait_ms (ms a batch): the time the window waited for the next
chunk from the read producers (harness/window.py run_window). A guard:
where it is large the cell measures the generator and not the port."""
SPANS = []


def read(t):
    return t.span_ms_per_batch("input_wait_ms")

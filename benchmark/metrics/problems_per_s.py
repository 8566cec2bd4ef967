"""Problems per second: every problem handed to the calls of the window
(lanes a call times calls, solved or not) over the window's whole time,
from the call before the first to the end of the last."""


def read(run):
    return run.lanes * len(run.calls_ms) / run.window_s

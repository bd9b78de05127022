"""Share of the traced window, in %, in which no operation ran on the card
(the union of the trace's device records against the window from the
first device record's start to the last one's end)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.window_s:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100

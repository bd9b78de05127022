"""Longest interval of the traced window, in ms, in which no operation ran
on the card."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.longest_gap_s * 1e3

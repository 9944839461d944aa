"""Share of the traced training steps in which no operation ran on the
card."""


def read(rec):
    if not rec["trace"]["device"]:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["traced_window_s"])

"""idle.gen_closed: the share (%) of the traced sub-window of the closed
generation loop in which no operation ran on the card."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

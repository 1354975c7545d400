"""gen_occupancy: the continuous engine's mean occupied slots over the
window's decode chunks, from its ``snapshot_stats()`` counters (chunks and
occupancy sum) read at the window's start and end."""


def read(rec):
    return rec.get("occupancy")

"""chunk_busy_ms: the device's busy time (ms) a decode chunk: the union of
every device activity in the traced device-only sub-window, over the
chunks that the engine dispatched in it (its ``snapshot_stats()``
counter); a chunk's share of the prefills between chunks included."""


def read(rec):
    tr, n = rec.get("trace"), rec.get("traced_chunks")
    if not tr or not n:
        return None
    return 1e3 * tr["busy_s"] / n

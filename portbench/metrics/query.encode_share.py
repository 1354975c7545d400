"""query.encode_share: the share (%) of the window's search calls spent in
``Retriever.embed_queries`` (tokenize and encode), by the benchmark's host
span around it."""


def read(rec):
    if "encode_s" not in rec or rec.get("elapsed_s", 0) <= 0:
        return None
    return 100.0 * rec["encode_s"] / rec["elapsed_s"]

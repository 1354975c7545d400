"""ingest.embed_share: the share (%) of the window's ``add_documents``
calls spent in ``IngestPipeline.embed_texts`` (tokenize and encode), by the
benchmark's host span around it; the rest is chunking, the docstore and
``VectorStore.add`` (``index_vectors``)."""


def read(rec):
    if "embed_s" not in rec or rec.get("elapsed_s", 0) <= 0:
        return None
    return 100.0 * rec["embed_s"] / rec["elapsed_s"]

from .chunking import chunk_text
from .docstore import DocStore
from .ingest import IngestPipeline
from .query import DualRetriever, Retriever, SearchResult, dual_agreement
from .server import MicroBatcher, ServingApp, make_server
from .store import VectorStore

__all__ = [
    "DocStore",
    "DualRetriever",
    "IngestPipeline",
    "MicroBatcher",
    "Retriever",
    "SearchResult",
    "ServingApp",
    "VectorStore",
    "chunk_text",
    "dual_agreement",
    "make_server",
]

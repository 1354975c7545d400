from .chunking import chunk_text
from .continuous import ContinuousEngine
from .docstore import DocStore
from .ingest import IngestPipeline
from .lexical import BM25Index, fuse_scores
from .ivf import IVF_KAPPA, IVFIndex, ivf_crossover_batch, load_index, select_serving_index
from .qa import QAAnswer, QAPipeline
from .query import DualRetriever, Retriever, SearchResult, dual_agreement
from .server import MicroBatcher, ServingApp, make_server
from .store import VectorStore

__all__ = [
    "BM25Index",
    "ContinuousEngine",
    "DocStore",
    "DualRetriever",
    "IVFIndex",
    "IVF_KAPPA",
    "IngestPipeline",
    "MicroBatcher",
    "QAAnswer",
    "QAPipeline",
    "Retriever",
    "SearchResult",
    "ServingApp",
    "VectorStore",
    "chunk_text",
    "dual_agreement",
    "fuse_scores",
    "ivf_crossover_batch",
    "load_index",
    "make_server",
    "select_serving_index",
]

"""PyTorch / CUDA port of the retrieval serving path, for one NVIDIA H100.

The JAX package ``vietnamese_qa_system_tpu`` stays the reference; this
package sits beside it and keeps its module paths, so each module here has
its counterpart there:

- ``core``    -- device resolution and seeded generators.
- ``data``    -- the tokenizers (a copy; token ids match the JAX package).
- ``ops``     -- the hand-written Hopper kernels (``csrc/``) behind
                 ``matmul_topk`` and ``flash_attention``, each with its
                 plain PyTorch version.
- ``models``  -- the sentence encoder and its configuration.
- ``engine``  -- vector store, doc store, chunking, ingest, query, HTTP
                 serving.
- ``cli``     -- ``ingest`` and ``serve``.

Nothing here imports jax or the JAX package: the modules the port needs
are carried into it, and the parity tests (``tests/test_torch_*.py``) hold
both packages to the same results.
"""

__version__ = "0.1.0"

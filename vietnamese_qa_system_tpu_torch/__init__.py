"""PyTorch / CUDA port of the QA system, for one NVIDIA H100.

The JAX package ``vietnamese_qa_system_tpu`` stays the reference; this
package sits beside it and keeps its module paths, so each module here has
its counterpart there:

- ``core``    -- device resolution and seeded generators.
- ``data``    -- the tokenizers, templates, schemas and training loader
                 (copies; token ids and batches match the JAX package).
- ``etl``     -- the offline ETL: dataset parsers, filters, tone
                 normalization, sources, model-backed translation.
- ``ops``     -- the hand-written Hopper kernels (``csrc/``) behind
                 ``matmul_topk``, ``flash_attention``, ``w8_matmul``,
                 ``ivf_probe_scores`` and ``quantize_int8``, each with its
                 plain PyTorch version; the chunked cross-entropy.
- ``models``  -- the sentence encoder, the causal LM, the encoder-decoders,
                 generation, LoRA, HF import and export.
- ``engine``  -- vector store, IVF index, doc store, chunking, ingest,
                 query, QA, HTTP serving.
- ``train``   -- the trainer, optimizers, checkpoints, evaluation, hub
                 pushes.
- ``utils``   -- JAX-order parameter trees, experiment trackers, logging,
                 base-call contracts.
- ``cli``     -- ``train``, ``parse``, ``ingest``, ``build-ivf``, ``serve``,
                 ``chat``, ``convert-ckpt``.

Nothing here imports jax or the JAX package: the modules the port needs
are carried into it, and the parity tests (``tests/test_torch_*.py``) hold
both packages to the same results.
"""

__version__ = "0.1.0"

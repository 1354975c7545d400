"""Fault-tolerant parallel translation for the offline ETL pipeline.

The port's copy of ``vietnamese_qa_system_tpu/etl/translate.py``:
``translate_texts`` splits the texts into chunks, runs them on a thread
pool, resubmits exactly the chunks that failed (at most ``max_retries``
times, then raises) and cuts over-long fields at ``MAX_FIELD_CHARS``.
The backend is any object with ``translate_batch``: ``NullTranslator``
(identity, the offline default), ``FlakyWrapper`` (fails each chunk a set
number of times, to exercise the resubmission) or ``Seq2SeqTranslator``,
which generates with one of the port's encoder-decoders on its device.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Protocol, Sequence

from ..utils.logging import get_logger

logger = get_logger("vqa_tpu.etl.translate")

MAX_FIELD_CHARS = 6000  # characters kept of one field


class Translator(Protocol):
    def translate_batch(self, texts: Sequence[str], src: str, dst: str) -> list[str]: ...


class NullTranslator:
    """Identity translator: keeps the pipeline runnable offline."""

    def translate_batch(self, texts, src, dst):
        return list(texts)


class Seq2SeqTranslator:
    """Translation by one of the port's encoder-decoders (T5 / mT5, mBART
    or the native stack, e.g. a checkpoint loaded by ``seq2seq_from_hf``),
    batched on its device through ``models.generate.generate_with_config``.

    Counterpart of the JAX class, which takes ``(params, cfg, tokenizer,
    ...)``; here the model carries its configuration.  ``prompt`` may
    name the language pair (``"{src}: {text}"``).  mBART checkpoints start
    the decoder at eos and force the target language id first: pass
    ``bos_id=eos`` and ``forced_bos_id=<lang id>``.  The pad, eos and
    forced ids are dropped from the decoded text.

    Calls from several threads launch on each thread's current stream,
    the device's default stream unless the caller set another: the
    kernels' per-device scratch (K6's tickets) is safe only while every
    call stays on one stream."""

    def __init__(self, model, tokenizer, *, max_len: int = 256, max_new_tokens: int = 256, num_beams: int = 1,
                 prompt: str = "{text}", bos_id: int = 0, forced_bos_id: int | None = None):
        self.model = model
        self.tok = tokenizer
        self.max_len = max_len
        self.max_new_tokens = max_new_tokens
        self.num_beams = num_beams
        self.prompt = prompt
        self.bos_id = bos_id
        self.forced_bos_id = forced_bos_id

    def translate_batch(self, texts, src, dst):
        from ..data.tokenizer import batch_encode
        from ..models.generate import GenerationConfig, generate_with_config

        rendered = [self.prompt.format(text=t, src=src, dst=dst) for t in texts]
        ids, mask = batch_encode(self.tok, rendered, self.max_len)
        out = generate_with_config(
            self.model, ids, mask,
            GenerationConfig(max_new_tokens=self.max_new_tokens, num_beams=self.num_beams,
                             forced_bos_token_id=self.forced_bos_id),
            eos_id=self.tok.eos_id, bos_id=self.bos_id,
        ).cpu().tolist()
        skip = {self.tok.pad_id, self.tok.eos_id}
        if self.forced_bos_id is not None:
            skip.add(self.forced_bos_id)  # the language tag is not text
        return [self.tok.decode([t for t in row if t not in skip]) for row in out]


class FlakyWrapper:
    """Test helper: fails the first `fail_times` calls per chunk key to
    exercise the resubmit path."""

    def __init__(self, inner: Translator, fail_times: int = 1):
        self.inner = inner
        self.fail_times = fail_times
        self._failures: dict[int, int] = {}
        self._lock = threading.Lock()

    def translate_batch(self, texts, src, dst):
        key = hash(tuple(texts)) % (2**31)
        with self._lock:
            n = self._failures.get(key, 0)
            if n < self.fail_times:
                self._failures[key] = n + 1
                raise ConnectionError(f"simulated transient failure #{n + 1}")
        return self.inner.translate_batch(texts, src, dst)


def translate_texts(texts: Sequence[str], translator: Translator, *, src: str = "en", dst: str = "vi",
                    chunk_size: int = 400, max_workers: int = 8, max_retries: int = 3) -> list[str]:
    """Translate preserving order, with per-chunk retry: the chunks that
    failed are resubmitted as they were; after ``max_retries`` rounds a
    chunk still failing raises."""
    texts = [t if len(t) <= MAX_FIELD_CHARS else t[:MAX_FIELD_CHARS] for t in texts]
    chunks = [(i, texts[i: i + chunk_size]) for i in range(0, len(texts), chunk_size)]
    results: dict[int, list[str]] = {}

    def work(offset: int, chunk: list[str]) -> tuple[int, list[str]]:
        return offset, translator.translate_batch(chunk, src, dst)

    pending = chunks
    for attempt in range(max_retries + 1):
        if not pending:
            break
        failed: list[tuple[int, list[str]]] = []
        with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = {pool.submit(work, off, ch): (off, ch) for off, ch in pending}
            for fut in cf.as_completed(futures):
                off, ch = futures[fut]
                try:
                    o, translated = fut.result()
                    if len(translated) != len(ch):
                        raise ValueError(f"translator returned {len(translated)} items for a {len(ch)}-item chunk")
                    results[o] = translated
                except Exception as e:  # noqa: BLE001 -- resubmit transient failures
                    logger.warning("chunk at offset %d failed (attempt %d): %s", off, attempt, e)
                    failed.append((off, ch))
        pending = failed
    if pending:
        raise RuntimeError(f"{len(pending)} translation chunks still failing after {max_retries} retries "
                           f"(offsets {[o for o, _ in pending]})")
    out: list[str] = []
    for off, _ in chunks:
        out.extend(results[off])
    return out

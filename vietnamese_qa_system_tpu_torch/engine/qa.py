"""End-to-end QA: retrieve -> RAG prompt -> reader generation.

Counterpart of ``vietnamese_qa_system_tpu/engine/qa.py``: batched
retrieval, prompt assembly with the template bank's ``[CTX i]`` format,
KV-cache batch generation (models/generate.py), plain or speculative, and
a score threshold below which a question gets a refusal.  The same seeded
``random.Random`` picks the templates in the same order as the JAX
pipeline, so both render the same prompts and refusals.

A causal reader continues a LEFT-padded prompt; a seq2seq reader (T5 /
mT5, mBART, the native encoder-decoder) encodes a RIGHT-padded one and
emits decoder tokens only, with speculation off (qa.py:54-78, :133-175).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence

import torch

from ..data.schemas import QUESTION_PREFIX, RESPONSE_PREFIX, QAExample
from ..data.templates import DEFAULT_BANK
from ..data.tokenizer import batch_encode
from ..models.generate import GenerationConfig, generate_with_config
from .query import Retriever


@dataclasses.dataclass
class QAAnswer:
    question: str
    answer: Optional[str]
    contexts: list[str]
    scores: list[float]
    refused: bool = False


class QAPipeline:
    """``reader`` is a :class:`~..models.causal_lm.CausalLM` or an
    encoder-decoder (models/families.py; its ``cfg`` and device come with
    it).  ``speculative`` ("none", "ngram" or "draft", with the draft model
    as ``draft``), ``draft_tokens`` and ``draft_ngram`` choose a causal
    reader's decode as ``GenerationConfig`` does: RAG answers quote the
    retrieved passages, so prompt-lookup drafts hit where the pipeline
    spends its decode time (engine/qa.py:54-78).  A seq2seq reader decodes
    without speculation."""

    def __init__(self, retriever: Retriever, reader, reader_tokenizer, *, k: int = 3, min_score: float = 0.2,
                 max_prompt_len: int = 512, max_new_tokens: int = 128, temperature: float = 0.0, seed: int = 0,
                 speculative: str = "none", draft_tokens: int = 8, draft_ngram: int = 3, draft=None):
        if reader.cfg.arch not in ("causal", "seq2seq"):
            raise ValueError(f"a reader is a causal or seq2seq LM, got arch={reader.cfg.arch!r}")
        self.speculative = speculative if reader.cfg.arch == "causal" else "none"
        self.draft_tokens = draft_tokens
        self.draft_ngram = draft_ngram
        self.draft = draft
        self.retriever = retriever
        self.reader = reader
        self.tok = reader_tokenizer
        self.k = k
        self.min_score = min_score
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.rng = random.Random(seed)

    def _build_prompt(self, question: str, contexts: Sequence[str]) -> str:
        context = QAExample.flatten_docs(list(contexts))
        body = DEFAULT_BANK.render_random("prompt", self.rng, question=question, context=context)
        return f"{QUESTION_PREFIX}\n{body}\n\n{RESPONSE_PREFIX}\n"

    def answer(self, questions: Sequence[str]) -> list[QAAnswer]:
        prompts, metas = self.retrieve(questions)
        return self.generate_answers(prompts, metas)

    def retrieve(self, questions: Sequence[str]):
        """Stage 1, the only part that touches (mutable) index state:
        search, refusal triage, prompt assembly."""
        hits = self.retriever.search(questions, k=self.k)
        prompts, metas = [], []
        for question, row in zip(questions, hits):
            kept = [r for r in row if r.score >= self.min_score and r.doc]
            if not kept:
                refusal = DEFAULT_BANK.render_random("no_answer", self.rng, question=question)
                metas.append(QAAnswer(question, refusal, [], [r.score for r in row], refused=True))
                prompts.append(None)
                continue
            metas.append(QAAnswer(question, None, [r.doc for r in kept], [r.score for r in kept]))
            prompts.append(self._build_prompt(question, [r.doc for r in kept]))
        return prompts, metas

    def generate_answers(self, prompts: Sequence[Optional[str]], metas: list[QAAnswer]) -> list[QAAnswer]:
        """Stage 2: reader generation over the assembled prompts."""
        live = [i for i, p in enumerate(prompts) if p is not None]
        if not live:
            return metas
        # pad the batch to the next power of two, as the JAX pipeline does:
        # it keeps the row count of every dense layer the JAX run has, and
        # with it the route (kernel K6 at <= 256 rows) and its rounding
        is_s2s = self.reader.cfg.arch == "seq2seq"
        n = len(live)
        bucket = 1 << (n - 1).bit_length()
        texts = [prompts[i] for i in live] + [" "] * (bucket - n)
        ids, mask = batch_encode(self.tok, texts, self.max_prompt_len, pad_side="right" if is_s2s else "left")
        dev = self.reader.device
        out = generate_with_config(
            self.reader, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
            GenerationConfig(max_new_tokens=self.max_new_tokens, temperature=self.temperature,
                             speculative=self.speculative, draft_tokens=self.draft_tokens,
                             draft_ngram=self.draft_ngram),
            eos_id=self.tok.eos_id, draft=self.draft,
        ).cpu().numpy()
        for row, i in enumerate(live):
            new_tokens = out[row] if is_s2s else out[row, ids.shape[1]:]
            completion = self.tok.decode([t for t in new_tokens if t not in (self.tok.pad_id, self.tok.eos_id)])
            metas[i].answer = completion.strip()
        return metas

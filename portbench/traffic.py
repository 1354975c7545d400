"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that it reads.

Sizes and gaps are drawn as a fixed multiset (the quantiles
``(i + 0.5) / n`` of the mix's distribution), so every seed asks for the
same work.  For texts the seed puts the sizes in another order and draws
the words.  For requests and arrivals the order is fixed too, since the
pace of a loop of requests depends on it (which requests finish, and so
prefill, while others decode); the seed draws their token ids.

Kinds:

- ``queries``: ``batches`` lists of ``batch`` query texts, byte lengths
  from ``len``;
- ``documents``: per call, documents whose paragraphs (``para_chars``)
  each make one chunk at the mix's ``chunk_size`` and ``overlap``, and
  ``chunks_per_call`` paragraphs a call, ``paras_per_doc`` a document;
- ``requests``: prompts of token ids (``prompt_len``) with their
  ``max_new`` (``new_len``), every ``greedy_every``-th greedy and the rest
  sampled at ``temperature`` / ``top_p``, and, for an open loop, the gaps
  between arrivals at ``rate`` requests a second.

A distribution is ``{"family": "lognormal", "median", "sigma", "min",
"max"}``, ``{"family": "uniform", "min", "max"}`` or ``{"family":
"exponential", "mean"}``.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

WORDS = ("học sinh trường đại học nghiên cứu khoa học Việt Nam thành phố Hà Nội Hồ Chí Minh kinh tế văn hóa "
         "lịch sử sông Hồng đồng bằng miền núi nông nghiệp công nghiệp giáo dục sức khỏe bệnh viện người dân "
         "chính phủ luật pháp môi trường khí hậu mùa mưa câu hỏi trả lời tại sao như thế nào ở đâu bao nhiêu "
         "năm tháng ngày của và là có không được những các một").split()


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``(i + 0.5) / n`` quantiles of ``dist``, clipped to its bounds."""
    q = (np.arange(n) + 0.5) / n
    fam = dist["family"]
    if fam == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif fam == "uniform":
        x = dist["min"] + (dist["max"] - dist["min"]) * q
    elif fam == "exponential":
        x = -dist["mean"] * np.log1p(-q)
    else:
        raise ValueError(f"unknown distribution family {fam!r}")
    return np.clip(x, dist.get("min", -math.inf), dist.get("max", math.inf))


def sizes(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The fixed multiset of ``n`` whole sizes of ``dist``, in the seed's order."""
    return rng.permutation(np.rint(quantiles(dist, n)).astype(np.int64))


def text_of_bytes(rng: np.random.Generator, n_bytes: int) -> str:
    """Words until ``n_bytes`` UTF-8 bytes, cut there (at a character)."""
    out, size = [], 0
    while size < n_bytes:
        w = WORDS[int(rng.integers(len(WORDS)))]
        out.append(w)
        size += len(w.encode()) + 1
    return " ".join(out).encode()[:n_bytes].decode("utf-8", errors="ignore").strip() or "a"


def text_of_chars(rng: np.random.Generator, n_chars: int) -> str:
    """Words up to ``n_chars`` characters, ending at a word."""
    out, size = [], 0
    while True:
        w = WORDS[int(rng.integers(len(WORDS)))]
        if size + len(w) + (1 if out else 0) > n_chars:
            break
        out.append(w)
        size += len(w) + (1 if len(out) > 1 else 0)
    return " ".join(out) + "."


def queries(mix: dict, seed: int) -> list[list[str]]:
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(mix["batches"]):
        lens = sizes(mix["len"], mix["batch"], rng)
        out.append([text_of_bytes(rng, int(n)) for n in lens])
    return out


def documents(mix: dict, seed: int, call: int) -> list[str]:
    """Call ``call``'s documents: ``chunks_per_call`` paragraphs split into
    documents of ``paras_per_doc`` (the last takes what is left)."""
    rng = np.random.default_rng([seed, 2, call])
    n = mix["chunks_per_call"]
    paras = [text_of_chars(rng, int(c)) for c in sizes(mix["para_chars"], n, rng)]
    per_doc = sizes(mix["paras_per_doc"], max(1, n // int(mix["paras_per_doc"]["min"])), rng)
    docs, at = [], 0
    for m in per_doc:
        if at >= n:
            break
        docs.append("\n\n".join(paras[at: at + int(m)]))
        at += int(m)
    if at < n:
        docs.append("\n\n".join(paras[at:]))
    return docs


FIXED = 0  # the order of request sizes and arrival gaps, the same for every seed


def requests(mix: dict, seed: int, vocab: int) -> list[dict]:
    """One cycle of ``cycle`` requests: prompt ids, ``max_new``, sampling."""
    order = np.random.default_rng([FIXED, 3])
    n = mix["cycle"]
    plen = sizes(mix["prompt_len"], n, order)
    new = sizes(mix["new_len"], n, order)
    rng = np.random.default_rng([seed, 3])
    # spread evenly, each the last of its group: the first request of an open loop, alone in the engine, would
    # otherwise run speculative chunks, whose accepted drafts depend on the seed's token ids
    greedy = np.arange(n) % mix["greedy_every"] == mix["greedy_every"] - 1
    lo = mix.get("min_token", 0)
    out = []
    for i in range(n):
        g = bool(greedy[i])
        out.append({"ids": rng.integers(lo, vocab, int(plen[i])).astype(np.int64).tolist(),
                    "max_new": int(new[i]), "greedy": g,
                    "temperature": 0.0 if g else mix["temperature"], "top_p": 1.0 if g else mix["top_p"]})
    return out


def gaps(mix: dict, seed: int, rate: float) -> np.ndarray:
    """One cycle of ``cycle`` gaps (s) between Poisson arrivals at ``rate``,
    in the fixed order (``seed`` is not used: every seed has the same arrivals)."""
    order = np.random.default_rng([FIXED, 4])
    return order.permutation(quantiles({"family": "exponential", "mean": 1.0 / rate}, mix["cycle"]))

"""The seeded traffic generator: the same seed gives the same traffic, and
every seed the same multiset of sizes."""

import numpy as np
import pytest

from portbench import spec, traffic
from portbench.reference import text as ref_text


def mix(name):
    return spec.merged(spec.load_json(spec.path_of("traffic", name)), dry=True)


def test_queries_repeat_for_a_seed():
    m = mix("queries_bulk")
    assert traffic.queries(m, 2 ** 31 + 7) == traffic.queries(m, 2 ** 31 + 7)
    assert traffic.queries(m, 1) != traffic.queries(m, 2)


def test_query_lengths_are_one_multiset():
    m = spec.load_json(spec.path_of("traffic", "queries_bulk"))
    rng = [np.random.default_rng(s) for s in (1, 2)]
    a, b = (sorted(traffic.sizes(m["len"], 4096, r)) for r in rng)
    assert a == b
    assert 16 <= a[0] and a[-1] <= 128
    assert 44 <= np.mean(a) <= 52


def test_query_texts_have_their_byte_lengths():
    rng = np.random.default_rng(3)
    for n in (16, 48, 128):
        t = traffic.text_of_bytes(rng, n)
        assert n - 3 <= len(t.encode()) <= n


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_documents_make_one_chunk_a_paragraph(seed):
    m = mix("docs_bulk")
    docs = traffic.documents(m, seed, 0)
    assert docs == traffic.documents(m, seed, 0)
    chunks = [c for d in docs for c in ref_text.chunks(d, 512, 0.1)]
    assert len(chunks) == m["chunks_per_call"]


def test_requests_and_gaps_repeat_and_keep_their_sizes():
    m = mix("chat_closed")
    a, b = traffic.requests(m, 5, 300), traffic.requests(m, 5, 300)
    assert a == b
    c = traffic.requests(m, 6, 300)
    # the same sizes in the same order for every seed; other token ids
    assert [r["max_new"] for r in a] == [r["max_new"] for r in c]
    assert [len(r["ids"]) for r in a] == [len(r["ids"]) for r in c]
    assert [r["greedy"] for r in a] == [r["greedy"] for r in c] and any(r["greedy"] for r in a)
    assert [r["ids"] for r in a] != [r["ids"] for r in c]
    assert all(4 <= t < 300 for r in a for t in r["ids"])
    g1, g2 = traffic.gaps(m, 5, 2.0), traffic.gaps(m, 9, 2.0)
    assert np.array_equal(g1, g2)
    assert abs(np.mean(g1) - 0.5) < 0.05

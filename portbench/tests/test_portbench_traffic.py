"""The generator: the same seed gives the same traffic, and every key is
sent."""

import numpy as np

from portbench import statsd_corpus
from portbench.tests.small import small_cell


def test_statsd_pool_repeats_per_seed():
    cell = small_cell()
    a = statsd_corpus.build(cell.config, cell.traffic, 2**31 + 5)
    b = statsd_corpus.build(cell.config, cell.traffic, 2**31 + 5)
    c = statsd_corpus.build(cell.config, cell.traffic, 2**31 + 6)
    assert a.batches == b.batches
    assert a.batches != c.batches
    assert np.array_equal(a.key, b.key)


def test_statsd_pool_covers_every_key_and_renders_its_lines():
    cell = small_cell()
    pool = statsd_corpus.build(cell.config, cell.traffic, 17)
    for code, family in enumerate(statsd_corpus.FAMILIES):
        keys = pool.key[pool.fam == code]
        assert np.unique(keys).size == cell.config["keys"][family]
    b = 3
    lines = b"\n".join(pool.batches[b]).split(b"\n")
    assert len(lines) == pool.lines_per_batch
    for i in (0, 77, len(lines) - 1):
        family = statsd_corpus.FAMILIES[pool.fam[b, i]]
        k, v = pool.key[b, i], pool.val[b, i]
        name, rest = lines[i].split(b":", 1)
        assert name.decode() == pool.names[family][k]
        assert rest.startswith(pool.texts[family][v] + b"|")
        assert rest.endswith(",".join(pool.tags[family][k]).encode())


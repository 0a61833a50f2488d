"""Consequence ranking: the PyTorch port against the JAX package.

The port's host ranker (``annotatedvdb_tpu_torch/conseq/ranker.py``) must
rank, match, learn and save exactly as the reference's; its rank table's
batched lookup (a ``torch.searchsorted`` over sign-flipped int64 keys,
here on the CPU) must return the reference's jitted ``_rank_lookup``
(a two-lane uint32 binary search, on CPU-JAX) and the numpy host lookup on
every mask, masks with the unknown-term bit 63 set included.  Every
comparison is exact.
"""

import os
import shutil

import numpy as np
import pytest

from annotatedvdb_tpu.conseq import ConsequenceRanker as RefRanker
from annotatedvdb_tpu.conseq import RankTable as RefTable
from annotatedvdb_tpu.conseq.table import _rank_lookup

from annotatedvdb_tpu_torch.conseq import ALL_TERMS, ConsequenceRanker, RankTable
from annotatedvdb_tpu_torch.conseq.ranker import DEFAULT_RANKING_FILE

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TEST_TABLE = os.path.join(DATA, "conseq_parser_test_data1.txt")

#: combos outside the shipped seed (each valid: every term is VEP vocabulary)
NOVEL = [
    ["missense_variant", "splice_region_variant"],
    ["stop_gained", "NMD_transcript_variant", "intron_variant"],
    ["upstream_gene_variant", "TF_binding_site_variant", "intron_variant"],
]


def _rankers(source):
    if source == "seed":
        return RefRanker(), ConsequenceRanker()
    return (RefRanker(TEST_TABLE, rank_on_load=True),
            ConsequenceRanker(TEST_TABLE, rank_on_load=True))


def test_shipped_seed_is_a_byte_copy():
    from annotatedvdb_tpu.conseq.ranker import DEFAULT_RANKING_FILE as ref_seed

    with open(ref_seed, "rb") as a, open(DEFAULT_RANKING_FILE, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("source", ["seed", "test_table"])
def test_rankings_and_matching_match(source):
    ref, port = _rankers(source)
    assert list(port.rankings.items()) == list(ref.rankings.items())
    assert port.version == ref.version
    for combo in ref.rankings:
        flipped = ",".join(reversed(combo.split(",")))
        assert port.rank_of(flipped) == ref.rank_of(flipped)
        assert (port.find_matching_consequence(flipped)
                == ref.find_matching_consequence(flipped))
    assert port.rank_of("missense_variant,not_a_term") is None
    assert ref.rank_of("missense_variant,not_a_term") is None


@pytest.mark.parametrize("source", ["seed", "test_table"])
def test_learn_on_miss_matches(source, tmp_path):
    """Each novel combo re-ranks the whole table: same version, same
    learned list, same renumbered ranks, same saved file bytes."""
    ref, port = _rankers(source)
    for terms in NOVEL:
        got = port.find_matching_consequence(list(terms))
        want = ref.find_matching_consequence(list(terms))
        assert got == want
        assert (port.version, port.added) == (ref.version, ref.added)
        assert list(port.rankings.items()) == list(ref.rankings.items())
    with pytest.raises(IndexError):
        port.find_matching_consequence(["not_a_term"])
    with pytest.raises(IndexError):
        ref.find_matching_consequence(["not_a_term"])
    p_ref = ref.save(str(tmp_path / "ref.txt"))
    p_port = port.save(str(tmp_path / "port.txt"))
    with open(p_ref, "rb") as a, open(p_port, "rb") as b:
        assert a.read() == b.read()


def test_save_on_add_writes_the_reference_file(tmp_path):
    """``save_on_add`` writes the versioned file beside the ranking file,
    one per learned combo, with the reference's names and bytes."""
    out, learned = {}, {}
    for tag, cls in (("ref", RefRanker), ("port", ConsequenceRanker)):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy(TEST_TABLE, d / "ranks.txt")
        r = cls(str(d / "ranks.txt"), save_on_add=True, rank_on_load=True)
        for terms in NOVEL:
            r.find_matching_consequence(list(terms))
        out[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        learned[tag] = list(r.added)
    assert out["port"] == out["ref"]
    assert learned["port"] == learned["ref"] and len(learned["port"]) >= 2
    assert len(out["port"]) == 1 + len(learned["port"])


def _masks(table, ref_table):
    """Every table combo's mask, 1,000 seeded random masks over the
    vocabulary bits, and masks with the unknown-term bit 63 set."""
    rng = np.random.default_rng(20261016)
    known = ref_table._masks
    n_vocab = len(ref_table.vocab)
    rand = np.zeros(1000, np.uint64)
    for i in range(1000):
        for b in rng.choice(n_vocab, int(rng.integers(1, 4)), replace=False):
            rand[i] |= np.uint64(1) << np.uint64(int(b))
    top = np.uint64(1) << np.uint64(63)
    unknown = np.concatenate([
        known[:50] | top, [top, top | np.uint64(1), ~np.uint64(0)],
        table.encode([["missense_variant", "made_up_term"], ["made_up_term"]]),
    ]).astype(np.uint64)
    masks = np.concatenate([known, rand, unknown]).astype(np.uint64)
    assert (masks >> np.uint64(63)).astype(bool).sum() >= 53
    return masks


def _assert_lookup_parity(ref, port):
    ref_table, table = RefTable(ref), RankTable(port)
    np.testing.assert_array_equal(table._masks, ref_table._masks)
    np.testing.assert_array_equal(table._ranks, ref_table._ranks)
    assert table.integral and ref_table.integral
    masks = _masks(table, ref_table)
    hi = (masks >> np.uint64(32)).astype(np.uint32)
    lo = (masks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got = table.lookup_device(hi, lo)
    assert got.device.type == "cpu"
    got = got.numpy()
    want = np.asarray(_rank_lookup(ref_table.d_hi, ref_table.d_lo,
                                   ref_table.d_ranks, hi, lo))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table.lookup_host(masks).astype(np.int32))
    np.testing.assert_array_equal(table.lookup_host(masks),
                                  ref_table.lookup_host(masks))
    np.testing.assert_array_equal(table.is_coding(masks),
                                  ref_table.is_coding(masks))
    n_known = len(ref_table._masks)
    assert (got[:n_known] >= 0).all() and (got[-53:] == -1).all()


def test_rank_table_lookup_matches_reference():
    _assert_lookup_parity(*_rankers("seed"))


def test_rank_table_lookup_after_a_learn_matches_reference():
    ref, port = _rankers("seed")
    for terms in NOVEL:
        ref.find_matching_consequence(list(terms))
        port.find_matching_consequence(list(terms))
    _assert_lookup_parity(ref, port)


def test_fractional_table_refuses_device_lookup():
    """A table loaded with its legacy fractional ranks (no re-rank) takes
    the host path; the device lane would truncate."""
    port = ConsequenceRanker(DEFAULT_RANKING_FILE, rank_on_load=False)
    table = RankTable(port)
    assert not table.integral
    with pytest.raises(ValueError, match="fractional"):
        table.lookup_device(np.zeros(1, np.uint32), np.zeros(1, np.uint32))
    ref_table = RefTable(RefRanker(DEFAULT_RANKING_FILE, rank_on_load=False))
    np.testing.assert_array_equal(table.lookup_host(ref_table._masks),
                                  ref_table.lookup_host(ref_table._masks))


def test_vocabulary_is_the_reference_vocabulary():
    from annotatedvdb_tpu.conseq import ALL_TERMS as REF_TERMS

    assert ALL_TERMS == REF_TERMS

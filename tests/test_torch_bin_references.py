"""``bin-references``: the PyTorch port against the JAX package.

The BinIndexRef TSV for the shipped GRCh38 and hg19 tables and for a
custom ``--chromosomeMap`` must be byte-identical to the reference CLI's,
with the same stderr line; the port's copies of the two length-map files
are pinned equal to the reference's, and the recursive ``BinTree`` to the
reference's.  Every comparison is exact.
"""

import os

import pytest

from annotatedvdb_tpu.cli.generate_bin_index_references import main as ref_main
from annotatedvdb_tpu.genome.assemblies import build_map_path as ref_build_map_path
from annotatedvdb_tpu.oracle.binindex import BinTree as RefTree

from annotatedvdb_tpu_torch.cli.generate_bin_index_references import read_chr_map
from annotatedvdb_tpu_torch.genome.assemblies import BUILD_FILES, build_map_path
from annotatedvdb_tpu_torch.oracle.binindex import BinTree

CUSTOM_MAP = "chr1\t1000000\nchr7\t64000001\n\nchrX\t15625\nchrM\t16569\n"


def _run(pkg, argv, out, capsys):
    from annotatedvdb_tpu_torch.__main__ import main as port_main

    capsys.readouterr()
    if pkg == "ref":
        assert ref_main([*argv, "-o", out]) == 0
    else:
        assert port_main(["bin-references", *argv, "-o", out]) == 0
    with open(out, "rb") as f:
        return f.read(), capsys.readouterr().err


@pytest.mark.parametrize("build", ["GRCh38", "hg19", "custom"])
def test_output_matches_reference(tmp_path, monkeypatch, capsys, build):
    monkeypatch.setenv("AVDB_JAX_PLATFORM", "cpu")  # the reference pins it
    if build == "custom":
        path = tmp_path / "map.txt"
        path.write_text(CUSTOM_MAP)
        argv = ["--chromosomeMap", str(path)]
    else:
        argv = ["--genomeBuild", build]
    ref_out, ref_err = _run("ref", argv, str(tmp_path / "ref.tsv"), capsys)
    port_out, port_err = _run("port", argv, str(tmp_path / "port.tsv"), capsys)
    assert port_out == ref_out
    assert port_err == ref_err and port_err.startswith("generated ")
    lines = port_out.decode().splitlines()
    assert lines[0].split("\t")[:3] == ["chr1", "0", "1"]
    if build == "GRCh38":
        assert len(lines) == 395_448
        assert port_err.strip() == "generated 395448 bins for 25 chromosomes"


def test_stdout_and_unknown_build(capsys, monkeypatch, tmp_path):
    """Without ``-o`` the rows go to stdout; an unknown build name is a
    usage error (exit 2), as in the reference."""
    from annotatedvdb_tpu_torch.cli.generate_bin_index_references import main

    path = tmp_path / "map.txt"
    path.write_text(CUSTOM_MAP)
    capsys.readouterr()
    assert main(["-m", str(path)]) == 0
    rows = capsys.readouterr().out
    assert main(["-m", str(path), "-o", str(tmp_path / "o.tsv")]) == 0
    assert rows == (tmp_path / "o.tsv").read_text()
    with pytest.raises(SystemExit) as exc:
        main(["--genomeBuild", "hg17"])
    assert exc.value.code == 2


@pytest.mark.parametrize("name", sorted(set(BUILD_FILES.values())))
def test_length_map_files_pinned_to_reference(name):
    build = next(b for b, f in BUILD_FILES.items() if f == name)
    with open(build_map_path(build), "rb") as a, open(ref_build_map_path(build), "rb") as b:
        assert a.read() == b.read()
    assert os.path.basename(build_map_path(build.upper())) == name


@pytest.mark.parametrize("chrom, length", [("chr21", 46_709_983), ("chrM", 16_569),
                                           ("chr9", 141_213_431), ("chrZ", 15_626)])
def test_bin_tree_matches_reference(chrom, length):
    tree, ref = BinTree(chrom, length), RefTree(chrom, length)
    assert tree.rows == ref.rows
    for start, end in ((1, 1), (15_625, 15_626), (length, length), (1, length)):
        assert tree.find_bin(start, end) == ref.find_bin(start, end)


def test_read_chr_map_skips_blank_lines(tmp_path):
    path = tmp_path / "map.txt"
    path.write_text(CUSTOM_MAP)
    assert read_chr_map(str(path)) == {"chr1": 1_000_000, "chr7": 64_000_001,
                                       "chrX": 15_625, "chrM": 16_569}

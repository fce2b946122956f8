"""The port's ``data/dssp.py`` against the JAX package's: all six functions
on the fake mkdssp text of ``tests/test_tools.py::test_dssp_parser``, with
a header, a chain break, a second chain and an unparsable line added, and
on a file."""

import io

import pytest

from pepflowww_tpu.data import dssp as jd

from pepflowww_torch.data import dssp as td

FAKE = (
    "==== Secondary Structure Definition by the program DSSP ====\n"
    "    1    1 A M  H   (before the table: skipped)\n"
    "  #  RESIDUE AA STRUCTURE\n"
    "    1    1 A M  H\n"
    "    2    2 A K  H\n"
    "    3    3 A L  H\n"
    "    4    4 A V  H\n"
    "    5    5 A A  H\n"
    "    6    6 A G     \n"
    "    7    7 A S     \n"
    "    8    8 A T     \n"
    "    9    9 A E  E\n"
    "   10   10 A F  E\n"
    "   11        !\n"
    "   12   20 B G  G\n"
    "   13   21AB S  S\n"
    "   14   22 B T  B\n"
    "   15   xx B T  T\n"
    "   16   23 B I  I\n"
    "   17   24 B D  -\n"
    "short\n"
)


def test_dssp_matches_jax(tmp_path):
    got, want = td.make_dssp_dict(io.StringIO(FAKE)), jd.make_dssp_dict(io.StringIO(FAKE))
    assert got == want and list(got) == ["A", "B"] and len(got["A"]) == 10
    assert got["B"][1] == (21, "A", "S", "S")
    path = tmp_path / "x.dssp"
    path.write_text(FAKE)
    assert td.parse_dssp_file(str(path)) == jd.parse_dssp_file(str(path)) == got
    for s in "HGIEBTS- xA":
        assert td.secondary_struct_symbol_to_index(s) == jd.secondary_struct_symbol_to_index(s)
    for chain in got.values():
        assert td.chain_ss_string(chain) == jd.chain_ss_string(chain)
        for n in (1, 2, 3, 5, 6):
            assert td.find_sstruct_ranges(chain, min_length=n) == \
                jd.find_sstruct_ranges(chain, min_length=n)
            for hi in (2, 3, float("inf")):
                assert td.find_loop_fragments(chain, min_length=n, max_length=hi) == \
                    jd.find_loop_fragments(chain, min_length=n, max_length=hi)
    assert td.find_sstruct_ranges(got["A"], min_length=3) == [(0, 5, 1)]
    assert td.find_loop_fragments(got["A"], min_length=3) == [(5, 8)]
    assert td.chain_ss_string(got["A"]) == "HHHHH---EE"
    with pytest.raises(FileNotFoundError):
        td.parse_dssp_file(str(tmp_path / "missing.dssp"))
